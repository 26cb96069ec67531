"""S^2 manifold (gravity sphere) primitives on torch tensors.

Port of better_fastlio2_tpu/utils/s2.py (MTK::S2 with the x-axis chart,
S2_typ = 1, of the reference's use-ikfom.hpp:8).  The element is a
3-vector of norm GRAVITY; the tangent space is 2-dimensional.  Batched
over leading dims, dtype- and device-following.
"""

from __future__ import annotations

import math

import torch

from .so3 import A_matrix, cross, hat, quat_exp, quat_rotate, so3_exp_matrix

__all__ = ["GRAVITY", "s2_init", "s2_bx", "s2_boxplus", "s2_boxminus",
           "s2_nx_yy", "s2_mx"]

GRAVITY = 9.809  # den/num = 98090/10000 (use-ikfom.hpp:8)

_TOL = 1e-7


def s2_init(dtype=torch.float32, device=None,
            length: float = GRAVITY) -> torch.Tensor:
    """Default element of the x-axis chart: length * (1, 0, 0)."""
    return torch.tensor([length, 0.0, 0.0], dtype=dtype, device=device)


def s2_bx(vec: torch.Tensor, length: float = GRAVITY) -> torch.Tensor:
    """Chart basis Bx(vec): 3x2 matrix spanning the tangent plane, with the
    reference's fixed frame for the degenerate vec ~ -length*e_x."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    denom = torch.where(torch.abs(x + length) < _TOL,
                        torch.ones_like(x), x + length)
    r0 = torch.stack([-y, -z], dim=-1)
    r1 = torch.stack([length - y * y / denom, -z * y / denom], dim=-1)
    r2 = torch.stack([-z * y / denom, length - z * z / denom], dim=-1)
    regular = torch.stack([r0, r1, r2], dim=-2) / length
    # fill_ on views: assigning a Python number through an index copies a
    # host scalar to the device, a synchronising copy on CUDA
    degen = torch.zeros_like(regular)
    degen[..., 1, 1].fill_(-1.0)
    degen[..., 2, 0].fill_(1.0)
    use_degen = (x + length <= _TOL)[..., None, None]
    return torch.where(use_degen, degen, regular)


def s2_boxplus(vec: torch.Tensor, delta: torch.Tensor,
               length: float = GRAVITY) -> torch.Tensor:
    """vec ⊞ delta: rotate vec by Exp(Bx @ delta)."""
    Bu = (s2_bx(vec, length) @ delta[..., None])[..., 0]
    return quat_rotate(quat_exp(Bu), vec)


def s2_boxminus(vec: torch.Tensor, other: torch.Tensor,
                length: float = GRAVITY) -> torch.Tensor:
    """2-vector chart coordinates of `vec` around `other`."""
    v_sin = torch.linalg.vector_norm(cross(vec, other), dim=-1)
    v_cos = torch.sum(vec * other, dim=-1)
    theta = torch.atan2(v_sin, v_cos)
    bx_o = s2_bx(other, length)
    ho_v = cross(other, vec)
    coeff = torch.where(
        v_sin < _TOL,
        1.0 / torch.clamp(v_cos, min=_TOL),
        theta / torch.clamp(v_sin, min=_TOL),
    )
    res = coeff[..., None] * (bx_o.transpose(-1, -2) @ ho_v[..., None])[..., 0]
    # antipodal fallback: (pi, 0) when v_sin ~ 0 but theta is large
    anti = (v_sin < _TOL) & (torch.abs(theta) > _TOL)
    pi_vec = torch.zeros_like(res)
    pi_vec[..., 0].fill_(math.pi)
    return torch.where(anti[..., None], pi_vec, res)


def s2_nx_yy(vec: torch.Tensor, length: float = GRAVITY) -> torch.Tensor:
    """N(x,x): 2x3 tangent projection (1/len^2) Bx^T hat(vec)."""
    return (s2_bx(vec, length).transpose(-1, -2) @ hat(vec)) / (length * length)


def s2_mx(vec: torch.Tensor, delta: torch.Tensor,
          length: float = GRAVITY) -> torch.Tensor:
    """M(x, delta): 3x2 chart differential; -hat(vec) Bx for |delta| ~ 0,
    else -Exp(Bu) hat(vec) A(Bu)^T Bx with Bu = Bx delta."""
    bx = s2_bx(vec, length)
    Bu = (bx @ delta[..., None])[..., 0]
    small = torch.sum(delta * delta, dim=-1) < _TOL * _TOL
    R = so3_exp_matrix(Bu)
    hv = hat(vec)
    At = A_matrix(Bu).transpose(-1, -2)
    full = -(R @ hv @ At @ bx)
    simple = -(hv @ bx)
    return torch.where(small[..., None, None], simple, full)
