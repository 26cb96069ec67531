"""SO(3) manifold primitives on torch tensors, batched and dtype-following.

Port of better_fastlio2_tpu/utils/so3.py (the MTK manifold algebra of the
reference, IKFoM_toolkit/mtk).  Quaternions use the [w, x, y, z] layout.
Small-angle branches use Taylor expansions chosen with `torch.where`, as
in the reference, so every function is branch-free and works on any
leading batch shape.  Functions follow the dtype and device of their
inputs, so the tests run them in f64 on the CPU.
"""

from __future__ import annotations

import torch

__all__ = [
    "cross",
    "hat",
    "quat_multiply",
    "quat_conjugate",
    "quat_normalize",
    "quat_identity",
    "quat_rotate",
    "quat_inv_rotate",
    "quat_to_matrix",
    "matrix_to_quat",
    "quat_exp",
    "quat_log",
    "so3_exp_matrix",
    "A_matrix",
]

# Below this squared angle Taylor series replace the trig closed forms.
_SMALL_SQ = 1e-6


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, broadcasting the leading ones."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (MTK::hat); batched."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_multiply(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*p, both [w,x,y,z]."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _cos_sinc_sqrt(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos(sqrt(x2)), sinc(sqrt(x2))) with a Taylor small-angle branch
    (MTK::cos_sinc_sqrt)."""
    x = torch.sqrt(torch.clamp(x2, min=_SMALL_SQ))
    cos_big = torch.cos(x)
    sinc_big = torch.sin(x) / x
    cos_small = 1.0 - x2 / 2.0 + x2 * x2 / 24.0
    sinc_small = 1.0 - x2 / 6.0 + x2 * x2 / 120.0
    use_small = x2 < _SMALL_SQ
    return (torch.where(use_small, cos_small, cos_big),
            torch.where(use_small, sinc_small, sinc_big))


def quat_exp(v: torch.Tensor, scale=1.0) -> torch.Tensor:
    """Quaternion of the rotation vector `scale * v` (SO3::exp).  `scale`
    may be a tensor broadcasting against v[..., :1]."""
    half = 0.5 * scale
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    cos_half, sinc_half = _cos_sinc_sqrt(half * half * n2)
    return torch.cat([cos_half, sinc_half * half * v], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector of q (inverse of quat_exp): 2*atan(|v|/w)/|v| * v."""
    w = q[..., :1]
    v = q[..., 1:]
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=_SMALL_SQ * _SMALL_SQ))
    big = torch.atan2(torch.sign(w) * n, torch.sign(w) * w) / n
    small = 1.0 / w - n2 / (3.0 * w ** 3)
    s = torch.where(n2 < _SMALL_SQ * _SMALL_SQ, small, big)
    return 2.0 * s * v


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) @ v without forming R."""
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_inv_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q)^T @ v."""
    return quat_rotate(quat_conjugate(q), v)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a [w,x,y,z] quaternion; batched."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], -1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Quaternion [w,x,y,z] of a rotation matrix; branch-free (Shepperd),
    canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(a, b, c, d):
        return torch.stack([a, b, c, d], dim=-1)

    q0 = mk(1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    q1 = mk(m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    q2 = mk(m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21)
    q3 = mk(m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11)
    scores = torch.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    # first maximum, as jnp.argmax picks
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(
        cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4)).squeeze(-2)
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def _one_minus_cos_over(n2, cos):
    return torch.where(n2 < _SMALL_SQ, 0.5 - n2 / 24.0,
                       (1.0 - cos) / torch.clamp(n2, min=_SMALL_SQ))


def so3_exp_matrix(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: Exp(v) as a rotation matrix; batched."""
    n2 = torch.sum(v * v, dim=-1)[..., None, None]
    K = hat(v)
    KK = K @ K
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    cos, sinc = _cos_sinc_sqrt(n2)
    return eye + sinc * K + _one_minus_cos_over(n2, cos) * KK


def A_matrix(v: torch.Tensor) -> torch.Tensor:
    """MTK::A_matrix, the (transposed) right Jacobian:
    I + (1-cos|v|)/|v|^2 hat(v) + (1 - sin|v|/|v|)/|v|^2 hat(v)^2."""
    n2 = torch.sum(v * v, dim=-1)[..., None, None]
    K = hat(v)
    KK = K @ K
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    cos, sinc = _cos_sinc_sqrt(n2)
    c2 = torch.where(n2 < _SMALL_SQ, 1.0 / 6.0 - n2 / 120.0,
                     (1.0 - sinc) / torch.clamp(n2, min=_SMALL_SQ))
    return eye + _one_minus_cos_over(n2, cos) * K + c2 * KK
