"""Rotations and the gravity sphere, as matrices, for the reference.

Rotations are 3x3 matrices (the program keeps quaternions); the error
state's charts are those of FAST-LIO's manifold Kalman filter (MTK):
SO(3) with R + d = R Exp(d), and the sphere S2 of radius GRAVITY with the
x-axis chart, whose tangent basis B(g) is fixed by the formula below.
`quat_of` and `matrix_of` convert at the boundary with the program.
"""

from __future__ import annotations

import math

import torch

GRAVITY = 9.809  # |g| of the filter's S2 state (use-ikfom.hpp)
TINY = 1e-7  # MTK's tolerance for the small-angle and degenerate cases


def hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) cross-product matrix of (..., 3) vectors."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def _coeffs(v: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) of t = |v|, by
    their series where t is small."""
    t2 = torch.sum(v * v, dim=-1)[..., None, None]
    t = torch.sqrt(t2)
    small = t2 < 1e-10
    ts = torch.where(small, torch.ones_like(t), t)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(ts)) / ts ** 2)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (ts - torch.sin(ts)) / ts ** 3)
    return a, b, c


def exp(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues: the rotation matrix of the rotation vector v."""
    a, b, _ = _coeffs(v)
    K = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + a * K + b * (K @ K)


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of a rotation matrix (angles below pi)."""
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) * 0.5
    s = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    c = (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1, keepdim=True) - 1) * 0.5
    t = torch.atan2(s, c)
    return torch.where(s < 1e-12, w, w * t / torch.clamp(s, min=1e-300))


def jr_t(v: torch.Tensor) -> torch.Tensor:
    """MTK's A(v): I + (1 - cos t)/t^2 hat(v) + (t - sin t)/t^3 hat(v)^2,
    the transposed right Jacobian of SO(3)."""
    _, b, c = _coeffs(v)
    K = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + b * K + c * (K @ K)


# -- the gravity sphere -------------------------------------------------------

def s2_basis(g: torch.Tensor) -> torch.Tensor:
    """(3, 2) tangent basis B(g) of the x-axis chart at g (|g| = GRAVITY):
    the columns of the rotation taking e_x to g/|g| that carry e_y, e_z,
    written out; the fixed frame where g points along -e_x."""
    L = GRAVITY
    x, y, z = g[0], g[1], g[2]
    if float(x + L) <= TINY:
        B = torch.zeros(3, 2, dtype=g.dtype, device=g.device)
        B[1, 1], B[2, 0] = -1.0, 1.0
        return B
    den = x + L
    return torch.stack([
        torch.stack([-y, -z]),
        torch.stack([L - y * y / den, -z * y / den]),
        torch.stack([-z * y / den, L - z * z / den])]) / L


def s2_plus(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """g + u: g rotated by Exp(B(g) u)."""
    return exp(s2_basis(g) @ u) @ g


def s2_minus(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The chart coordinates u with h + u = g."""
    c = torch.linalg.cross(h, g)
    s, co = torch.linalg.vector_norm(c), torch.dot(g, h)
    t = torch.atan2(s, co)
    if float(s) < TINY:
        if abs(float(t)) > TINY:
            return torch.tensor([math.pi, 0.0], dtype=g.dtype, device=g.device)
        return s2_basis(h).T @ c / max(float(co), TINY)
    return (t / s) * (s2_basis(h).T @ c)


def s2_n(g: torch.Tensor) -> torch.Tensor:
    """(2, 3) N(g) = B(g)^T hat(g) / |g|^2: d(g + u)/dg's chart rows."""
    return s2_basis(g).T @ hat(g) / (GRAVITY * GRAVITY)


def s2_m(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(3, 2) M(g, u) = d(g + u)/du = -Exp(B u) hat(g) A(B u)^T B."""
    B = s2_basis(g)
    if float(torch.dot(u, u)) < TINY * TINY:
        return -hat(g) @ B
    w = B @ u
    return -exp(w) @ hat(g) @ jr_t(w).T @ B


# -- the program's quaternions (w, x, y, z) -----------------------------------

def matrix_of(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)])])


def quat_of(R: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w >= 0) of a rotation matrix: the rotation vector's
    half angle and axis."""
    v = log(R)
    t = torch.linalg.vector_norm(v)
    if float(t) < 1e-12:
        q = torch.cat([torch.ones(1, dtype=R.dtype, device=R.device), v / 2])
    else:
        q = torch.cat([torch.cos(t / 2)[None], torch.sin(t / 2) * v / t])
    return q / torch.linalg.vector_norm(q)


def project(R: torch.Tensor) -> torch.Tensor:
    """The rotation nearest a near-rotation matrix (a configuration's
    extrinsic, written to seven digits): the polar factor."""
    U, _, Vh = torch.linalg.svd(R)
    return U @ Vh
