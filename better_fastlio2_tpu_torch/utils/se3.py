"""SE(3) pose utilities: [quat(w,x,y,z) | t] 7-vectors, batched.

Port of better_fastlio2_tpu/utils/se3.py.  Pose conventions match the
reference's gtsam::Pose3 / Eigen usage (src/laserMapping.cpp
getCurPose/trans2gtsamPose, common_lib.h): a pose T = (R, t) maps body to
world, composition is T_a * T_b = (R_a R_b, R_a t_b + t_a).  Every
function broadcasts over leading dims and follows its inputs' dtype and
device.
"""

from __future__ import annotations

import torch

from . import so3

__all__ = [
    "identity",
    "make",
    "rot",
    "trans",
    "compose",
    "inverse",
    "between",
    "apply",
    "from_rot_trans",
    "exp",
    "log",
]


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.cat([so3.quat_identity(dtype, device),
                      torch.zeros(3, dtype=dtype, device=device)])


def make(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def rot(p: torch.Tensor) -> torch.Tensor:
    return p[..., :4]


def trans(p: torch.Tensor) -> torch.Tensor:
    return p[..., 4:]


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    q = so3.quat_multiply(rot(a), rot(b))
    t = so3.quat_rotate(rot(a), trans(b)) + trans(a)
    return make(so3.quat_normalize(q), t)


def inverse(a: torch.Tensor) -> torch.Tensor:
    qc = so3.quat_conjugate(rot(a))
    return make(qc, -so3.quat_rotate(qc, trans(a)))


def between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 * b (gtsam Pose3::between)."""
    return compose(inverse(a), b)


def apply(p: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform points (..., 3) by pose (broadcasts over leading dims)."""
    return so3.quat_rotate(rot(p), pts) + trans(p)


def from_rot_trans(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return make(so3.matrix_to_quat(R), t)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Retract a 6-vector [rho(3 trans), theta(3 rot)] — the split
    SO3 x R^3 retraction (not the full SE3 exponential): R = Exp(theta),
    t = rho."""
    return make(so3.quat_exp(xi[..., 3:6]), xi[..., 0:3])


def log(p: torch.Tensor) -> torch.Tensor:
    """Inverse of exp: [t, Log(R)]."""
    return torch.cat([trans(p), so3.quat_log(rot(p))], dim=-1)
