"""ESIKF state manifold: the 23-DoF error state / 24-dim flat state.

Port of better_fastlio2_tpu/core/state.py (use-ikfom.hpp:21-30).  The state
is a NamedTuple of tensors (quaternions [w,x,y,z]); every field may carry
the same leading batch shape, which the IMU chain uses for its batched
Jacobians.  Error-state layout (23):

    [0:3] pos  [3:6] rot  [6:9] offset_R_L_I  [9:12] offset_T
    [12:15] vel  [15:18] bg  [18:21] ba  [21:23] grav (S2 chart)

The flat (oplus) layout is 24-dim with grav at [21:24].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import s2 as s2m
from ..utils import so3

__all__ = ["State", "identity_state", "boxplus", "boxminus", "oplus_flat",
           "init_P"]

POS, ROT, EXT_R, EXT_T, VEL, BG, BA, GRAV = 0, 3, 6, 9, 12, 15, 18, 21
ERR_DIM = 23
FLAT_DIM = 24
NOISE_DIM = 12  # [ng(3), na(3), nbg(3), nba(3)]


class State(NamedTuple):
    """ESIKF nominal state (all tensors share a dtype and device)."""

    pos: torch.Tensor  # (..., 3) world position of the IMU
    rot: torch.Tensor  # (..., 4) world_R_imu quaternion
    off_r: torch.Tensor  # (..., 4) imu_R_lidar extrinsic quaternion
    off_t: torch.Tensor  # (..., 3) imu_t_lidar extrinsic
    vel: torch.Tensor  # (..., 3) world velocity
    bg: torch.Tensor  # (..., 3) gyro bias
    ba: torch.Tensor  # (..., 3) accel bias
    grav: torch.Tensor  # (..., 3) gravity, |grav| = s2.GRAVITY

    @property
    def dtype(self):
        return self.pos.dtype

    @property
    def device(self):
        return self.pos.device


def identity_state(dtype=torch.float32, device=None) -> State:
    def z3():
        return torch.zeros(3, dtype=dtype, device=device)

    return State(
        pos=z3(),
        rot=so3.quat_identity(dtype, device),
        off_r=so3.quat_identity(dtype, device),
        off_t=z3(),
        vel=z3(),
        bg=z3(),
        ba=z3(),
        grav=s2m.s2_init(dtype, device),
    )


def boxplus(x: State, dx: torch.Tensor) -> State:
    """x ⊞ dx for a 23-dim error vector."""
    return State(
        pos=x.pos + dx[..., POS:POS + 3],
        rot=so3.quat_normalize(
            so3.quat_multiply(x.rot, so3.quat_exp(dx[..., ROT:ROT + 3]))),
        off_r=so3.quat_normalize(
            so3.quat_multiply(x.off_r, so3.quat_exp(dx[..., EXT_R:EXT_R + 3]))),
        off_t=x.off_t + dx[..., EXT_T:EXT_T + 3],
        vel=x.vel + dx[..., VEL:VEL + 3],
        bg=x.bg + dx[..., BG:BG + 3],
        ba=x.ba + dx[..., BA:BA + 3],
        grav=s2m.s2_boxplus(x.grav, dx[..., GRAV:GRAV + 2]),
    )


def boxminus(x: State, y: State) -> torch.Tensor:
    """23-dim error vector x ⊟ y."""
    return torch.cat(
        [
            x.pos - y.pos,
            so3.quat_log(so3.quat_multiply(so3.quat_conjugate(y.rot), x.rot)),
            so3.quat_log(
                so3.quat_multiply(so3.quat_conjugate(y.off_r), x.off_r)),
            x.off_t - y.off_t,
            x.vel - y.vel,
            x.bg - y.bg,
            x.ba - y.ba,
            s2m.s2_boxminus(x.grav, y.grav),
        ],
        dim=-1,
    )


def oplus_flat(x: State, f: torch.Tensor, dt) -> State:
    """Integrate the 24-dim flat derivative f for time dt (esekfom.hpp:
    280-289).  `dt` may be a tensor broadcasting against f[..., :1]."""
    return State(
        pos=x.pos + dt * f[..., 0:3],
        rot=so3.quat_normalize(
            so3.quat_multiply(x.rot, so3.quat_exp(f[..., 3:6], scale=dt))),
        off_r=so3.quat_normalize(
            so3.quat_multiply(x.off_r, so3.quat_exp(f[..., 6:9], scale=dt))),
        off_t=x.off_t + dt * f[..., 9:12],
        vel=x.vel + dt * f[..., 12:15],
        bg=x.bg + dt * f[..., 15:18],
        ba=x.ba + dt * f[..., 18:21],
        grav=so3.quat_rotate(so3.quat_exp(f[..., 21:24], scale=dt), x.grav),
    )


def init_P(dtype=torch.float32, device=None) -> torch.Tensor:
    """Initial covariance after IMU init (IMU_Processing.hpp:226-233)."""
    d = torch.ones(ERR_DIM, dtype=dtype, device=device)
    d[6:12] = 0.00001
    d[15:18] = 0.0001
    d[18:21] = 0.001
    d[21:23] = 0.00001
    return torch.diag(d)
