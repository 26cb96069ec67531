"""IMU processing: static init, forward propagation, point undistortion.

Port of better_fastlio2_tpu/core/imu.py (ImuProcess, IMU_Processing.hpp).
Times are float seconds relative to the scan begin; buffers are padded
with mask=False rows, which propagate with dt = 0 (exact no-ops).

Translation notes:
* the quaternion prefix product (jax.lax.associative_scan) is a log-step
  (Hillis-Steele) scan: ceil(log2(M-1)) batched products;
* the forward fill of recorded rates is torch.cummax;
* jax.vmap(predict_jacobians) is the batched predict_jacobians itself;
* the power-of-two tree reduce of the covariance composition stays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import s2 as s2m
from ..utils import so3
from .esikf import predict, predict_jacobians
from .state import ERR_DIM, State, init_P

__all__ = ["ImuBatch", "ImuPoses", "imu_init", "propagate", "undistort",
           "build_Q"]


class ImuBatch(NamedTuple):
    """One scan's IMU samples, padded to static M; sample 0 is the last
    sample of the previous scan (IMU_Processing.hpp:243-245)."""

    acc: torch.Tensor  # (M, 3) raw accelerometer
    gyr: torch.Tensor  # (M, 3) raw gyroscope
    t: torch.Tensor  # (M,) seconds relative to scan begin (inf = padding)
    mask: torch.Tensor  # (M,) valid rows, monotone True... False


class ImuPoses(NamedTuple):
    """Propagation states at IMU rate (the Pose6D analog)."""

    t: torch.Tensor  # (M,)
    pos: torch.Tensor  # (M, 3)
    vel: torch.Tensor  # (M, 3)
    rot: torch.Tensor  # (M, 4)
    acc_w: torch.Tensor  # (M, 3) world acceleration over the interval
    gyr_b: torch.Tensor  # (M, 3) bias-corrected body rate over it


def build_Q(gyr_cov, acc_cov, b_gyr_cov, b_acc_cov, dtype=torch.float32,
            device=None) -> torch.Tensor:
    """Process noise Q from the config covariances
    (IMU_Processing.hpp:305-308)."""
    d = torch.tensor([gyr_cov] * 3 + [acc_cov] * 3 + [b_gyr_cov] * 3
                     + [b_acc_cov] * 3, dtype=dtype, device=device)
    return torch.diag(d)


def imu_init(acc: torch.Tensor, gyr: torch.Tensor, mask: torch.Tensor,
             off_r: torch.Tensor, off_t: torch.Tensor,
             dtype=torch.float32) -> tuple[State, torch.Tensor, torch.Tensor]:
    """Static initialisation from stationary samples (IMU_init,
    IMU_Processing.hpp:174-233): gravity = -mean_acc/|mean_acc| * G, gyro
    bias = mean_gyr.  Returns (state, P, |mean_acc|)."""
    dev = acc.device
    w = mask.to(dtype)[:, None]
    n = torch.clamp(torch.sum(w), min=1.0)
    mean_acc = torch.sum(acc * w, dim=0) / n
    mean_gyr = torch.sum(gyr * w, dim=0) / n
    acc_norm = torch.linalg.vector_norm(mean_acc)
    grav = -mean_acc / torch.clamp(acc_norm, min=1e-6) * s2m.GRAVITY
    z3 = torch.zeros(3, dtype=dtype, device=dev)
    st = State(pos=z3, rot=so3.quat_identity(dtype, dev),
               off_r=off_r.to(dtype), off_t=off_t.to(dtype), vel=z3.clone(),
               bg=mean_gyr.to(dtype), ba=z3.clone(), grav=grav.to(dtype))
    return st, init_P(dtype, dev), acc_norm


def _prefix_quat_product(dq: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product q_0 * q_1 * ... * q_i along axis 0
    (log-step scan; earlier factors stay on the left)."""
    out = dq
    step = 1
    while step < out.shape[0]:
        out = torch.cat([out[:step],
                         so3.quat_multiply(out[:-step], out[step:])])
        step *= 2
    return out


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx] for a 0-d index tensor, negative indices wrapping as in jnp,
    without a host read."""
    idx = torch.where(idx < 0, idx + a.shape[0], idx)
    return torch.index_select(a, 0, idx.reshape(1))[0]


def propagate(x: State, P: torch.Tensor, batch: ImuBatch, Q: torch.Tensor,
              acc_norm, last_scan_end_t, scan_end_t, last_acc_w: torch.Tensor,
              last_gyr_b: torch.Tensor) -> tuple[State, torch.Tensor,
                                                 ImuPoses]:
    """Forward propagation over one scan's IMU samples (UndistortPcl's
    forward pass, IMU_Processing.hpp:239-333): midpoint rates, accel
    scaled by G/|mean_acc|, first interval starting at last_scan_end_t,
    final hop to scan_end_t.  The mean chain is parallel (prefix product +
    cumsums: the biases, extrinsics and gravity are constants within a
    scan) and the covariance composes by a tree reduce of (F, G) pairs.
    Returns (state_at_scan_end, P, poses)."""
    M = batch.t.shape[0]
    dtype = batch.acc.dtype
    if not isinstance(acc_norm, torch.Tensor):
        acc_norm = torch.as_tensor(acc_norm, dtype=dtype,
                                   device=batch.acc.device)
    g_scale = s2m.GRAVITY / torch.clamp(acc_norm, min=1e-6)
    # an f32 batch (the quantized window's IMU rows) against an f64
    # acc_norm: JAX promotes the scaled rates to f64, torch would keep the
    # dimensioned operand's f32, so promote explicitly
    a_dt = torch.promote_types(dtype, g_scale.dtype)

    ok = batch.mask[1:] & batch.mask[:-1]
    acc_all = (0.5 * (batch.acc[:-1] + batch.acc[1:])).to(a_dt) * g_scale
    gyr_all = 0.5 * (batch.gyr[:-1] + batch.gyr[1:])
    t0 = torch.clamp(batch.t[:-1], min=last_scan_end_t)
    zero = batch.t.new_zeros(())
    tt_safe = torch.where(ok, batch.t[1:], zero)  # padding rows carry inf
    t0_safe = torch.where(ok, t0, zero)
    dt_all = torch.where(ok & (tt_safe > t0_safe), tt_safe - t0_safe, zero)

    omega = gyr_all - x.bg
    dq = so3.quat_exp(omega, scale=dt_all[:, None])
    qpre = _prefix_quat_product(dq)
    rot_post = so3.quat_normalize(so3.quat_multiply(x.rot[None], qpre))
    rot_pre = torch.cat([x.rot[None], rot_post[:-1]])

    a_body = acc_all - x.ba
    a_w_pre = so3.quat_rotate(rot_pre, a_body) + x.grav
    vel_post = x.vel + torch.cumsum(a_w_pre * dt_all[:, None], dim=0)
    vel_pre = torch.cat([x.vel[None], vel_post[:-1]])
    pos_post = x.pos + torch.cumsum(vel_pre * dt_all[:, None], dim=0)
    pos_pre = torch.cat([x.pos[None], pos_post[:-1]])

    # recorded rates freeze to the PRECEDING valid sample (forward fill);
    # rows before the first valid one take the previous scan's rates
    gyr_b_all = gyr_all - x.bg
    acc_w_all = so3.quat_rotate(rot_post, a_body) + x.grav
    idx_m = torch.arange(M - 1, device=ok.device)
    ffill = torch.cummax(torch.where(ok, idx_m, -1), dim=0).values
    has_prev = (ffill >= 0)[:, None]
    src = torch.clamp(ffill, min=0)
    acc_w_rec = torch.where(has_prev, acc_w_all[src], last_acc_w)
    gyr_b_rec = torch.where(has_prev, gyr_b_all[src], last_gyr_b)

    x_end = x._replace(pos=pos_post[-1], rot=rot_post[-1], vel=vel_post[-1])

    def bcast(v):
        return v[None].expand(M - 1, *v.shape)

    x_pre = State(pos=pos_pre, rot=rot_pre, off_r=bcast(x.off_r),
                  off_t=bcast(x.off_t), vel=vel_pre, bg=bcast(x.bg),
                  ba=bcast(x.ba), grav=bcast(x.grav))
    x_post = State(pos=pos_post, rot=rot_post, off_r=bcast(x.off_r),
                   off_t=bcast(x.off_t), vel=vel_post, bg=bcast(x.bg),
                   ba=bcast(x.ba), grav=bcast(x.grav))

    # P_{i+1} = F_i P_i F_i^T + G_i composes associatively as
    # (F2, G2) ∘ (F1, G1) = (F2 F1, F2 G1 F2^T + G2): only the total is
    # needed, so a binary-tree reduce, identity-padded to a power of two
    Fr, Fw_all = predict_jacobians(x_pre, x_post, acc_all, gyr_all, dt_all)
    Gr = Fw_all @ Q @ Fw_all.transpose(-1, -2)
    n_lvl = Fr.shape[0]
    pow2 = 1 << (n_lvl - 1).bit_length()
    if pow2 != n_lvl:
        eye_pad = torch.eye(ERR_DIM, dtype=dtype, device=Fr.device).expand(
            pow2 - n_lvl, ERR_DIM, ERR_DIM)
        Fr = torch.cat([Fr, eye_pad])
        Gr = torch.cat([Gr, torch.zeros_like(eye_pad)])
    while Fr.shape[0] > 1:
        Fa, Ga, Fb, Gb = Fr[0::2], Gr[0::2], Fr[1::2], Gr[1::2]
        Fr, Gr = Fb @ Fa, Fb @ Ga @ Fb.transpose(-1, -2) + Gb
    F_tot, G_tot = Fr[0], Gr[0]
    P_end = F_tot @ P @ F_tot.T + G_tot

    # pose 0 = incoming state at scan start
    valid_pose = torch.cat([ok.new_ones(1), ok])
    t_arr = torch.cat([batch.t.new_zeros(1), batch.t[1:]])
    last_t = torch.max(torch.where(valid_pose, t_arr, -torch.inf))
    t_arr = torch.where(valid_pose, t_arr, torch.inf)
    poses = ImuPoses(
        t=t_arr,
        pos=torch.cat([x.pos[None], pos_post]),
        vel=torch.cat([x.vel[None], vel_post]),
        rot=torch.cat([x.rot[None], rot_post]),
        acc_w=torch.cat([last_acc_w[None], acc_w_rec]),
        gyr_b=torch.cat([last_gyr_b[None], gyr_b_rec]),
    )

    # final hop to the scan end with the last sample's rates
    last_idx = torch.sum(batch.mask.to(torch.int64)) - 1
    prev_idx = torch.clamp(last_idx - 1, min=0)
    acc_last = (0.5 * (_take(batch.acc, prev_idx)
                       + _take(batch.acc, last_idx))).to(a_dt)
    gyr_last = 0.5 * (_take(batch.gyr, prev_idx) + _take(batch.gyr, last_idx))
    dt_tail = torch.clamp(scan_end_t - last_t, min=0.0)
    x_fin, P_fin = predict(x_end, P_end, acc_last * g_scale, gyr_last,
                           dt_tail, Q)
    return x_fin, P_fin, poses


def undistort(x_end: State, poses: ImuPoses, pts: torch.Tensor,
              pt_t: torch.Tensor) -> torch.Tensor:
    """Motion-compensate points to the scan-end lidar frame
    (IMU_Processing.hpp:334-386):

        p_e = R_il^T ( R_we^T ( R_i (R_il p + t_il) + T_ei ) - t_il )

    each point taking its bracketing pose by searchsorted(side="right")."""
    # compare in the wider of the two types, as jnp.searchsorted promotes
    # (the quantized window's f32 IMU times against f64 point times)
    c_dt = torch.promote_types(poses.t.dtype, pt_t.dtype)
    idx = torch.clamp(
        torch.searchsorted(poses.t.to(c_dt), pt_t.to(c_dt), right=True) - 1,
        0, poses.t.shape[0] - 2)
    dt = torch.clamp(pt_t - poses.t[idx], min=0.0)[:, None]
    rot_h = poses.rot[idx]
    pos_h = poses.pos[idx]
    vel_h = poses.vel[idx]
    acc_t = poses.acc_w[idx + 1]
    gyr_t = poses.gyr_b[idx + 1]

    q_i = so3.quat_multiply(rot_h, so3.quat_exp(gyr_t * dt))
    p_imu = so3.quat_rotate(x_end.off_r, pts) + x_end.off_t
    p_w_i = (so3.quat_rotate(q_i, p_imu) + pos_h + vel_h * dt
             + 0.5 * acc_t * dt * dt)
    p_imu_e = so3.quat_inv_rotate(x_end.rot, p_w_i - x_end.pos)
    return so3.quat_inv_rotate(x_end.off_r, p_imu_e - x_end.off_t)
