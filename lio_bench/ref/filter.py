"""The reference's error-state Kalman filter, written from FAST-LIO's
equations (IMU_Processing.hpp, esekfom.hpp, use-ikfom.hpp) one IMU
interval and one matrix at a time.

State (23 error dimensions, in this order): position, attitude (SO(3)),
extrinsic attitude and translation, velocity, gyro and accelerometer
biases, gravity (2, on S2).  Attitudes are matrices.  Each interval of
the forward propagation builds its 23x23 transition F and its noise map
G in closed form; the update is the iterated Kalman filter with the gain
of the information form, (P^-1 + H^T H / r)^-1 H^T / r, from a direct
23x23 inverse.  `rnd` (see lio.py) rounds the stored intermediate
results: the identity in float64, TF32's mantissa in the control.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from . import geom

POS, ROT, EXR, EXT, VEL, BG, BA, GRAV = 0, 3, 6, 9, 12, 15, 18, 21
DIM = 23
R_POINT = 0.001  # LASER_POINT_COV: the variance of one point residual
CONVERGED = 0.001  # every |dx| under this is a converged pass (epsi)


@dataclass
class State:
    pos: torch.Tensor
    R: torch.Tensor  # world from IMU
    R_il: torch.Tensor  # IMU from lidar
    t_il: torch.Tensor
    vel: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    grav: torch.Tensor


def plus(x: State, d: torch.Tensor) -> State:
    return State(pos=x.pos + d[POS:POS + 3], R=x.R @ geom.exp(d[ROT:ROT + 3]),
                 R_il=x.R_il @ geom.exp(d[EXR:EXR + 3]),
                 t_il=x.t_il + d[EXT:EXT + 3], vel=x.vel + d[VEL:VEL + 3],
                 bg=x.bg + d[BG:BG + 3], ba=x.ba + d[BA:BA + 3],
                 grav=geom.s2_plus(x.grav, d[GRAV:GRAV + 2]))


def minus(x: State, y: State) -> torch.Tensor:
    return torch.cat([x.pos - y.pos, geom.log(y.R.T @ x.R),
                      geom.log(y.R_il.T @ x.R_il), x.t_il - y.t_il,
                      x.vel - y.vel, x.bg - y.bg, x.ba - y.ba,
                      geom.s2_minus(x.grav, y.grav)])


def initial_P(dtype, device) -> torch.Tensor:
    """The covariance after the IMU initialisation (IMU_Processing.hpp)."""
    d = torch.ones(DIM, dtype=dtype, device=device)
    d[EXR:EXT + 3] = 1e-5
    d[BG:BG + 3] = 1e-4
    d[BA:BA + 3] = 1e-3
    d[GRAV:GRAV + 2] = 1e-5
    return torch.diag(d)


def noise(cfg, dtype, device) -> torch.Tensor:
    """Process noise of [gyro, accel, gyro bias, accel bias]."""
    mp = cfg["mapping"]
    return torch.diag(torch.tensor(
        [mp["gyr_cov"]] * 3 + [mp["acc_cov"]] * 3 + [mp["b_gyr_cov"]] * 3
        + [mp["b_acc_cov"]] * 3, dtype=dtype, device=device))


# -- propagation ---------------------------------------------------------------

def predict(x: State, P, Q, acc, gyr, dt: float, rnd):
    """One interval of length dt at the rates (acc, gyr): the mean by
    Euler steps from the state at the interval's start, and
    P <- F P F^T + G Q G^T."""
    w = gyr - x.bg
    a = acc - x.ba
    I3 = torch.eye(3, dtype=P.dtype, device=P.device)
    F = torch.eye(DIM, dtype=P.dtype, device=P.device)
    Jw = geom.jr_t(-w * dt)
    F[POS:POS + 3, VEL:VEL + 3] = I3 * dt
    F[ROT:ROT + 3, ROT:ROT + 3] = geom.exp(-w * dt)
    F[ROT:ROT + 3, BG:BG + 3] = -Jw * dt
    F[VEL:VEL + 3, ROT:ROT + 3] = -x.R @ geom.hat(a) * dt
    F[VEL:VEL + 3, BA:BA + 3] = -x.R * dt
    F[VEL:VEL + 3, GRAV:GRAV + 2] = geom.s2_m(x.grav, x.grav.new_zeros(2)) * dt
    F[GRAV:GRAV + 2, GRAV:GRAV + 2] = (
        geom.s2_n(x.grav) @ geom.s2_m(x.grav, x.grav.new_zeros(2)))
    G = torch.zeros(DIM, 12, dtype=P.dtype, device=P.device)
    G[ROT:ROT + 3, 0:3] = -Jw * dt
    G[VEL:VEL + 3, 3:6] = -x.R * dt
    G[BG:BG + 3, 6:9] = I3 * dt
    G[BA:BA + 3, 9:12] = I3 * dt
    x_new = replace(x, pos=x.pos + x.vel * dt,
                    vel=x.vel + (x.R @ a + x.grav) * dt,
                    R=x.R @ geom.exp(w * dt))
    P_new = rnd(F @ P @ F.T + G @ Q @ G.T)
    return x_new, P_new


@dataclass
class Poses:
    """The IMU-rate poses of a scan, from its begin: time, position,
    velocity, attitude, and the world acceleration and body rate of the
    interval that ends at each (the first: the previous scan's last)."""
    t: list
    pos: list
    vel: list
    R: list
    acc_w: list
    gyr_b: list


def propagate(x: State, P, Q, acc, gyr, t, g_scale, last_end_rel,
              scan_end_t, last_acc_w, last_gyr_b, rnd):
    """The forward pass over one scan's IMU samples (sample 0 the previous
    packet's tail, times from the scan's begin): midpoint rates, the
    accelerometer scaled to GRAVITY, each interval starting no earlier
    than the previous scan's end, then a last hop to the scan's end at the
    last interval's rates.  Returns (state at the scan's end, P, poses)."""
    poses = Poses([0.0], [x.pos], [x.vel], [x.R], [last_acc_w], [last_gyr_b])
    k = acc.shape[0]
    for i in range(k - 1):
        a_mid = 0.5 * (acc[i] + acc[i + 1]) * g_scale
        w_mid = 0.5 * (gyr[i] + gyr[i + 1])
        t0 = max(float(t[i]), last_end_rel)
        dt = float(t[i + 1]) - t0 if float(t[i + 1]) > t0 else 0.0
        x, P = predict(x, P, Q, a_mid, w_mid, dt, rnd)
        poses.t.append(float(t[i + 1]))
        poses.pos.append(x.pos)
        poses.vel.append(x.vel)
        poses.R.append(x.R)
        poses.acc_w.append(x.R @ (a_mid - x.ba) + x.grav)
        poses.gyr_b.append(w_mid - x.bg)
    j = max(k - 2, 0)
    a_last = 0.5 * (acc[j] + acc[k - 1]) * g_scale
    w_last = 0.5 * (gyr[j] + gyr[k - 1])
    x, P = predict(x, P, Q, a_last, w_last,
                   max(scan_end_t - max(poses.t), 0.0), rnd)
    return x, P, poses


def undistort(x_end: State, poses: Poses, pts, pt_t, m_imu: int, rnd):
    """Each point moved to the lidar frame at the scan's end: from the
    last IMU pose at or before its time (never past the padded buffer's
    second-to-last row), by that interval's rates."""
    T = torch.tensor(poses.t, dtype=pts.dtype, device=pts.device)
    K = len(poses.t)
    idx = torch.searchsorted(T, pt_t.contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, min(K - 1, m_imu - 2))
    nxt = torch.clamp(idx + 1, max=K - 1)
    st = lambda v: torch.stack(v)  # noqa: E731
    Rp, pp, vp = st(poses.R)[idx], st(poses.pos)[idx], st(poses.vel)[idx]
    acc, gyr = st(poses.acc_w)[nxt], st(poses.gyr_b)[nxt]
    dt = torch.clamp(pt_t - T[idx], min=0.0)[:, None]
    R_i = Rp @ geom.exp(gyr * dt)
    p_imu = pts @ x_end.R_il.T + x_end.t_il
    p_w = (R_i @ p_imu[:, :, None])[:, :, 0] + pp + vp * dt + 0.5 * acc * dt * dt
    p_e = (p_w - x_end.pos) @ x_end.R
    return rnd((p_e - x_end.t_il) @ x_end.R_il)


# -- the iterated update -------------------------------------------------------

def transport(d: torch.Tensor, x: State, x0: State) -> torch.Tensor:
    """The block-diagonal T that carries x0's chart to x's for the error
    d = x - x0 (esekfom's P and dx correction)."""
    T = torch.eye(DIM, dtype=d.dtype, device=d.device)
    T[ROT:ROT + 3, ROT:ROT + 3] = geom.jr_t(d[ROT:ROT + 3]).T
    T[EXR:EXR + 3, EXR:EXR + 3] = geom.jr_t(d[EXR:EXR + 3]).T
    T[GRAV:GRAV + 2, GRAV:GRAV + 2] = (geom.s2_n(x.grav)
                                      @ geom.s2_m(x0.grav, d[GRAV:GRAV + 2]))
    return T


def update(x0: State, P0, rows, max_iter: int, rnd):
    """The iterated update from the propagated (x0, P0).  `rows(x,
    associate)` gives (H (n, k), z (n,)) at x: the point-to-plane
    Jacobian rows over the first k error dimensions (k = 6: position and
    attitude; k = 12: and the extrinsic's attitude and translation), and
    the residuals' negation;
    it associates anew when `associate` holds: on the first pass and
    after every converged one.  Up to max_iter + 1 passes; the loop ends
    once two passes have converged.  Returns (x, P)."""
    x, t, conv = x0, 0, True
    for i in range(max_iter + 1):
        H, z = rows(x, conv)
        d = minus(x, x0)
        T = transport(d, x, x0)
        P = T @ P0 @ T.T
        P = 0.5 * (P + P.T)
        Hf = torch.zeros(H.shape[0], DIM, dtype=P.dtype, device=P.device)
        Hf[:, :H.shape[1]] = H
        HTH = rnd(Hf.T @ Hf)
        P_post = torch.linalg.inv(torch.linalg.inv(P) + HTH / R_POINT)
        KH = rnd(P_post @ HTH / R_POINT)
        Kz = rnd(P_post @ (Hf.T @ z) / R_POINT)
        I = torch.eye(DIM, dtype=P.dtype, device=P.device)  # noqa: E741
        dx = Kz + (KH - I) @ (T @ d)
        if H.shape[0] >= 1:
            x = plus(x, dx)
            conv = bool(torch.all(torch.abs(dx) < CONVERGED))
        else:  # no rows: the pass moves nothing and counts as converged
            conv = True
        t += conv
        conv = conv or (t == 0 and i == max_iter - 1)
        if t > 1 or i == max_iter:
            break
    T = transport(dx, x, x0)
    P = T @ ((I - KH) @ P) @ T.T
    return x, 0.5 * (P + P.T)
