"""Pose-graph optimization: batched Gauss-Newton with a matrix-free PCG.

Port of better_fastlio2_tpu/backend/posegraph.py, the replacement for the
reference's GTSAM iSAM2 back end (src/laserMapping.cpp:550-812).  Every
optimization re-linearizes the whole graph and solves the normal
equations with a Jacobi-preconditioned conjugate gradient whose matvec is
a gather/scatter over the factor arrays:

    H v = sum_f J_f^T W_f (J_f v_f)

Factor types (fixed-capacity padded arrays, mask-gated): prior (anchors a
pose), between (odometry and loop factors, 6-diagonal noise, optional
Cauchy kernel) and GPS (unary position).  Error convention (right
perturbation, split SO3 x R^3 retraction):
  e_t = R_i^T (t_j - t_i) - t_ij
  e_r = Log(R_ij^T R_i^T R_j)

Translation notes:
* `.at[idx].set(v, mode="drop")` of the factor adds becomes a write into a
  sink row past the end of a copy, cut off afterwards: no host read.
* The scatter-adds of the optimizer (`scatter_JTWe`, `hvp`, `diag_H`:
  `.at[bw_i].add`, repeated indices) would run on CUDA atomics as a float
  `index_add_`, whose bits change from run to run.  `_SegmentSum` sorts the
  factor lanes by target once per call (stable, lanes dropped by
  `mode="drop"` sent to a sink segment) and sums each target's rows in
  lane order with `segment_reduce`: the same bits on every run.
* The GN and CG `lax.scan`s are fixed-count Python loops that read
  nothing on the host; `torch.linalg` is never asked to solve here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import se3, so3

__all__ = ["PoseGraph", "make_graph", "add_prior", "add_between", "add_gps",
           "set_pose", "set_poses", "optimize", "dense_marginals",
           "selected_marginals"]


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # (K, 7) [quat wxyz | t]
    n_poses: torch.Tensor  # () int32

    prior_idx: torch.Tensor  # (P,) int32
    prior_pose: torch.Tensor  # (P, 7)
    prior_sqw: torch.Tensor  # (P, 6) sqrt information diag [t, r]
    prior_mask: torch.Tensor  # (P,) bool
    n_prior: torch.Tensor  # ()

    bw_i: torch.Tensor  # (F,) int32
    bw_j: torch.Tensor  # (F,) int32
    bw_meas: torch.Tensor  # (F, 7) T_ij
    bw_sqw: torch.Tensor  # (F, 6) sqrt information diag [t, r]
    bw_robust: torch.Tensor  # (F,) bool — apply Cauchy kernel
    bw_mask: torch.Tensor  # (F,) bool
    n_bw: torch.Tensor  # ()

    # GPS factors: unary position measurements (the reference declares
    # addGPSFactor but leaves it commented out, laserMapping.cpp:689)
    gps_idx: torch.Tensor  # (G,) int32
    gps_pos: torch.Tensor  # (G, 3) measured world position
    gps_sqw: torch.Tensor  # (G, 3) sqrt information diag
    gps_mask: torch.Tensor  # (G,) bool
    n_gps: torch.Tensor  # ()


def make_graph(max_poses: int, max_priors: int, max_between: int,
               max_gps: int = 0, dtype=torch.float32,
               device=None) -> PoseGraph:
    ident = se3.identity(dtype, device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    mg = max(max_gps, 1)
    i32, b = torch.int32, torch.bool
    return PoseGraph(
        poses=ident.repeat(max_poses, 1), n_poses=z(dt=i32),
        prior_idx=z(max_priors, dt=i32),
        prior_pose=ident.repeat(max_priors, 1),
        prior_sqw=z(max_priors, 6), prior_mask=z(max_priors, dt=b),
        n_prior=z(dt=i32),
        bw_i=z(max_between, dt=i32), bw_j=z(max_between, dt=i32),
        bw_meas=ident.repeat(max_between, 1), bw_sqw=z(max_between, 6),
        bw_robust=z(max_between, dt=b), bw_mask=z(max_between, dt=b),
        n_bw=z(dt=i32),
        gps_idx=z(mg, dt=i32), gps_pos=z(mg, 3), gps_sqw=z(mg, 3),
        gps_mask=z(mg, dt=b), n_gps=z(dt=i32),
    )


def _set_row(a: torch.Tensor, k: torch.Tensor, v) -> torch.Tensor:
    """A copy of `a` with row k set to v, unchanged when k is past the end
    (`.at[k].set(v, mode="drop")`): the write goes to a sink row."""
    n = a.shape[0]
    out = torch.cat([a, a[:1]])
    k = torch.clamp(torch.as_tensor(k, device=a.device).to(torch.int64),
                    0, n).reshape(1)
    v = torch.as_tensor(v, device=a.device).to(a.dtype)
    out.index_put_((k,), v.reshape((1,) + a.shape[1:]))
    return out[:n]


def add_gps(g: PoseGraph, idx, pos, sigma) -> PoseGraph:
    """Unary GPS position factor on pose idx (3-dof translation)."""
    k = g.n_gps
    dt, dev = g.poses.dtype, g.poses.device
    sq = torch.full((3,), 1.0, dtype=dt, device=dev) / sigma
    return g._replace(
        gps_idx=_set_row(g.gps_idx, k, idx),
        gps_pos=_set_row(g.gps_pos, k, pos),
        gps_sqw=_set_row(g.gps_sqw, k, sq),
        gps_mask=_set_row(g.gps_mask, k, True),
        n_gps=torch.clamp(k + 1, max=g.gps_idx.shape[0]),
    )


def add_prior(g: PoseGraph, idx, pose, sigma_t, sigma_r) -> PoseGraph:
    k = g.n_prior
    dt, dev = pose.dtype, pose.device
    sq = torch.cat([torch.full((3,), 1.0 / sigma_t, dtype=dt, device=dev),
                    torch.full((3,), 1.0 / sigma_r, dtype=dt, device=dev)])
    return g._replace(
        prior_idx=_set_row(g.prior_idx, k, idx),
        prior_pose=_set_row(g.prior_pose, k, pose),
        prior_sqw=_set_row(g.prior_sqw, k, sq),
        prior_mask=_set_row(g.prior_mask, k, True),
        n_prior=torch.clamp(k + 1, max=g.prior_idx.shape[0]),
    )


def add_between(g: PoseGraph, i, j, meas, sigma_t, sigma_r,
                robust=False) -> PoseGraph:
    k = g.n_bw
    dt, dev = meas.dtype, meas.device
    one = torch.full((3,), 1.0, dtype=dt, device=dev)
    sq = torch.cat([one / sigma_t, one / sigma_r])
    return g._replace(
        bw_i=_set_row(g.bw_i, k, i),
        bw_j=_set_row(g.bw_j, k, j),
        bw_meas=_set_row(g.bw_meas, k, meas),
        bw_sqw=_set_row(g.bw_sqw, k, sq),
        bw_robust=_set_row(g.bw_robust, k, robust),
        bw_mask=_set_row(g.bw_mask, k, True),
        n_bw=torch.clamp(k + 1, max=g.bw_i.shape[0]),
    )


def set_pose(g: PoseGraph, idx, pose) -> PoseGraph:
    return g._replace(
        poses=_set_row(g.poses, idx, pose),
        n_poses=torch.clamp(g.n_poses, min=int(idx) + 1),
    )


def set_poses(g: PoseGraph, poses: torch.Tensor, n) -> PoseGraph:
    """Batch pose writeback: replace rows [0, n) of the pose buffer in ONE
    masked update (correctPoses applies the whole optimized array,
    laserMapping.cpp:769-805)."""
    P = g.poses.shape[0]
    k = min(int(n), P)
    padded = torch.zeros_like(g.poses)
    padded[:poses.shape[0]] = poses.to(g.poses.dtype)
    mask = (torch.arange(P, device=g.poses.device) < k)[:, None]
    return g._replace(
        poses=torch.where(mask, padded, g.poses),
        n_poses=torch.clamp(g.n_poses, min=k),
    )


# ---------------------------------------------------------------------------
# linearization
# ---------------------------------------------------------------------------


def _between_residual_jac(poses, bw_i, bw_j, bw_meas):
    """Residuals (F, 6) [e_t, e_r] and Jacobian blocks (F, 6, 6) for i, j."""
    Ti = poses[bw_i.long()]
    Tj = poses[bw_j.long()]
    qi, ti = se3.rot(Ti), se3.trans(Ti)
    qj, tj = se3.rot(Tj), se3.trans(Tj)
    qij, tij = se3.rot(bw_meas), se3.trans(bw_meas)

    dt_w = tj - ti
    dt_i = so3.quat_inv_rotate(qi, dt_w)
    e_t = dt_i - tij
    q_rel = so3.quat_multiply(so3.quat_conjugate(qi), qj)
    e_r = so3.quat_log(so3.quat_multiply(so3.quat_conjugate(qij), q_rel))
    e = torch.cat([e_t, e_r], dim=-1)

    F = bw_i.shape[0]
    Z = torch.zeros((F, 3, 3), dtype=poses.dtype, device=poses.device)
    I3 = torch.eye(3, dtype=poses.dtype, device=poses.device).expand(F, 3, 3)
    Ri_T = so3.quat_to_matrix(qi).transpose(-1, -2)
    Rrel_T = so3.quat_to_matrix(
        so3.quat_multiply(so3.quat_conjugate(qj), qi))  # R_j^T R_i
    # d e_t and d e_r w.r.t. [dt_i, dth_i] and [dt_j, dth_j]
    J_ti = torch.cat([-Ri_T, so3.hat(dt_i)], dim=-1)
    J_tj = torch.cat([Ri_T, Z], dim=-1)
    J_ri = torch.cat([Z, -Rrel_T], dim=-1)
    J_rj = torch.cat([Z, I3], dim=-1)
    J_i = torch.cat([J_ti, J_ri], dim=-2)  # (F, 6, 6)
    J_j = torch.cat([J_tj, J_rj], dim=-2)
    return e, J_i, J_j


def _prior_residual_jac(poses, p_idx, p_pose):
    Ti = poses[p_idx.long()]
    e_t = se3.trans(Ti) - se3.trans(p_pose)
    e_r = so3.quat_log(so3.quat_multiply(so3.quat_conjugate(se3.rot(p_pose)),
                                         se3.rot(Ti)))
    e = torch.cat([e_t, e_r], dim=-1)
    F = p_idx.shape[0]
    J = torch.eye(6, dtype=poses.dtype, device=poses.device).expand(F, 6, 6)
    return e, J


def _cauchy_weight(e2, c2):
    """IRLS weight of the Cauchy kernel rho(s) = c^2/2 log(1 + s/c^2):
    w = 1 / (1 + s/c^2)."""
    return 1.0 / (1.0 + e2 / c2)


class _SegmentSum:
    """out[idx[l]] += rows[l] over (K, 6) targets for the factor lanes of
    one graph (between i, between j, prior, GPS, in that order), lanes
    with an index past K dropped — with the same bits on every run.  The
    lanes are sorted by target once (stable); each call sums every
    target's rows in lane order (segment_reduce) and empty targets are 0."""

    def __init__(self, idx: list[torch.Tensor], K: int):
        key = torch.cat([i.long() for i in idx])
        key = torch.where((key >= 0) & (key < K), key, K)
        self.order = torch.sort(key, stable=True).indices
        self.lengths = torch.bincount(key, minlength=K + 1)
        self.K = K

    def __call__(self, rows: list[torch.Tensor]) -> torch.Tensor:
        r = torch.cat(rows)[self.order]
        return torch.segment_reduce(r, "sum", lengths=self.lengths,
                                    unsafe=True)[:self.K]


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def optimize(g: PoseGraph, iters: int = 5, cg_iters: int = 40,
             cauchy_c: float = 1.0, damping: float = 1e-6) -> PoseGraph:
    """Gauss-Newton with Jacobi-PCG inner solves over the whole graph, in
    `iters` x `cg_iters` fixed steps (the reference's isam->update();
    correctPoses reads back g.poses).  Runs on the graph's device and
    reads nothing on the host."""
    K = g.poses.shape[0]
    dtype, dev = g.poses.dtype, g.poses.device
    active = (torch.arange(K, device=dev) < g.n_poses)[:, None]
    seg = _SegmentSum([g.bw_i, g.bw_j, g.prior_idx, g.gps_idx], K)
    bi, bj = g.bw_i.long(), g.bw_j.long()
    pi, gi = g.prior_idx.long(), g.gps_idx.long()
    zg = torch.zeros((g.gps_idx.shape[0], 3), dtype=dtype, device=dev)

    def pad6(r3):  # GPS rows touch the translation half only
        return torch.cat([r3, zg], dim=-1)

    def JT(J, v):  # (F, 6, 6)^T (F, 6) per factor
        return torch.einsum("fab,fa->fb", J, v)

    poses = g.poses
    for _ in range(iters):
        e_b, Ji, Jj = _between_residual_jac(poses, g.bw_i, g.bw_j, g.bw_meas)
        e_p, Jp = _prior_residual_jac(poses, g.prior_idx, g.prior_pose)
        # robust IRLS weights on whitened between residuals
        wh = e_b * g.bw_sqw
        e2 = torch.sum(wh * wh, dim=-1)
        w_rob = torch.where(g.bw_robust,
                            _cauchy_weight(e2, cauchy_c * cauchy_c), 1.0)
        w_b = g.bw_sqw ** 2 * (w_rob * g.bw_mask)[:, None]  # (F, 6)
        w_p = g.prior_sqw ** 2 * g.prior_mask[:, None]
        # GPS residuals: e = t_i - t_gps, J = [I3 | 0]
        e_g = se3.trans(poses[gi]) - g.gps_pos
        w_g = g.gps_sqw ** 2 * g.gps_mask[:, None]  # (G, 3)

        # rhs: b = -(J^T W e)
        b = -seg([JT(Ji, w_b * e_b), JT(Jj, w_b * e_b), JT(Jp, w_p * e_p),
                  pad6(w_g * e_g)])

        def hvp(v):
            Jv = (torch.einsum("fab,fb->fa", Ji, v[bi])
                  + torch.einsum("fab,fb->fa", Jj, v[bj]))
            WJv = w_b * Jv
            Jvp = torch.einsum("fab,fb->fa", Jp, v[pi])
            return seg([JT(Ji, WJv), JT(Jj, WJv), JT(Jp, w_p * Jvp),
                        pad6(w_g * v[gi, 0:3])]) + damping * v

        # Jacobi preconditioner: the diagonal of H
        diag = seg([torch.sum(Ji * Ji * w_b[:, :, None], dim=1),
                    torch.sum(Jj * Jj * w_b[:, :, None], dim=1),
                    torch.sum(Jp * Jp * w_p[:, :, None], dim=1),
                    pad6(w_g)]) + damping
        Minv = torch.where(active, 1.0 / torch.clamp(diag, min=1e-12), 0.0)
        b = torch.where(active, b, 0.0)

        x = torch.zeros((K, 6), dtype=dtype, device=dev)
        r = b
        z = Minv * r
        p = z
        rz = _vdot(r, z)
        for _ in range(cg_iters):
            Ap = torch.where(active, hvp(p), 0.0)
            alpha = rz / torch.clamp(_vdot(p, Ap), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            z = Minv * r
            rz_new = _vdot(r, z)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            p = z + beta * p
            rz = rz_new

        # retract: t += dt (world frame), R <- R Exp(dth)
        new_t = se3.trans(poses) + x[:, 0:3]
        new_q = so3.quat_normalize(
            so3.quat_multiply(se3.rot(poses), so3.quat_exp(x[:, 3:6])))
        poses = torch.where(active, se3.make(new_q, new_t), poses)
    return g._replace(poses=poses)


def dense_marginals(g: PoseGraph, n_active: int, damping: float = 1e-3):
    """Per-pose (K, 6, 6) marginal covariance blocks from the FULL
    Gauss-Newton Hessian (the isam->marginalCovariance analog,
    Incremental_mapping.cpp:718-719): the dense (6K, 6K) information
    matrix of every active factor at the current linearization point,
    inverted once through its Cholesky factor."""
    K = int(n_active)
    dtype, dev = g.poses.dtype, g.poses.device
    H = torch.zeros((K, K, 6, 6), dtype=dtype, device=dev)  # [i, j, a, b]

    _, Ji, Jj = _between_residual_jac(g.poses, g.bw_i, g.bw_j, g.bw_meas)
    w_b = g.bw_sqw ** 2 * g.bw_mask[:, None]
    ok = g.bw_mask & (g.bw_i < K) & (g.bw_j < K)
    wb = torch.where(ok[:, None], w_b, 0.0)
    bi = torch.clamp(g.bw_i, max=K - 1).long()
    bj = torch.clamp(g.bw_j, max=K - 1).long()
    Hii = torch.einsum("fai,fa,faj->fij", Ji, wb, Ji)
    Hjj = torch.einsum("fai,fa,faj->fij", Jj, wb, Jj)
    Hij = torch.einsum("fai,fa,faj->fij", Ji, wb, Jj)
    # sorted, in-order accumulation (index_put_ with accumulate)
    H.index_put_((bi, bi), Hii, accumulate=True)
    H.index_put_((bj, bj), Hjj, accumulate=True)
    H.index_put_((bi, bj), Hij, accumulate=True)
    H.index_put_((bj, bi), Hij.transpose(-1, -2), accumulate=True)

    _, Jp = _prior_residual_jac(g.poses, g.prior_idx, g.prior_pose)
    okp = g.prior_mask & (g.prior_idx < K)
    wp = torch.where(okp[:, None], g.prior_sqw ** 2, 0.0)
    pi = torch.clamp(g.prior_idx, max=K - 1).long()
    H.index_put_((pi, pi), torch.einsum("fai,fa,faj->fij", Jp, wp, Jp),
                 accumulate=True)

    okg = g.gps_mask & (g.gps_idx < K)
    wg = torch.where(okg[:, None], g.gps_sqw ** 2, 0.0)
    gi = torch.clamp(g.gps_idx, max=K - 1).long()
    Hg = torch.zeros((g.gps_idx.shape[0], 6, 6), dtype=dtype, device=dev)
    Hg[:, 0:3, 0:3] = torch.diag_embed(wg)
    H.index_put_((gi, gi), Hg, accumulate=True)

    Hd = (H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
          + damping * torch.eye(6 * K, dtype=dtype, device=dev))
    eye = torch.eye(6 * K, dtype=dtype, device=dev)
    Sigma = torch.cholesky_solve(eye, torch.linalg.cholesky(Hd))
    Sigma = Sigma.reshape(K, 6, K, 6)
    idx = torch.arange(K, device=dev)
    return Sigma[idx, :, idx, :]  # (K, 6, 6)


def selected_marginals(g: PoseGraph, n_active: int, damping: float = 1e-3):
    """All (K, 6, 6) diagonal blocks of the GN Hessian inverse — the same
    marginals as dense_marginals, computed by structure (the chain of
    consecutive factors plus a few loop factors) instead of a dense
    (6K)^2 Cholesky: H = T + U U^T with T block-tridiagonal and U the
    stacked loop-factor square-root blocks, then by Woodbury

      diag_k(H^-1) = diag_k(T^-1) - X_k M^-1 X_k^T,  X = T^-1 U,
      M = I + U^T X,

    diag_k(T^-1) by the two-sided block-Schur recursion and X by the
    block-Thomas solve.  O(K L^2) time, O(K L) memory; on the host in f64
    (the offline multi-session path), returned as a numpy array."""
    K = int(n_active)

    def h(t):
        return t.detach().cpu().numpy()

    _, Ji_t, Jj_t = _between_residual_jac(g.poses, g.bw_i, g.bw_j,
                                          g.bw_meas)
    Ji = h(Ji_t).astype(np.float64)
    Jj = h(Jj_t).astype(np.float64)
    bw_i, bw_j = h(g.bw_i), h(g.bw_j)
    w_b = h(g.bw_sqw).astype(np.float64) ** 2
    okb = h(g.bw_mask) & (bw_i < K) & (bw_j < K)

    D = np.zeros((K, 6, 6))
    B = np.zeros((max(K - 1, 1), 6, 6))  # coupling (k, k+1)
    D += damping * np.eye(6)

    _, Jp_t = _prior_residual_jac(g.poses, g.prior_idx, g.prior_pose)
    Jp = h(Jp_t).astype(np.float64)
    p_idx, p_sqw = h(g.prior_idx), h(g.prior_sqw).astype(np.float64)
    okp = h(g.prior_mask) & (p_idx < K)
    for f in np.where(okp)[0]:
        w = p_sqw[f] ** 2
        D[int(p_idx[f])] += Jp[f].T @ (w[:, None] * Jp[f])
    g_idx, g_sqw = h(g.gps_idx), h(g.gps_sqw).astype(np.float64)
    okg = h(g.gps_mask) & (g_idx < K)
    for f in np.where(okg)[0]:
        D[int(g_idx[f])][:3, :3] += np.diag(g_sqw[f] ** 2)

    # between factors: chain (|i - j| == 1) into T, the rest into U
    loop_blocks = []
    for f in np.where(okb)[0]:
        i, j = int(bw_i[f]), int(bw_j[f])
        Wi = w_b[f]
        Hii = Ji[f].T @ (Wi[:, None] * Ji[f])
        Hjj = Jj[f].T @ (Wi[:, None] * Jj[f])
        Hij = Ji[f].T @ (Wi[:, None] * Jj[f])
        if abs(i - j) == 1:
            D[i] += Hii
            D[j] += Hjj
            lo = min(i, j)
            B[lo] += Hij if i < j else Hij.T
        else:
            sq = np.sqrt(Wi)
            loop_blocks.append((i, j, Ji[f].T * sq, Jj[f].T * sq))

    L = len(loop_blocks)
    U = np.zeros((K, 6, 6 * L))
    for li, (i, j, Ui, Uj) in enumerate(loop_blocks):
        U[i, :, 6 * li: 6 * li + 6] += Ui
        U[j, :, 6 * li: 6 * li + 6] += Uj

    # left-connected Schur recursion with forward elimination of U
    Lam = np.zeros((K, 6, 6))
    Gf = np.zeros_like(U)
    Lam[0] = D[0]
    Gf[0] = U[0]
    for k in range(1, K):
        Wk = B[k - 1].T @ np.linalg.inv(Lam[k - 1])
        Lam[k] = D[k] - Wk @ B[k - 1]
        Gf[k] = U[k] - Wk @ Gf[k - 1]
    # right-connected recursion
    Psi = np.zeros((K, 6, 6))
    Psi[K - 1] = D[K - 1]
    for k in range(K - 2, -1, -1):
        Psi[k] = D[k] - B[k] @ np.linalg.inv(Psi[k + 1]) @ B[k].T
    Tinv_kk = np.linalg.inv(Lam + Psi - D)
    if L == 0:
        return Tinv_kk

    # back substitution: X = T^-1 U
    X = np.zeros_like(U)
    X[K - 1] = np.linalg.solve(Lam[K - 1], Gf[K - 1])
    for k in range(K - 2, -1, -1):
        X[k] = np.linalg.solve(Lam[k], Gf[k] - B[k] @ X[k + 1])
    M = np.eye(6 * L) + np.einsum("kaL,kaM->LM", U, X)
    Q = np.linalg.solve(M, X.transpose(2, 0, 1).reshape(6 * L, -1))
    Q = Q.reshape(6 * L, K, 6)
    corr = np.einsum("kaL,Lkb->kab", X, Q)
    return Tinv_kk - corr
