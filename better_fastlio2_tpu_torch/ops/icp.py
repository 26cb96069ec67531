"""Batched scan-to-scan ICP — loop verification and relocalization.

Port of better_fastlio2_tpu/ops/icp.py, the replacement for the
reference's pcl::IterativeClosestPoint loop verification
(src/laserMapping.cpp:946-974) and the FRICP toolkit
(include/FRICP-toolkit/FRICP.h, ICP.h): correspondences from a voxel-hash
table built once over the target cloud (the live map's own machinery),
closed-form weighted Procrustes steps for point-to-point, a 6x6
Gauss-Newton step for point-to-plane, Welsch weights, Anderson
acceleration and sparse (p-norm ADMM) ICP, and the 9-mode registry.

Translation notes:
* every `lax.scan` is a fixed-count Python loop; nothing inside reads a
  residual or the fitness on the host (callers read the result after the
  call, as the reference's SLAM front end does).  The target table's
  claim loop and the kNN probe loop read the device once a round, as
  everywhere in the port's hash map (utils.device.to_host counts them);
* `jnp.linalg.solve` of the damped 6x6 (and the Anderson (D-1)^2 system)
  is `torch.linalg.solve_ex`, which returns what it computed instead of
  raising on a singular matrix — the reference's `1e-6 I` damping is kept
  and no host check is made;
* the Procrustes rotation R = V D U^T does not depend on the signs of the
  singular vectors, so torch's SVD gives the reference's R.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.measurement import plane_fit
from ..map import voxel_hash
from ..utils import se3, so3

__all__ = ["ICPResult", "icp_point2point", "icp_point2plane",
           "icp_point2plane_aa", "icp_point2point_aa", "icp_sparse",
           "icp_multiscale", "fitness_score", "REG_MODES", "register_run"]


class ICPResult(NamedTuple):
    pose: torch.Tensor  # (7,) [quat wxyz | t] mapping source -> target frame
    fitness: torch.Tensor  # () mean squared correspondence distance (PCL)
    n_inliers: torch.Tensor  # () int
    converged: torch.Tensor  # () bool


def _build_target_map(target, t_valid, voxel, bucket, cap_log2):
    m = voxel_hash.make_map(capacity_log2=cap_log2, bucket=bucket,
                            voxel_size=voxel, dtype=target.dtype,
                            device=target.device)
    return voxel_hash.insert(m, target, t_valid)


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.solve: the LU solution, whatever the matrix (no raise,
    no host read)."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _finish(m, pose, source, s_valid, max_corr) -> ICPResult:
    fit, n_in = fitness_score(m, se3.apply(pose, source), s_valid, max_corr)
    return ICPResult(pose, fit, n_in, torch.isfinite(fit))


def _plane_rows(m, src_w, s_valid, max_corr, thresh):
    """(normal, d, plane_ok) of the 5-NN plane fit at each source point."""
    nb, d2, ok = voxel_hash.knn(m, src_w, k=5, chunk=src_w.shape[0])
    nn_ok = torch.all(ok, dim=-1) & s_valid & (d2[:, 4] <= max_corr * max_corr)
    return plane_fit(nb, nn_ok, thresh=thresh)


def _gn_step(n, src_w, r, w):
    """The damped 6x6 GN step [t, theta] of sum w (r + J dx)^2, J row
    [n, src_w x n] (update T <- Exp([t, th]) o T)."""
    J = torch.cat([n, so3.cross(src_w, n)], dim=-1)  # (N, 6)
    Jw = J * w[:, None]
    H = Jw.T @ J + 1e-6 * _eye(6, J)
    return _solve(H, -(Jw.T @ r))


def icp_point2point(source, s_valid, target, t_valid, init_pose,
                    max_corr: float = 5.0, iters: int = 30,
                    voxel: float = 1.0, welsch_sigma: float = 0.0,
                    cap_log2: int = 15, bucket: int = 8) -> ICPResult:
    """Point-to-point ICP with closed-form weighted-Procrustes steps;
    welsch_sigma > 0 enables the FRICP Welsch kernel
    w = exp(-d^2 / (2 sigma^2)), 0 gives pcl::ICP's hard max_corr gate."""
    m = _build_target_map(target, t_valid, voxel, bucket, cap_log2)
    dtype = source.dtype
    pose = init_pose
    for _ in range(iters):
        src_w = se3.apply(pose, source)
        nb, d2, ok = voxel_hash.knn(m, src_w, k=1, chunk=source.shape[0])
        q = nb[:, 0, :]
        d2 = d2[:, 0]
        w = (ok[:, 0] & s_valid & (d2 <= max_corr * max_corr)).to(dtype)
        if welsch_sigma > 0:
            w = w * torch.exp(-d2 / (2.0 * welsch_sigma * welsch_sigma))
        wsum = torch.clamp(torch.sum(w), min=1e-6)
        mu_p = torch.sum(src_w * w[:, None], dim=0) / wsum
        mu_q = torch.sum(q * w[:, None], dim=0) / wsum
        P = (src_w - mu_p) * w[:, None]
        Hm = P.T @ (q - mu_q)
        U, _, Vt = torch.linalg.svd(Hm)
        d = torch.sign(torch.linalg.det(Vt.T @ U.T))
        D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                    d]))
        R = Vt.T @ D @ U.T
        t = mu_q - R @ mu_p
        pose = se3.compose(se3.from_rot_trans(R, t), pose)
    return _finish(m, pose, source, s_valid, max_corr)


def icp_point2plane(source, s_valid, target, t_valid, init_pose,
                    max_corr: float = 5.0, iters: int = 20,
                    voxel: float = 1.0, welsch_sigma: float = 0.0,
                    cap_log2: int = 15, bucket: int = 8) -> ICPResult:
    """Point-to-plane ICP: plane fit over 5 target NN per source point,
    6x6 GN step on [t, theta] (FRICP.h point_to_plane_GN analog)."""
    m = _build_target_map(target, t_valid, voxel, bucket, cap_log2)
    dtype = source.dtype
    pose = init_pose
    for _ in range(iters):
        src_w = se3.apply(pose, source)
        n, dpl, plane_ok = _plane_rows(m, src_w, s_valid, max_corr, 0.2)
        r = torch.sum(n * src_w, dim=-1) + dpl
        w = plane_ok.to(dtype)
        if welsch_sigma > 0:
            w = w * torch.exp(-(r * r) / (2.0 * welsch_sigma * welsch_sigma))
        dx = _gn_step(n, src_w, r, w)
        pose = se3.compose(se3.make(so3.quat_exp(dx[3:6]), dx[0:3]), pose)
    return _finish(m, pose, source, s_valid, max_corr)


def _pose_to_u(pose):
    """Chart for Anderson mixing: u = [t (3), log R (3)]."""
    return torch.cat([se3.trans(pose), so3.quat_log(se3.rot(pose))])


def _u_to_pose(u):
    return se3.make(so3.quat_exp(u[3:6]), u[0:3])


def _anderson(assoc_energy_step, init_pose, iters: int, D: int):
    """The safeguarded Anderson-accelerated fixed-point loop of FRICP
    (FRICP.h:300-335; AndersonAcceleration.h): G(u) = one association and
    step in the chart u = [t, log R], mixing over the last D residuals,
    the iterate rolled back to the last plain step (and the history reset)
    when the energy rises.  Returns the last accepted plain-step pose."""
    dtype, dev = init_pose.dtype, init_pose.device
    u_cur = _pose_to_u(init_pose)
    fallback_u = u_cur
    e_prev = torch.tensor(1e30, dtype=dtype, device=dev)
    Us = torch.zeros((D, 6), dtype=dtype, device=dev)
    Fs = torch.zeros((D, 6), dtype=dtype, device=dev)
    hist_n = torch.zeros((), dtype=torch.int64, device=dev)
    lanes = torch.arange(D - 1, device=dev)
    for _ in range(iters):
        energy, pose_gn = assoc_energy_step(_u_to_pose(u_cur))
        u_gn = _pose_to_u(pose_gn)
        bad = energy > e_prev
        u_base = torch.where(bad, fallback_u, u_gn)
        f_base = u_base - torch.where(bad, fallback_u, u_cur)
        hist_n = torch.where(bad, 0, hist_n)
        e_prev = torch.where(bad, e_prev, energy)
        Us = torch.cat([u_base[None], Us[:-1]])
        Fs = torch.cat([f_base[None], Fs[:-1]])
        hist_n = torch.clamp(hist_n + 1, max=D)
        mask = (lanes < (hist_n - 1)).to(dtype)
        dF = (Fs[0][None] - Fs[1:]) * mask[:, None]  # (D-1, 6)
        dU = (Us[0][None] - Us[1:]) * mask[:, None]
        A = dF @ dF.T + 1e-10 * _eye(D - 1, dF)
        gamma = _solve(A, dF @ Fs[0])
        u_aa = Us[0] + Fs[0] - (dU + dF).T @ gamma
        u_cur = torch.where(hist_n > 1, u_aa, u_base + 0.0)
        fallback_u = u_gn
    return _u_to_pose(fallback_u)


def icp_point2plane_aa(source, s_valid, target, t_valid, init_pose,
                       max_corr: float = 5.0, iters: int = 20,
                       voxel: float = 1.0, welsch_sigma: float = 0.5,
                       cap_log2: int = 15, bucket: int = 8,
                       aa_depth: int = 5) -> ICPResult:
    """Anderson-accelerated robust point-to-plane ICP (FRICP: Welsch
    kernel + safeguarded Anderson acceleration)."""
    m = _build_target_map(target, t_valid, voxel, bucket, cap_log2)
    dtype = source.dtype

    def assoc_energy_step(pose):
        src_w = se3.apply(pose, source)
        n, dpl, plane_ok = _plane_rows(m, src_w, s_valid, max_corr, 0.2)
        r = torch.sum(n * src_w, dim=-1) + dpl
        base = plane_ok.to(dtype)
        if welsch_sigma > 0:
            s2 = 2.0 * welsch_sigma * welsch_sigma
            w = base * torch.exp(-(r * r) / s2)
            energy = torch.sum(base * (1.0 - torch.exp(-(r * r) / s2)))
        else:
            w = base
            energy = torch.sum(base * r * r)
        energy = energy / torch.clamp(torch.sum(base), min=1.0)
        dx = _gn_step(n, src_w, r, w)
        return energy, se3.compose(
            se3.make(so3.quat_exp(dx[3:6]), dx[0:3]), pose)

    pose = _anderson(assoc_energy_step, init_pose, iters, aa_depth)
    return _finish(m, pose, source, s_valid, max_corr)


def icp_multiscale(source, s_valid, target, t_valid, init_pose,
                   voxels=(8.0, 2.0, 1.0), iters=(8, 8, 12),
                   max_corr: float = 30.0,
                   welsch_sigma: float = 0.0) -> ICPResult:
    """Coarse-to-fine point-to-plane ICP: a coarse first level recovers
    the wide convergence basin of pcl::ICP's 30 m correspondences
    (Incremental_mapping.cpp:485)."""
    pose, res = init_pose, None
    for v, it in zip(voxels, iters):
        res = icp_point2plane(source, s_valid, target, t_valid, pose,
                              max_corr=min(max_corr, 2.5 * v), iters=it,
                              voxel=v, welsch_sigma=welsch_sigma)
        pose = res.pose
    return res


def fitness_score(m, src_w, s_valid, max_range):
    """pcl::Registration::getFitnessScore: mean squared distance of the
    correspondences within max_range (inf without any)."""
    _, d2, ok = voxel_hash.knn(m, src_w, k=1, chunk=src_w.shape[0])
    good = ok[:, 0] & s_valid & (d2[:, 0] <= max_range * max_range)
    n = torch.sum(good.to(torch.int32))
    fit = (torch.sum(torch.where(good, d2[:, 0], 0.0))
           / torch.clamp(n, min=1))
    return torch.where(n > 0, fit, torch.inf), n


# ---------------------------------------------------------------------------
# Sparse ICP (p-norm ADMM) + the FRICP registration-mode registry
# ---------------------------------------------------------------------------

def _shrink(R, mu, p):
    """p-norm proximal (shrinkage) operator (ICP.h:237-269 shrink<3> /
    shrinkage<I>): magnitudes below the threshold ha collapse to zero,
    above it a 3-step fixed point gives the proximal scale.  (N, 3) rows
    or (N,) scalars."""
    n = torch.linalg.vector_norm(R, dim=-1) if R.ndim == 2 else torch.abs(R)
    n = torch.clamp(n, min=1e-12)
    Ba = ((2.0 / mu) * (1.0 - p)) ** (1.0 / (2.0 - p))
    ha = Ba + (p / mu) * Ba ** (p - 1.0)
    s = (Ba / n + 1.0) / 2.0
    for _ in range(3):
        s = 1.0 - (p / mu) * n ** (p - 2.0) * s ** (p - 1.0)
    w = torch.where(n > ha, torch.clamp(s, min=0.0), 0.0)
    return R * (w[..., None] if R.ndim == 2 else w)


def _procrustes(X, U, w):
    """Weighted rigid motion X -> U (RigidMotionEstimator::point_to_point,
    ICP.h:89-126) as a pose7 [wxyz|t]."""
    wn = w / torch.clamp(torch.sum(w), min=1e-12)
    mx = torch.einsum("n,ni->i", wn, X)
    mu_ = torch.einsum("n,ni->i", wn, U)
    S = torch.einsum("n,ni,nj->ij", wn, X - mx, U - mu_)
    A, _, Bt = torch.linalg.svd(S)
    d = torch.linalg.det(Bt.T @ A.T)
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Bt.T @ D @ A.T
    t = mu_ - R @ mx
    return se3.make(so3.matrix_to_quat(R), t)


def icp_sparse(source, s_valid, target, t_valid, init_pose, p: float = 0.4,
               max_corr: float = 5.0, mu0: float = 10.0, alpha: float = 1.2,
               max_mu: float = 1e5, icp_iters: int = 12,
               outer_iters: int = 8, voxel: float = 1.0,
               cap_log2: int = 15, bucket: int = 8,
               point_to_plane: bool = False) -> ICPResult:
    """Sparse ICP: minimise sum_i ||T x_i - q_i||_2^p by ADMM with the
    shrinkage proximal (SICP::point_to_point / point_to_plane,
    ICP.h:275-470): icp_iters associations x outer_iters ADMM steps, each
    a closed-form Procrustes (or one 6x6 GN step); max_inner is 1."""
    m = _build_target_map(target, t_valid, voxel, bucket, cap_log2)
    dtype, dev = source.dtype, source.device
    N = source.shape[0]
    wvalid = s_valid.to(dtype)

    def assoc(src_w):
        if point_to_plane:
            n, dpl, plane_ok = _plane_rows(m, src_w, s_valid, max_corr, 0.3)
            return n, dpl, plane_ok.to(dtype)
        nb, d2, ok = voxel_hash.knn(m, src_w, k=1, chunk=N)
        good = ok[:, 0] & s_valid & (d2[:, 0] <= max_corr * max_corr)
        return nb[:, 0, :], None, good.to(dtype)

    pose = init_pose
    for _ in range(icp_iters):
        q, dpl, w = assoc(se3.apply(pose, source))
        mu = torch.tensor(mu0, dtype=dtype, device=dev)
        if point_to_plane:
            Cc = torch.zeros(N, dtype=dtype, device=dev)
            for _ in range(outer_iters):
                Xw = se3.apply(pose, source)
                r = torch.sum(q * Xw, dim=-1) + dpl
                Z = _shrink(r + Cc / mu, mu, p)
                rr = (r - Z + Cc / mu) * w
                dx = _gn_step(q, Xw, rr, w)
                pose = se3.compose(
                    se3.make(so3.quat_exp(dx[3:6]), dx[0:3]), pose)
                r_new = torch.sum(q * se3.apply(pose, source), dim=-1) + dpl
                Cc = Cc + mu * (r_new - Z)
                mu = torch.clamp(mu * alpha, max=max_mu)
        else:
            Cc = torch.zeros((N, 3), dtype=dtype, device=dev)
            for _ in range(outer_iters):
                Xw = se3.apply(pose, source)
                Z = _shrink(Xw - q + Cc / mu, mu, p)
                step = _procrustes(Xw, q + Z - Cc / mu, w * wvalid)
                pose = se3.compose(step, pose)
                Cc = Cc + mu * (se3.apply(pose, source) - q - Z)
                mu = torch.clamp(mu * alpha, max=max_mu)
    return _finish(m, pose, source, s_valid, max_corr)


def icp_point2point_aa(source, s_valid, target, t_valid, init_pose,
                       max_corr: float = 5.0, iters: int = 20,
                       voxel: float = 1.0, welsch_sigma: float = 0.0,
                       cap_log2: int = 15, bucket: int = 8,
                       aa_depth: int = 5) -> ICPResult:
    """Anderson-accelerated point-to-point ICP (AA-ICP, ICP.h:758-922;
    FR-ICP with welsch_sigma > 0): the safeguarded mixing of
    icp_point2plane_aa with the Procrustes step as the fixed-point map."""
    m = _build_target_map(target, t_valid, voxel, bucket, cap_log2)
    dtype = source.dtype
    N = source.shape[0]

    def assoc_energy_step(pose):
        src_w = se3.apply(pose, source)
        nb, d2, ok = voxel_hash.knn(m, src_w, k=1, chunk=N)
        good = ok[:, 0] & s_valid & (d2[:, 0] <= max_corr * max_corr)
        base = good.to(dtype)
        r2 = d2[:, 0]
        if welsch_sigma > 0:
            s2 = 2.0 * welsch_sigma * welsch_sigma
            w = base * torch.exp(-r2 / s2)
            energy = torch.sum(base * (1.0 - torch.exp(-r2 / s2)))
        else:
            w = base
            energy = torch.sum(base * r2)
        energy = energy / torch.clamp(torch.sum(base), min=1.0)
        return energy, se3.compose(_procrustes(src_w, nb[:, 0, :], w), pose)

    pose = _anderson(assoc_energy_step, init_pose, iters, aa_depth)
    return _finish(m, pose, source, s_valid, max_corr)


# Registration-mode registry (include/FRICP-toolkit/registeration.h:20-27):
#   0 ICP | 1 AA-ICP | 2 Fast ICP | 3 Robust ICP | 4 Fast&Robust ICP |
#   5 ICP point-to-plane | 6 Robust point-to-plane | 7 Sparse ICP |
#   8 Sparse ICP point-to-plane
REG_MODES = {
    0: "icp", 1: "aa_icp", 2: "ficp", 3: "ricp", 4: "fr_icp",
    5: "ppl", 6: "rppl", 7: "sparse_icp", 8: "sicp_ppl",
}


def register_run(mode, source, s_valid, target, t_valid, init_pose,
                 max_corr: float = 5.0, voxel: float = 1.0,
                 iters: int = 25, welsch_sigma: float = 0.5,
                 sparse_p: float = 0.4) -> ICPResult:
    """Registeration::run analog (registeration.h:36-175): one of the 9
    regMode algorithms; `mode` is an int id or a REG_MODES name."""
    if isinstance(mode, str):
        mode = {v: k for k, v in REG_MODES.items()}[mode]
    args = (source, s_valid, target, t_valid, init_pose)
    common = dict(max_corr=max_corr, voxel=voxel)
    if mode == 0:
        return icp_point2point(*args, iters=iters, **common)
    if mode in (1, 2):  # AA-ICP; Fast ICP is the same mixing
        return icp_point2point_aa(*args, iters=iters, welsch_sigma=0.0,
                                  **common)
    if mode == 3:  # Robust ICP = Welsch point-to-point
        return icp_point2point(*args, iters=iters, welsch_sigma=welsch_sigma,
                               **common)
    if mode == 4:  # Fast & Robust = Welsch + Anderson
        return icp_point2point_aa(*args, iters=iters,
                                  welsch_sigma=welsch_sigma, **common)
    if mode == 5:
        return icp_point2plane(*args, iters=iters, **common)
    if mode == 6:
        return icp_point2plane_aa(*args, iters=iters,
                                  welsch_sigma=welsch_sigma, **common)
    if mode in (7, 8):
        return icp_sparse(*args, p=sparse_p, point_to_plane=mode == 8,
                          **common)
    raise ValueError(f"unknown registration mode {mode}")
