"""Trajectory and dynamic-removal evaluation.

The port's own numpy copy of better_fastlio2_tpu/io/evaluate.py.

The reference evaluates offline with ad-hoc scripts
(reference: include/analysis/pose.py, pose3d.py — trajectory plots vs
GT; include/analysis/analysis.py:1-30 — dynamic-removal PR/RR/F1 on
SemanticKITTI labels).  This module makes those first-class:

* ATE RMSE with optional SE(3)/Sim(3)-style Umeyama alignment and
  timestamp association — the BASELINE.md headline metric.
* RPE (relative pose error) over a fixed delta.
* Dynamic-removal precision/recall/F1 given boolean masks.
"""

from __future__ import annotations

import numpy as np

__all__ = ["associate", "umeyama_align", "ate_rmse", "rpe", "rpe_rot", "pr_rr_f1"]


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.05):
    """Nearest-timestamp association; returns index pairs (est, gt)."""
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1)
    prev_closer = np.abs(t_gt[j - 1] - t_est) < np.abs(t_gt[j] - t_est)
    j = np.where(prev_closer, j - 1, j)
    ok = np.abs(t_gt[j] - t_est) <= max_dt
    return np.nonzero(ok)[0], j[ok]


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment est -> gt.

    Returns (R, t, s)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    C = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (np.trace(np.diag(D) @ S) / (E**2).sum() * len(est)) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE (metres) after optional alignment."""
    if align and len(est_pos) >= 3:
        R, t, s = umeyama_align(est_pos, gt_pos)
        est_pos = (s * (R @ est_pos.T)).T + t
    d = est_pos - gt_pos
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def _quat_to_R(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 10) -> float:
    """Translational relative pose error RMSE over `delta`-frame gaps
    (evo-style): per pair, E = (Q_i^-1 Q_j)^-1 (P_i^-1 P_j) and the
    error is ||trans(E)||.

    Accepts (N, 7) rows [qw qx qy qz x y z] (full SE3 RPE, expressed in
    the ground-truth body frame so rotation drift leaks into it) or
    (N, 3) positions (displacement-vector difference — gauge-dependent,
    kept for position-only logs).  Use `rpe_rot` for the rotational
    component."""
    if est.shape[1] == 3:
        de = est[delta:] - est[:-delta]
        dg = gt[delta:] - gt[:-delta]
        err = np.linalg.norm(de - dg, axis=1)
        return float(np.sqrt(np.mean(err * err)))
    Re = _quat_to_R(est[:, 0:4])
    Rg = _quat_to_R(gt[:, 0:4])
    # relative motions in each trajectory's own body frame; the error
    # trans((Q_rel)^-1 P_rel) = Qrel_R^T (de - dg) has the same norm as
    # de - dg (rotation preserves norms), so compare directly
    de = np.einsum("nji,nj->ni", Re[:-delta],
                   est[delta:, 4:7] - est[:-delta, 4:7])
    dg = np.einsum("nji,nj->ni", Rg[:-delta],
                   gt[delta:, 4:7] - gt[:-delta, 4:7])
    e = np.linalg.norm(de - dg, axis=1)
    return float(np.sqrt(np.mean(e * e)))


def rpe_rot(est: np.ndarray, gt: np.ndarray, delta: int = 10) -> float:
    """Rotational RPE RMSE in degrees over `delta`-frame gaps: the
    geodesic angle of (Q_i^-1 Q_j)^-1 (P_i^-1 P_j)'s rotation — the
    component the displacement-magnitude metric is blind to."""
    Re = _quat_to_R(est[:, 0:4])
    Rg = _quat_to_R(gt[:, 0:4])
    Prel = np.einsum("nji,njk->nik", Re[:-delta], Re[delta:])
    Qrel = np.einsum("nji,njk->nik", Rg[:-delta], Rg[delta:])
    E = np.einsum("nji,njk->nik", Qrel, Prel)
    tr = np.clip((np.trace(E, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.degrees(np.arccos(tr))
    return float(np.sqrt(np.mean(ang * ang)))


def pr_rr_f1(pred_dynamic: np.ndarray, gt_dynamic: np.ndarray):
    """Dynamic-removal metrics (include/analysis/analysis.py:1-30):
    PR = precision of predicted-dynamic, RR = recall, F1 harmonic mean."""
    tp = float(np.sum(pred_dynamic & gt_dynamic))
    fp = float(np.sum(pred_dynamic & ~gt_dynamic))
    fn = float(np.sum(~pred_dynamic & gt_dynamic))
    pr = tp / max(tp + fp, 1e-9)
    rr = tp / max(tp + fn, 1e-9)
    f1 = 2 * pr * rr / max(pr + rr, 1e-9)
    return pr, rr, f1
