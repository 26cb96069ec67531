"""PatchWork ground segmentation — batched concentric-zone plane fitting.

Port of better_fastlio2_tpu/perception/patchwork.py (reference:
include/dynamic-remove/patchwork.h).  Every one of the 504 patches of the
CZM layout is a lane of one dense batched computation:

  * points -> (zone, ring, sector) patch ids (patchwork.h:50-93: zones
    {2,4,4,4} rings x {16,32,54,32} sectors)
  * per-patch capped point matrix via sort + scatter
  * seed extraction (lowest-point-representative mean + th_seeds,
    extract_initial_seeds_, patchwork.h:238-270)
  * num_iter=3 rounds of masked PCA plane fit + th_dist reclassification
    (estimate_plane_ / extract_piecewiseground, :219-234, :378-420)
  * patch-level gates: uprightness, elevation, flatness (:335-395)

Translation notes:
* `jnp.lexsort((z, patch_id))` (patch id primary) is two stable sorts;
  the group heads' `associative_scan(maximum)` is `torch.cummax`;
* the capped scatter `.at[dest].set(mode="drop")` writes unique
  destinations plus one sink row for the overflow, cut off after;
* the ring and sector bins and the range are computed as XLA compiles
  them (utils/xla_math.py), so a point on a bin edge lands in the same
  bin;
* `jnp.linalg.eigvalsh` is `torch.linalg.eigvalsh`, which on CUDA checks
  its solver status on the host (one synchronisation a call).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.measurement import _sym3_smallest_eig
from ..map.voxel_hash import _lexsort
from ..utils.xla_math import div_const, hypot

__all__ = ["PatchworkParams", "estimate_ground"]


class PatchworkParams(NamedTuple):
    sensor_height: float = 1.732
    num_iter: int = 3
    num_lpr: int = 20
    num_min_pts: int = 10
    th_seeds: float = 0.3
    th_dist: float = 0.1
    max_range: float = 80.0
    min_range: float = 0.1
    uprightness_thr: float = 0.707
    adaptive_margin: float = -1.1
    patch_cap: int = 256  # max points used for fitting per patch


# CZM layout (patchwork.h:50-51)
_SECTORS = (16, 32, 54, 32)
_RINGS = (2, 4, 4, 4)
_ELEV_THR = (-1.2, -0.9984, -0.851, -0.605)
_FLAT_THR = (0.0, 0.000125, 0.000185, 0.000185)
N_PATCHES = sum(r * s for r, s in zip(_RINGS, _SECTORS))  # 504


def _zone_boundaries(p: PatchworkParams):
    z2 = (7 * p.min_range + p.max_range) / 8.0
    z3 = (3 * p.min_range + p.max_range) / 4.0
    z4 = (p.min_range + p.max_range) / 2.0
    return (p.min_range, z2, z3, z4, p.max_range)


def _patch_tables(device):
    zl, rl = [], []
    for k in range(4):
        for ring in range(_RINGS[k]):
            zl += [k] * _SECTORS[k]
            rl += [sum(_RINGS[:k]) + ring] * _SECTORS[k]
    return (torch.tensor(zl, dtype=torch.int64, device=device),
            torch.tensor(rl, dtype=torch.int64, device=device))


def estimate_ground(pts: torch.Tensor, valid: torch.Tensor,
                    params: PatchworkParams = PatchworkParams(),
                    return_ill_posed: bool = False):
    """Returns a bool ground mask over pts (N, 3).

    Out-of-range or invalid points are non-ground (the reference routes
    them to cloud_nonground).  return_ill_posed=True also returns, per
    point, whether its patch's plane fit was rank-deficient in some
    iteration (two or more vanishing eigenvalues: a seed set of two
    points, or collinear ones).  There the smallest eigenvector is not
    determined, the reference returns an arbitrary one, and a rounding
    difference anywhere before (a reduction order, a transcendental)
    picks another plane: masks agree across implementations and devices
    only outside those patches."""
    p = params
    dtype, dev = pts.dtype, pts.device
    N = pts.shape[0]
    CAP = p.patch_cap

    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r = hypot(x, y)
    theta = torch.atan2(y, x)
    theta = torch.where(theta < 0, theta + 2 * math.pi, theta)

    bounds = _zone_boundaries(p)
    in_range = (r >= bounds[0]) & (r < bounds[4]) & valid

    # patch id assembly
    patch_id = torch.zeros(N, dtype=torch.int64, device=dev)
    base = 0
    for k in range(4):
        lo, hi = bounds[k], bounds[k + 1]
        nr, ns = _RINGS[k], _SECTORS[k]
        inz = (r >= lo) & (r < hi)
        ring = torch.clamp(div_const(r - lo, (hi - lo) / nr).to(torch.int32),
                           0, nr - 1)
        sect = torch.clamp(div_const(theta, 2 * math.pi / ns).to(torch.int32),
                           0, ns - 1)
        patch_id = torch.where(inz, base + ring.long() * ns + sect.long(),
                               patch_id)
        base += nr * ns
    patch_id = torch.where(in_range, patch_id, N_PATCHES)  # overflow bucket

    # ---- per-patch capped point matrices (sorted by z ascending) ---------
    order = _lexsort([z, patch_id])
    pid_s = patch_id[order]
    pts_s = pts[order]
    idx = torch.arange(N, device=dev)
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = pid_s[1:] != pid_s[:-1]
    group_head = torch.cummax(torch.where(first, idx, 0), dim=0).values
    rank = idx - group_head
    ok = (pid_s < N_PATCHES) & (rank < CAP)
    sink = N_PATCHES * CAP
    dest = torch.where(ok, pid_s * CAP + rank, sink)
    P = torch.zeros((sink + 1, 3), dtype=dtype, device=dev)
    P[dest] = pts_s
    P = P[:sink].reshape(N_PATCHES, CAP, 3)
    M = torch.zeros(sink + 1, dtype=torch.bool, device=dev)
    M[dest] = ok
    M = M[:sink].reshape(N_PATCHES, CAP)
    counts = torch.bincount(pid_s, minlength=N_PATCHES + 1)[:N_PATCHES]

    zone_of_patch, ring_of_patch = _patch_tables(dev)

    # ---- initial seeds ----------------------------------------------------
    Pz = P[:, :, 2]
    # zone-0 margin skip: ignore points below margin * sensor_height
    too_low = (Pz < p.adaptive_margin * p.sensor_height) & (
        zone_of_patch[:, None] == 0)
    seed_ok = M & ~too_low
    # LPR = mean z of first num_lpr eligible (z-sorted) points
    elig_rank = torch.cumsum(seed_ok.to(torch.int32), dim=1) - 1
    in_lpr = seed_ok & (elig_rank < p.num_lpr)
    lpr = torch.sum(torch.where(in_lpr, Pz, 0.0), dim=1) / torch.clamp(
        torch.sum(in_lpr, dim=1), min=1)
    ground = seed_ok & (Pz < (lpr + p.th_seeds)[:, None])

    # ---- iterative plane fit ---------------------------------------------
    def fit(ground_mask):
        w = ground_mask.to(dtype)[..., None]
        cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
        mean = torch.sum(P * w, dim=1) / cnt
        q = (P - mean[:, None, :]) * w
        C = torch.einsum("pki,pkj->pij", q, q) / cnt[..., None]
        normal = _sym3_smallest_eig(C)[0]
        evals = torch.sort(torch.linalg.eigvalsh(C), dim=-1).values
        # uprightness uses |n_z|, elevation the mean z: the normal's sign
        # is irrelevant
        d = -torch.sum(normal * mean, dim=-1)
        return normal, d, mean, evals

    ill = torch.zeros(N_PATCHES, dtype=torch.bool, device=dev)
    for _ in range(p.num_iter):
        normal, d, mean, evals = fit(ground)
        ill |= (evals[:, 2] > 0) & (evals[:, 1] <= 1e-9 * evals[:, 2])
        proj = (P[..., 0] * normal[:, None, 0] + P[..., 1] * normal[:, None, 1]
                + P[..., 2] * normal[:, None, 2])
        ground = M & (proj < (p.th_dist - d)[:, None])

    # ---- patch-level gates -----------------------------------------------
    upright = torch.abs(normal[:, 2]) >= p.uprightness_thr
    elev = mean[:, 2]
    surface_var = evals[:, 0] / torch.clamp(
        evals[:, 0] + evals[:, 1] + evals[:, 2], min=1e-12)
    elev_thr = torch.tensor(_ELEV_THR, dtype=dtype, device=dev)
    flat_thr = torch.tensor(_FLAT_THR, dtype=dtype, device=dev)
    ridx = torch.clamp(ring_of_patch, 0, 3)
    near = ring_of_patch < len(_ELEV_THR)
    elev_ok = elev <= elev_thr[ridx]
    flat_ok = flat_thr[ridx] > surface_var
    patch_ground_ok = upright & (~near | elev_ok | flat_ok) & (
        counts >= p.num_min_pts)

    # ---- classify EVERY input point by its patch plane --------------------
    pid_safe = torch.clamp(patch_id, max=N_PATCHES - 1)
    n_pt = normal[pid_safe]
    proj_pt = pts[:, 0] * n_pt[:, 0] + pts[:, 1] * n_pt[:, 1] + (
        pts[:, 2] * n_pt[:, 2])
    below = proj_pt < (p.th_dist - d)[pid_safe]
    mask = in_range & below & patch_ground_ok[pid_safe]
    if return_ill_posed:
        return mask, in_range & ill[pid_safe]
    return mask
