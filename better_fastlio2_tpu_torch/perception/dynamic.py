"""Dynamic-object removal: curved-voxel clustering + PD/HD tracking.

Port of better_fastlio2_tpu/perception/dynamic.py, the dense-grid form of
the reference's SSC + TGRS pipeline (include/dynamic-remove/tgrs.{h,cpp},
the simplified T-GRS 2024 "SCV-OD"):

* SSC scan encoding (tgrs.h:117-185): polar voxelisation at
  0.25 m x 2 deg x 3 deg over range 1-50 m, azimuth [-30, 60] deg — a
  dense (AZIMUTH, RANGE, SECTOR) = (30, 196, 180) occupancy grid (~1.06 M
  cells).  The sector axis does not wrap at 0/360 deg, like the
  reference's findVoxelNeighbors (tgrs.cpp:12-28).
* cluster (tgrs.cpp:30-109): 26-neighbourhood connected components by
  min-label propagation to the fixpoint.  Each label is the flat id of
  its component's minimum voxel.
* recognizePD (tgrs.cpp:125-139): cluster bbox gates
  min_z <= -(sensor_height - 0.2) and max_z + sensor_height <= PD_HEIGHT.
* trackPD (tgrs.cpp:141-212): project the PD voxel centers into the
  previous frame; a cluster whose 27-neighbourhood overlap with the
  previous occupancy is <= HD_RATIO (0.7) is HD (dynamic).
* the K-frame world-occupancy appearance test (dyn_track_mode=
  "appearance") and the inspection dumps, host numpy as in the reference.

Translation notes:
* the 3x3x3 window of `reduce_window` ("SAME" padding, identity fill) is
  three separable passes of neighbour minima (maxima for the dilation)
  on the integer grid, the out-of-grid neighbours left out;
* cluster_grid runs a pointer-jumping step (`lab = lab[lab]`) after each
  window sweep.  Labels only fall and always name a voxel of their own
  component, so the fixpoint is the same component minimum the
  reference's plain sweeps reach, in fewer sweeps; convergence is read on
  the host once every _CHECK_EVERY sweeps (a block of sweeps that changed
  nothing is the fixpoint);
* `.at[key].min/max` are `scatter_reduce_` amin/amax (order-free), the
  integer `.at[].add` counts are `bincount`;
* the voxel-center table is computed once on the host in numpy f32 (the
  reference's f32 centers) and copied to the device, so every device
  holds the same centers;
* the polar bins are computed as XLA compiles them (utils/xla_math.py).
"""

from __future__ import annotations

import functools
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..utils import se3
from ..utils.device import to_host
from ..utils.xla_math import div_const, hypot

__all__ = ["SSCParams", "SSCGrid", "encode_scan", "cluster_grid",
           "recognize_pd", "track_pd", "dynamic_removal_masks",
           "world_voxel_keys", "appearance_dynamic_mask",
           "point_labels", "cluster_colors", "save_cluster_cloud",
           "cluster_stats"]

_DEG = 180.0 / math.pi
_CHECK_EVERY = 4  # cluster_grid's window sweeps between host reads


class SSCParams(NamedTuple):
    # tgrs.h:9-30
    sensor_height: float = 0.4
    min_dis: float = 1.0
    max_dis: float = 50.0
    min_azimuth: float = -30.0  # degrees (elevation angle)
    max_azimuth: float = 60.0
    range_res: float = 0.25
    sector_res: float = 2.0  # degrees
    azimuth_res: float = 3.0  # degrees
    hd_ratio: float = 0.7
    max_clusters: int = 512

    @property
    def range_num(self) -> int:
        return math.ceil((self.max_dis - self.min_dis) / self.range_res)

    @property
    def sector_num(self) -> int:
        return math.ceil(360.0 / self.sector_res)

    @property
    def azimuth_num(self) -> int:
        return math.ceil((self.max_azimuth - self.min_azimuth)
                         / self.azimuth_res)

    @property
    def pd_height(self) -> float:
        return self.sensor_height + 0.5


class SSCGrid(NamedTuple):
    occ: torch.Tensor  # (A, R, S) bool
    labels: torch.Tensor  # (A, R, S) int32 cluster label per voxel (-1 empty)
    pt_voxel: torch.Tensor  # (N,) flat voxel id per point (-1 invalid)
    pt_valid: torch.Tensor  # (N,)


class _ClusterStats(threading.local):
    """Sweeps and host reads of the cluster_grid calls on this thread."""

    def __init__(self):
        self.calls = self.sweeps = self.reads = 0

    def reset(self) -> None:
        self.calls = self.sweeps = self.reads = 0


cluster_stats = _ClusterStats()


def _polar_bins(pts: torch.Tensor, prm: SSCParams):
    x, y, zc = pts[:, 0], pts[:, 1], pts[:, 2]
    dis = hypot(x, y)
    ang = torch.atan2(y, x) * _DEG
    ang = torch.where(ang < 0, ang + 360.0, ang)
    azi = torch.atan2(zc, torch.clamp(dis, min=1e-9)) * _DEG
    ri = torch.ceil(div_const(dis - prm.min_dis, prm.range_res)).to(
        torch.int32) - 1
    si = torch.ceil(div_const(ang, prm.sector_res)).to(torch.int32) - 1
    ai = torch.ceil(div_const(azi - prm.min_azimuth, prm.azimuth_res)).to(
        torch.int32) - 1
    ok = ((dis >= prm.min_dis) & (dis <= prm.max_dis)
          & (azi >= prm.min_azimuth) & (azi <= prm.max_azimuth))
    ri = torch.clamp(ri, 0, prm.range_num - 1)
    si = torch.clamp(si, 0, prm.sector_num - 1)
    ai = torch.clamp(ai, 0, prm.azimuth_num - 1)
    return ri.long(), si.long(), ai.long(), ok


def encode_scan(pts: torch.Tensor, valid: torch.Tensor,
                prm: SSCParams = SSCParams()) -> SSCGrid:
    """Build the curved-voxel occupancy grid of the non-ground cloud
    (makeApriVec + makeHashCloud, tgrs.h:117-185)."""
    A, R, S = prm.azimuth_num, prm.range_num, prm.sector_num
    V = A * R * S
    ri, si, ai, ok = _polar_bins(pts, prm)
    ok = ok & valid
    flat = torch.where(ok, (ai * R + ri) * S + si, V)
    occ = torch.zeros(V + 1, dtype=torch.bool, device=pts.device)
    occ[flat] = True
    return SSCGrid(
        occ=occ[:V].reshape(A, R, S),
        labels=torch.full((A, R, S), -1, dtype=torch.int32,
                          device=pts.device),
        pt_voxel=torch.where(ok, flat, -1).to(torch.int32),
        pt_valid=ok,
    )


def _window_reduce(x: torch.Tensor, op) -> torch.Tensor:
    """The 3x3x3 window reduction (min or max) of an (A, R, S) grid with
    the out-of-grid cells ignored ("SAME" padding with the identity), as
    three separable passes of neighbour reductions along each axis."""
    for dim in range(3):
        n = x.shape[dim]
        out = x.clone()
        lo, hi = out.narrow(dim, 1, n - 1), out.narrow(dim, 0, n - 1)
        lo.copy_(op(lo, x.narrow(dim, 0, n - 1)))
        hi.copy_(op(hi, x.narrow(dim, 1, n - 1)))
        x = out
    return x


def cluster_grid(grid: SSCGrid, prm: SSCParams = SSCParams(),
                 max_iters: int = 128) -> SSCGrid:
    """26-neighbourhood connected components by min-label propagation
    (cluster, tgrs.cpp:30-109), iterated to the fixpoint whatever the
    component's length.  Labels are flat voxel ids of the component
    minimum; empty voxels stay -1.  max_iters is accepted and unread, as
    in the reference; convergence is read on the host once every
    _CHECK_EVERY sweeps."""
    A, R, S = grid.occ.shape
    V = A * R * S
    big = V + 1
    ids = torch.arange(V, device=grid.occ.device,
                       dtype=torch.int32).reshape(A, R, S)
    lab = torch.where(grid.occ, ids, big)
    cluster_stats.calls += 1
    while True:
        before = lab
        for _ in range(_CHECK_EVERY):
            lab = torch.where(grid.occ, _window_reduce(lab, torch.minimum),
                              big)
            ptr = torch.clamp(lab.reshape(-1), max=V - 1).long()
            lab = torch.where(grid.occ, lab.reshape(-1)[ptr].reshape(A, R, S),
                              big)
            cluster_stats.sweeps += 1
        cluster_stats.reads += 1
        if not to_host(torch.any(lab != before)):
            break
    return grid._replace(labels=torch.where(grid.occ, lab, -1))


@functools.lru_cache(maxsize=8)
def _voxel_centers(prm: SSCParams, device) -> torch.Tensor:
    """Centers of all voxels (A, R, S, 3) in f32 (makeHashCloud,
    tgrs.h:172-178), computed on the host and copied to `device`."""
    A, R, S = prm.azimuth_num, prm.range_num, prm.sector_num
    f32 = np.float32
    ri = np.arange(R, dtype=f32)
    si = np.arange(S, dtype=f32)
    ai = np.arange(A, dtype=f32)
    rc = (ri * 2 + 1) / f32(2) * f32(prm.range_res) + f32(prm.min_dis)
    sc = np.radians((si * 2 + 1) / f32(2) * f32(prm.sector_res))
    ac = np.radians((ai * 2 + 1) / f32(2) * f32(prm.azimuth_res)
                    + f32(prm.min_azimuth))
    x = rc[None, :, None] * np.cos(sc)[None, None, :]
    y = rc[None, :, None] * np.sin(sc)[None, None, :]
    z = rc[None, :, None] * np.tan(ac)[:, None, None]
    c = np.stack(np.broadcast_arrays(x, y, z), axis=-1).astype(f32)
    return torch.as_tensor(c, device=device)


def recognize_pd(grid: SSCGrid, prm: SSCParams = SSCParams()) -> torch.Tensor:
    """Per-voxel bool: belongs to a potentially-dynamic (PD) cluster
    (recognizePD, tgrs.cpp:125-139): cluster bbox of voxel centers with
    min_z <= -(h-0.2) and max_z + h <= PD_HEIGHT."""
    A, R, S = grid.occ.shape
    V = A * R * S
    cz = _voxel_centers(prm, grid.occ.device)[..., 2].reshape(-1)
    lab = grid.labels.reshape(-1).long()
    # labels are component-min flat voxel ids: a V-sized scatter gives
    # exact per-cluster reductions
    key = torch.where(lab >= 0, lab, V)
    zmin = torch.full((V + 1,), math.inf, dtype=cz.dtype, device=cz.device)
    zmin.scatter_reduce_(0, key, torch.where(lab >= 0, cz, math.inf), "amin")
    zmax = torch.full((V + 1,), -math.inf, dtype=cz.dtype, device=cz.device)
    zmax.scatter_reduce_(0, key, torch.where(lab >= 0, cz, -math.inf),
                         "amax")
    is_pd = (zmin <= -(prm.sensor_height - 0.2)) & (
        zmax + prm.sensor_height <= prm.pd_height)
    pd = torch.where(lab >= 0, is_pd[torch.clamp(key, max=V - 1)], False)
    return pd.reshape(A, R, S)


def track_pd(prev: SSCGrid, rel_pose: torch.Tensor, grid: SSCGrid,
             pd_mask: torch.Tensor, prm: SSCParams = SSCParams()
             ) -> torch.Tensor:
    """Classify PD clusters as HD (dynamic) or AS (static)
    (trackPD, tgrs.cpp:141-212).

    rel_pose: T_prev <- next (trans_pre^-1 * trans_next).  Each PD voxel
    center of `grid` is projected into the previous frame; a projection
    "hits" when any voxel in its 27-neighbourhood was occupied in `prev`.
    Per-cluster overlap ratio <= hd_ratio => dynamic.

    Returns per-voxel bool: voxel belongs to a DYNAMIC (HD) cluster.
    """
    A, R, S = grid.occ.shape
    V = A * R * S
    dev = grid.occ.device
    centers = _voxel_centers(prm, dev).reshape(-1, 3)
    dt = torch.promote_types(rel_pose.dtype, centers.dtype)
    proj = se3.apply(rel_pose.to(dt), centers.to(dt))
    ri, si, ai, ok = _polar_bins(proj, prm)

    # 27-neighbourhood occupancy of prev: dilate prev.occ once
    occ_dil = _window_reduce(prev.occ, torch.logical_or)
    hit = ok & occ_dil[ai, ri, si]

    lab = grid.labels.reshape(-1).long()
    pdv = pd_mask.reshape(-1) & (lab >= 0)
    key = torch.where(pdv, lab, V)
    n_all = torch.bincount(key, minlength=V + 1)
    n_hit = torch.bincount(torch.where(pdv & hit, lab, V), minlength=V + 1)
    ratio = n_hit.to(torch.float64) / torch.clamp(n_all, min=1).to(
        torch.float64)
    hd_lab = (ratio <= prm.hd_ratio) & (n_all > 0)
    hd = pdv & hd_lab[torch.clamp(key, max=V - 1)]
    return hd.reshape(A, R, S)


def dynamic_removal_masks(pts: torch.Tensor, valid: torch.Tensor,
                          ground_mask: torch.Tensor,
                          prev_grid: SSCGrid | None, rel_pose: torch.Tensor,
                          prm: SSCParams = SSCParams()):
    """Full per-scan dynamic-removal step.

    Returns (static_mask (N,), grid) — static = ground + points of
    non-dynamic clusters (cloud_nd assembly, tgrs.cpp:203-208).  With no
    previous frame every PD cluster is kept (nothing can be tracked yet).
    """
    ng = valid & ~ground_mask
    grid = cluster_grid(encode_scan(pts, ng, prm), prm)
    pd = recognize_pd(grid, prm)
    if prev_grid is None:
        hd = torch.zeros_like(pd)
    else:
        hd = track_pd(prev_grid, rel_pose, grid, pd, prm)
    pv = grid.pt_voxel.long()
    pt_dynamic = grid.pt_valid & (pv >= 0) & hd.reshape(-1)[
        torch.clamp(pv, min=0)]
    static = valid & (ground_mask | ~pt_dynamic)
    return static, grid


# -- K-frame world-occupancy appearance test (dyn_track_mode="appearance") -
#
# The reference's trackPD tests 27-neighbourhood overlap against ONE
# previous frame in the sensor frame; at 10 Hz a 1-2 m/s mover stays
# inside that slack.  The appearance test accumulates the WORLD-frame
# fine-voxel occupancy of the last K scans and asks, per cluster, what
# fraction of its points' world voxels were occupied ~2 s ago (a mover's
# current location was largely free space then), with a range gate and a
# two-tier decision (the reference package's round-5 tuning: P 0.907 /
# R 0.502 / F1 0.647 on its labelled moving-sensor run).  Host numpy.

@functools.lru_cache(maxsize=1)
def _nb27_offsets() -> np.ndarray:
    """27-neighbourhood key deltas under the packed-key encoding."""
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                out.append((np.int64(dx) << 42)
                           ^ ((np.int64(dy) & 0x1FFFFF) << 21)
                           ^ (np.int64(dz) & 0x1FFFFF))
    return np.asarray(out, np.int64)


def world_voxel_keys(pts_w, voxel: float) -> np.ndarray:
    """Packed int64 voxel key per world point (host numpy)."""
    ijk = np.floor(np.asarray(pts_w) / voxel).astype(np.int64)
    return ((ijk[:, 0] << 42)
            ^ ((ijk[:, 1] & 0x1FFFFF) << 21)
            ^ (ijk[:, 2] & 0x1FFFFF))


def appearance_dynamic_mask(keys, scored, band, lab_pt, old_sorted,
                            thr_strong: float = 0.55,
                            thr_weak: float = 0.9,
                            min_cnt: int = 4,
                            min_scored_frac: float = 0.6) -> np.ndarray:
    """Per-point dynamic mask from the cluster appearance ratios.

    keys: (N,) world voxel keys; scored: (N,) bool — points eligible for
    scoring (in the curved-voxel band, clustered, inside both range
    gates); band: (N,) bool — the removal scope (a strong cluster is
    removed across the whole band, including its out-of-gate tail);
    lab_pt: (N,) cluster label per point (-1 unclustered);
    old_sorted: SORTED unique key array of the old frames' union.

    occupancy = any of the point's 27-neighbourhood keys present in the
    old union.  Per cluster (over its scored points, required to be >=
    min_scored_frac of the whole cluster and >= min_cnt):
      frac < thr_strong  -> remove the whole cluster
      frac < thr_weak    -> remove only its occupancy-negative points
    """
    N = len(keys)
    dyn = np.zeros(N, bool)
    bidx = np.where(scored)[0]
    if len(bidx) == 0 or len(old_sorted) == 0:
        return dyn
    q = keys[bidx][:, None] + _nb27_offsets()[None, :]
    pos = np.searchsorted(old_sorted, q)
    hit = old_sorted[np.minimum(pos, len(old_sorted) - 1)] == q
    occ = hit.any(axis=1)

    labs = lab_pt[bidx]
    uniq, inv = np.unique(labs, return_inverse=True)
    n_scored = np.bincount(inv).astype(np.float64)
    n_occ = np.zeros(len(uniq))
    np.add.at(n_occ, inv, occ)
    # full cluster sizes (scored or not) for the coverage gate
    fu, fc = np.unique(lab_pt[lab_pt >= 0], return_counts=True)
    n_tot = fc[np.searchsorted(fu, uniq)]
    frac = n_occ / n_scored
    gate = (n_scored >= min_cnt) & (n_scored >= min_scored_frac * n_tot)
    strong = (frac < thr_strong) & gate
    weak = (frac < thr_weak) & gate & ~strong
    if strong.any():
        dyn |= np.isin(lab_pt, uniq[strong]) & band
    if weak.any():
        inweak = np.isin(lab_pt, uniq[weak])
        fresh = np.zeros(N, bool)
        fresh[bidx] = ~occ
        dyn |= inweak & fresh
    return dyn


# -- inspection dumps (saveColorCloud analog, tgrs.cpp:214-243) -----------

def point_labels(grid: SSCGrid) -> np.ndarray:
    """(N,) int cluster label per point (-1 for non-clustered rows), on
    the host."""
    valid = grid.pt_valid.cpu().numpy()
    lab = grid.labels.reshape(-1).cpu().numpy()
    pv = np.where(valid, grid.pt_voxel.cpu().numpy(), 0)
    return np.where(valid, lab[pv], -1)


def cluster_colors(labels) -> np.ndarray:
    """Deterministic RGB per cluster label (the reference's rand()%255
    per channel, tgrs.cpp:214-243, as a multiplicative hash).  Label -1
    (unclustered) renders mid-gray."""
    lab = np.asarray(labels, np.int64)
    h = (lab * 2654435761) & 0xFFFFFFFF
    rgb = np.stack([64 + (h & 0x7F), 64 + ((h >> 7) & 0x7F),
                    64 + ((h >> 14) & 0x7F)], -1).astype(np.uint8)
    rgb[lab < 0] = 128
    return rgb


def save_cluster_cloud(path: str, pts, grid: SSCGrid) -> int:
    """Write the cluster-colored curved-voxel cloud as a PCL-convention
    packed-rgb PCD (tgrs.cpp saveColorCloud; object_update.cpp:155).
    Returns the number of points written."""
    from ..io.pcd import write_pcd_fields
    from .colorize import pack_rgb_float

    valid = grid.pt_valid.cpu().numpy()
    labels = point_labels(grid)
    rgb = cluster_colors(labels[valid])
    xyz = np.asarray(pts)[valid].astype(np.float32)
    data = np.concatenate([xyz, pack_rgb_float(rgb)[:, None]], axis=1)
    write_pcd_fields(path, ["x", "y", "z", "rgb"], data)
    return int(valid.sum())
