"""Multi-device sharding: distributed measurement reduction, the SPMD
window step, the ownership-sharded map and the distributed back end.

Port of better_fastlio2_tpu/parallel/sharded.py.  The reference runs each
function as a `jax.shard_map` program over a `jax.sharding.Mesh`; here
every rank is one process of a torch.distributed group and the mesh is
parallel.collectives.Mesh, with psum / all_gather / axis_index /
ppermute as thin torch.distributed calls (see that module for the rules
every caller keeps: the same collectives in the same order on every rank,
identity collectives at size 1, NCCL inside CUDA graphs, gloo staging CUDA
tensors through the host).  The reference's functions return a program;
the ports return a function that runs one rank's share.  Where the
reference stacks D local tables on a leading (D, ...) axis sharded
one-per-device, each rank here holds its own local table, and rank r's
table is the reference's [r].

  dp — scan points sharded across ranks for the point-to-plane rows (the
       OpenMP-for of laserMapping.cpp:1883-1886, SURVEY.md P1): each rank
       reduces its rows to the normal equations and a psum gives the
       global ones before the replicated solve.
  fp — pose-graph factors sharded across ranks for the back end's GN
       (SURVEY.md P7): each rank sums its factors' J^T W J v, a psum
       merges.

The SPMD window step (make_spmd_window_step_fn, LIOPipeline(mesh=)) keeps
the map replicated; the ownership-sharded map (make_sharded_map ...
make_sharded_step_fn) and the slab-sharded map with its ring migration
(sharded_slab_*) split the table across the ranks instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import posegraph as pg
from ..core import esikf, imu, measurement
from ..core.esikf import MeasurementOut
from ..core.state import ERR_DIM
from ..map import voxel_hash
from ..ops.downsample import voxel_downsample
from ..ops.kernels import fused_hth
from ..utils import se3, so3
from ..utils.device import nonzero_static
from .collectives import Mesh, all_gather, axis_index, make_mesh, ppermute, psum

__all__ = [
    "Mesh",
    "make_mesh",
    "psum",
    "all_gather",
    "axis_index",
    "ppermute",
    "sharded_hth_reduce",
    "sharded_update_step",
    "sharded_posegraph_hvp",
    "sharded_gn_step",
    "make_sharded_map",
    "sharded_map_insert",
    "sharded_map_knn",
    "make_sharded_step_fn",
    "make_spmd_window_step_fn",
    "slab_owner",
    "sharded_slab_insert",
    "sharded_slab_migrate",
    "comm_volume_per_scan",
    "spmd_comm_volume_per_scan",
]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def sharded_hth_reduce(mesh: Mesh):
    """reduce(h_x (N_r, 12), h (N_r,), mask (N_r,)) of this rank's rows ->
    (HtH (12, 12), Hth (12,)) summed over the ranks.  The products are
    matmuls, as in the reference (no Pallas kernel there)."""

    def reduce(h_x, h, mask):
        w = mask.to(h_x.dtype)
        hx = h_x * w[:, None]
        return psum(hx.T @ hx, mesh), psum(hx.T @ (h * w), mesh)

    return reduce


def sharded_update_step(mesh: Mesh, cfg=None):
    """One ESIKF measurement iteration with the points sharded over the
    ranks: update(x, P, m, pts (N_r, 3), valid (N_r,)) -> (dx (23,),
    n_valid).  The map is replicated (no dense index: the probe path);
    each rank runs 5-NN, plane fit and rows on its points, the normal
    equations are summed, and the small solve runs replicated.  n_valid
    is this rank's own count of selected rows (the reference's replicated
    out_spec hands back device 0's)."""

    def update(x, P_, m, pts, valid):
        p_imu = so3.quat_rotate(x.off_r, pts) + x.off_t
        p_world = so3.quat_rotate(x.rot, p_imu) + x.pos
        nb, d2, ok = voxel_hash.knn(m, p_world, k=5, chunk=pts.shape[0])
        nn_ok = (torch.all(ok, dim=-1)
                 & (d2[:, 4] <= measurement.MAX_NN_DIST2) & valid)
        n, d, plane_ok = measurement.plane_fit(nb, nn_ok)
        pd2 = torch.sum(n * p_world, dim=-1) + d
        srob = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(
            torch.clamp(torch.linalg.vector_norm(pts, dim=-1), min=1e-8))
        sel = plane_ok & (srob > measurement.ROBUST_S_GATE)
        C = so3.quat_inv_rotate(x.rot, n)
        z = torch.zeros_like(n)
        h_x = torch.cat([n, torch.linalg.cross(p_imu, C), z, z], dim=-1)
        w = sel.to(h_x.dtype)
        hx = h_x * w[:, None]
        HtH = psum(hx.T @ hx, mesh)
        Hth = psum(hx.T @ (-pd2 * w), mesh)
        # replicated small solve: dx = (HtH + (P/R)^-1)^-1 Hth
        R = 0.001
        eyeP = torch.eye(ERR_DIM, dtype=P_.dtype, device=P_.device)
        S_inv = torch.cholesky_solve(eyeP, torch.linalg.cholesky(P_ / R))
        A = S_inv.clone()
        A[:12, :12] += HtH
        rhs = torch.zeros(ERR_DIM, dtype=P_.dtype, device=P_.device)
        rhs[:12] = Hth
        return torch.linalg.solve(A, rhs), torch.sum(w)

    return update


# ---------------------------------------------------------------------------
# Ownership-sharded voxel map (SURVEY.md P3): every voxel is owned by one
# rank, a pure function of its coords (an independent hash, so ownership
# and slot placement decorrelate); each rank holds a full-size local table
# of the voxels it owns, so aggregate capacity grows with the rank count.
#   insert: the batch is replicated; each rank inserts the rows it owns.
#           No communication.
#   kNN:    each rank searches the neighbourhood cells it owns, keeps a
#           per-query top-k, and an all_gather + stable re-top-k merges
#           the partials.  The union of the ranks' cells is the whole
#           neighbourhood, so the merge equals the one-table search.
# ---------------------------------------------------------------------------


def _signed32(v: torch.Tensor) -> torch.Tensor:
    """The int32 value (sign-extended in int64) of the low 32 bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v)


_OWNER_C = tuple(int(np.uint32(c).astype(np.int32))
                 for c in (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D))


def _owner_of(ijk: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Owning rank of a voxel coord, bit-exact with the reference's
    int32 wrap-around hash (run in int64 and wrapped: torch's int32
    overflow is not defined)."""
    i = ijk.to(torch.int64)
    h = (_signed32(i[..., 0] * _OWNER_C[0]) ^ _signed32(i[..., 1] * _OWNER_C[1])
         ^ _signed32(i[..., 2] * _OWNER_C[2]))
    h = (h ^ (h >> 13)) & 0x7FFFFFFF
    return h % n_dev


def make_sharded_map(mesh: Mesh, capacity_log2_per_dev: int = 18,
                     bucket: int = 4, voxel_size: float = 0.5,
                     dtype=torch.float32,
                     moments: bool = False) -> voxel_hash.VoxelHashMap:
    """This rank's empty local table of the ownership-sharded map, on the
    mesh's device (no dense index: the probe path; moments=True for
    make_sharded_step_fn)."""
    return voxel_hash.make_map(
        capacity_log2=capacity_log2_per_dev, bucket=bucket,
        voxel_size=voxel_size, dtype=dtype, device=mesh.device,
        dense_log2=None, moments=moments)


def sharded_map_insert(mesh: Mesh, max_probe: int = 16):
    """insert(m, pts_world (N, 3) replicated, valid (N,)) -> m: this rank
    inserts the rows whose voxel it owns into its table (in place, as
    voxel_hash.insert).  No communication."""

    def insert(m, pts_world, valid):
        ijk = voxel_hash._voxel_of(pts_world, m.voxel_size)
        mine = valid & (_owner_of(ijk, mesh.size) == mesh.rank)
        return voxel_hash.insert(m, pts_world, mine, max_probe=max_probe)

    return insert


def _local_knn_merge(m, q, mesh: Mesh, k: int = 5, max_probe: int = 16,
                     n_neighbors: int = 27):
    """k-NN of the replicated queries `q` against the ownership-sharded
    map: a top-k over the cells this rank owns, then an all_gather of
    every rank's partials and a stable re-top-k (ties to the lower rank,
    then the lower partial index, as lax.top_k).  Exact against the
    one-table search."""
    offs = voxel_hash._neighbor_offsets(n_neighbors, q.device)
    N, NB, B, D = q.shape[0], offs.shape[0], m.bucket, mesh.size
    BIG = 1e17
    nb = voxel_hash._voxel_of(q, m.voxel_size)[:, None, :] + offs[None]
    mine = _owner_of(nb, D) == mesh.rank
    slots = voxel_hash._lookup_slots(m.key, nb.reshape(-1, 3),
                                     max_probe).reshape(N, NB)
    slots = torch.where(mine, slots, -1)
    cand = m.points[torch.clamp(slots, min=0)]  # (N, NB, B, 3)
    d2 = torch.sum((cand - q[:, None, None, :]) ** 2, dim=-1)
    d2 = torch.where(slots[..., None] >= 0, d2, BIG)
    neg, top_i = voxel_hash._top_k(-d2.reshape(N, NB * B), k)
    pts_k = torch.gather(cand.reshape(N, NB * B, 3), 1,
                         top_i[..., None].expand(N, k, 3))
    # (D, N, k) partials -> per query the top k of D * k
    all_d2 = all_gather(-neg, mesh).reshape(D, N, k)
    all_pts = all_gather(pts_k, mesh).reshape(D, N, k, 3)
    all_d2 = all_d2.permute(1, 0, 2).reshape(N, D * k)
    all_pts = all_pts.permute(1, 0, 2, 3).reshape(N, D * k, 3)
    negm, mi = voxel_hash._top_k(-all_d2, k)
    d2m = -negm
    ptsm = torch.gather(all_pts, 1, mi[..., None].expand(N, k, 3))
    return ptsm, d2m, d2m < BIG


def sharded_map_knn(mesh: Mesh, k: int = 5, max_probe: int = 16,
                    n_neighbors: int = 27):
    """knn(m, queries (N, 3) replicated) -> (neighbors (N, k, 3), d2 (N, k),
    ok (N, k)), the same on every rank: the multi-device Nearest_Search."""

    def knn(m, q):
        return _local_knn_merge(m, q, mesh, k=k, max_probe=max_probe,
                                n_neighbors=n_neighbors)

    return knn


def make_sharded_step_fn(cfg, mesh: Mesh):
    """The full multi-device scan tick with the points data-parallel AND
    the map ownership-sharded (reference :299-469).

    Per rank r of D: its n_raw / D raw rows (undistortion and the
    downsample to n_ds / D rows are local), its local table of the voxels
    it owns (make_sharded_map), and the filter state, IMU batch and cube
    replicated.  Communication per scan:
      - an all_gather of the downsampled shards as int16 positions, with
        a scale from det_range (max(1.1 det_range, 120 m) / 32767; invalid
        rows gather as 0, the valid mask beside them);
      - the association: a psum of the (n_ds, 10) moment partials (each
        rank blends the neighbourhood cells it owns; the sums add), or
        with use_knn the 5-NN all_gather merge (the warmup while the
        moments densify);
      - per ESIKF pass, the 6-column normal equations of this rank's
        n_ds / D rows from K2 (ops/kernels.fused_hth) with HTH / HTh /
        n_valid psum'd (esikf.update_iterated(psum=mesh)).
    Then each rank inserts the rows it owns and crops its table to the
    cube.

    Returns step(x, P, m, pts, pt_t, pt_valid, imu_b, last_end_rel,
    scan_end_t, acc_norm, cube_lo, cube_hi, last_acc_w, last_gyr_b,
    use_knn) -> (x', P', m', tail (2, 3): the scan's terminal world
    acceleration and bias-corrected gyro, fed back next scan).  use_knn
    is a host bool, the same on every rank (the reference's lax.cond
    flag): both association programs run collectives, so only the
    taken one may run."""
    D, sh, mp = mesh.size, cfg.shapes, cfg.mapping
    dtype = _DTYPES[cfg.dtype]
    dev = mesh.device
    if sh.n_raw % D or sh.n_ds % D:
        raise ValueError(f"n_raw {sh.n_raw} and n_ds {sh.n_ds} must divide "
                         f"by the {D} ranks")
    n_loc = sh.n_ds // D
    Q = imu.build_Q(mp.gyr_cov, mp.acc_cov, mp.b_gyr_cov, mp.b_acc_cov,
                    dtype, dev)
    # the int16 gather's step, sized to the sensor range (8 mm at 260 m)
    pos_scale = torch.tensor(max(1.1 * mp.det_range, 120.0) / 32767.0,
                             dtype=dtype, device=dev)
    me = mesh.rank

    def owned(nb):
        return _owner_of(nb, D) == me

    def step(x, P_, m, pts, pt_t, pt_valid, imu_b, last_end_rel,
             scan_end_t, acc_norm, cube_lo, cube_hi, last_acc_w,
             last_gyr_b, use_knn):
        x_prop, P_prop, poses, pts_body = imu.stage(
            x, P_, imu_b, Q, acc_norm, last_end_rel, scan_end_t,
            last_acc_w, last_gyr_b, pts, pt_t)
        ds_loc, dv_loc = voxel_downsample(pts_body, pt_valid,
                                          mp.surf_leaf_size, out_size=n_loc)
        ds_q = torch.clamp(torch.round(ds_loc / pos_scale), -32767,
                           32767).to(torch.int16)
        ds_all = all_gather(ds_q, mesh).to(dtype) * pos_scale
        dv_all = all_gather(dv_loc, mesh)
        sl = slice(me * n_loc, (me + 1) * n_loc)
        pts_s = ds_all[sl]
        sqrt_body = torch.sqrt(torch.clamp(
            torch.linalg.vector_norm(pts_s, dim=-1), min=1e-8))

        def search(p_world):
            if use_knn:
                nbp, d2, okk = _local_knn_merge(
                    m, p_world, mesh, k=5, max_probe=sh.map_max_probe)
                nn_ok = (torch.all(okk, dim=-1)
                         & (d2[:, 4] <= measurement.MAX_NN_DIST2) & dv_all)
                return measurement.plane_fit(nbp, nn_ok)
            sums, ijk = measurement.neighborhood_moment_sums(
                m, p_world, max_probe=sh.map_max_probe, cell_mask_fn=owned)
            return measurement.finalize_plane_from_sums(
                psum(sums, mesh), ijk, m.voxel_size, dv_all)

        def measure(s, converged, aux):
            if not aux.searched:  # once per scan, on the whole batch
                n, d, ok = search(measurement.transform_to_world(s, ds_all))
                aux = aux._replace(normal=n[sl], d=d[sl], fit_ok=ok[sl],
                                   searched=True)
            # this rank's rows, reduced by K2 (6 columns)
            p_rot = so3.quat_rotate(s.off_r, pts_s)
            p_imu = p_rot + s.off_t
            p_w = so3.quat_rotate(s.rot, p_imu) + s.pos
            pd2 = torch.sum(aux.normal * p_w, dim=-1) + aux.d
            sel = aux.fit_ok & (1.0 - 0.9 * torch.abs(pd2) / sqrt_body
                                > measurement.ROBUST_S_GATE)
            C = so3.quat_inv_rotate(s.rot, aux.normal)
            HTH, HTh = fused_hth(p_rot.contiguous(), p_imu.contiguous(),
                                 aux.normal.contiguous(), C.contiguous(),
                                 pd2.contiguous(), sel, extrinsic=False)
            return MeasurementOut(aux=aux, neq=(HTH[:6, :6], HTh[:6],
                                                torch.sum(sel.to(dtype))))

        aux0 = measurement.MeasureAux(
            normal=pts_s.new_zeros(n_loc, 3), d=pts_s.new_zeros(n_loc),
            fit_ok=torch.zeros(n_loc, dtype=torch.bool, device=dev),
            searched=False,
            assoc_ijk=torch.zeros(n_loc, 3, dtype=torch.int32, device=dev),
            refreshed=False)
        x_post, P_post, _, _ = esikf.update_iterated(
            x_prop, P_prop, measure, aux0,
            max_iter=cfg.ikdtree.max_iteration, n_cols=6, psum=mesh)

        # owner-masked insert, then the local FoV crop
        pts_world = measurement.transform_to_world(x_post, ds_all)
        ijk_all = voxel_hash._voxel_of(pts_world, m.voxel_size)
        m = voxel_hash.insert(m, pts_world, dv_all & owned(ijk_all),
                              max_probe=sh.map_max_probe)
        m = voxel_hash.crop_outside_box(m, cube_lo, cube_hi)
        tail = torch.stack([poses.acc_w[-1], poses.gyr_b[-1]])
        return x_post, P_post, m, tail

    return step


def make_spmd_window_step_fn(cfg, mesh: Mesh, window: int, ls_example,
                             plane_cache: bool | None = None,
                             unroll: int = 1,
                             override_ndev: int | None = None):
    """The production-parity multi-device window step (reference
    :472-542): the window of lio.make_window_step_fn with every tick one
    rank's program of the SPMD step (lio.make_step_fn(mesh=...)): the
    map and filter state replicated, undistortion on the rank's raw
    shard, association, plane finalize and the fused solve on its 1/D
    slice of the downsampled batch with the Gram psum'd every pass, and
    the dense-moment insert's arithmetic shared with an all_gather of the
    budgeted delta rows.  The body is the production step, so a one-rank
    mesh runs the production program plus identity collectives.

    `ls_example`: a live LIOState on this rank (its tensors must be on
    the mesh's device).  Returns wstep(ls, w, acc_norm) -> (ls', infos
    (window, 32)) with w a lio.WindowInputs whose pts / pt_t / pt_valid
    hold this rank's point rows; the ticks run one after the other
    (`unroll`, the reference's scan unroll, changes no result and is
    taken for its signature; LIOPipeline's `unroll` sets the ticks one
    CUDA graph holds).

    override_ndev (timing only): one rank runs the per-rank program of an
    override_ndev-rank mesh (1/D of the query slice and of the insert
    arithmetic, the replicated stages in full, the collectives over this
    mesh), so that one card measures T_serial + T_parallel / D.  Its
    results are 1/D-partial by construction."""
    from ..pipeline import lio

    bad = [t.device for t in _leaves(ls_example) if t.device != mesh.device]
    if bad:
        raise ValueError(f"ls_example lives on {bad[0]}, the mesh on "
                         f"{mesh.device}")
    step = lio.make_step_fn(cfg, mesh.device, plane_cache, mesh=mesh,
                            ndev=override_ndev)
    return lio._window_fn(lio._make_tick(cfg, step, quantized=False),
                          window)


def _leaves(a) -> list[torch.Tensor]:
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, tuple):
        return [t for x in a for t in _leaves(x)]
    return []


def spmd_comm_volume_per_scan(cfg, n_dev: int) -> dict:
    """Bytes each rank receives or sends for one scan of the SPMD window
    step (make_spmd_window_step_fn), ring accounting: an all_gather of
    global size S moves S (D - 1) / D per rank, a psum 2 S (D - 1) / D.
    Against the ownership-sharded tick (comm_volume_per_scan) the
    (n_ds, 10) moment-partial psum is gone (each rank reads its replica):
    the raw-point all_gather, the per-pass Gram / count psums and the
    insert's delta-row all_gather remain."""
    sh = cfg.shapes
    f = (n_dev - 1) / n_dev
    iters = cfg.ikdtree.max_iteration + 1  # worst-case ESIKF passes
    S_raw = sh.n_raw * 3 * 4  # undistorted f32 rows (exact gather)
    S_gram = 8 * 8 * 4 + 2 * 4  # Gram + n_moved / n_val scalars
    budget = max(sh.insert_mom_budget, 1024)
    S_ins = budget * (13 * 4 + 4)  # delta rows (DMOM_CH + pad) + dst idx
    vol = {
        "all_gather_raw_points_bytes": S_raw * f,
        "psum_gram_bytes": 2 * S_gram * f * iters,
        "all_gather_insert_delta_bytes": S_ins * f,
        "n_devices": n_dev,
    }
    vol["steady_total_bytes_per_scan"] = sum(
        v for k, v in vol.items() if k.endswith("_bytes"))
    return vol


# ---------------------------------------------------------------------------
# Slab ownership and ring migration (SURVEY.md P6): rank r owns the x-slabs
# with ((slab - shift) mod D) == r.  A query's neighbourhood spans at most
# two adjacent slabs, at the price of load skew where the points are
# anisotropic along x.  With `shift` fixed, a moving FoV needs no migration
# (entering slabs are claimed by their owner at the first insert, leaving
# ones are cropped locally).  Rotating `shift` by +1 hands every slab from
# rank r to r - 1: sharded_slab_migrate runs that handoff as ppermute steps
# (each rank compacts the rows it no longer owns into a fixed-size buffer,
# sends it to its ring predecessor, tombstones them, and bulk-inserts what
# it receives).  The production default is hash ownership, which never
# migrates.
# ---------------------------------------------------------------------------


def slab_owner(ijk: torch.Tensor, n_dev: int, shift,
               slab_log2: int = 4) -> torch.Tensor:
    """Owning rank of a voxel under x-slab partitioning: slabs of
    2^slab_log2 cells along x, assigned cyclically, rotated by `shift`."""
    return torch.remainder((ijk[..., 0] >> slab_log2) - shift, n_dev)


def sharded_slab_insert(mesh: Mesh, slab_log2: int = 4, max_probe: int = 16):
    """insert(m, shift, pts_world (N, 3) replicated, valid) -> m: this rank
    inserts the rows whose voxel it owns at `shift`."""

    def insert(m, shift, pts_world, valid):
        ijk = voxel_hash._voxel_of(pts_world, m.voxel_size)
        mine = valid & (slab_owner(ijk, mesh.size, shift, slab_log2)
                        == mesh.rank)
        return voxel_hash.insert(m, pts_world, mine, max_probe=max_probe)

    return insert


def _put_rows(a: torch.Tensor, dst: torch.Tensor, rows) -> torch.Tensor:
    """a.at[dst].set(rows, mode="drop") for distinct targets and sink
    targets == len(a): a copy with a sink row appended, written, cut."""
    out = torch.cat([a, a[:1]])
    out[dst] = rows
    return out[:a.shape[0]]


def sharded_slab_migrate(mesh: Mesh, slab_log2: int = 4, max_rows: int = 4096,
                         max_probe: int = 16):
    """One ring-migration step: slab ownership advances to `shift_new` (it
    was shift_new - 1) and the rows hand off to the ring predecessor.

    Returns migrate(m, shift_new) -> (m', n_left, bytes_moved, n_lost),
    the counts psum'd: n_left the rows still mis-owned after this step
    (more than max_rows on a rank: call again until 0), bytes_moved the
    payload of this step over all ranks, n_lost the received rows whose
    slot claim failed (the claim probes 4x deeper than a lookup: a lost
    row is lost map content)."""
    D = mesh.size
    perm = [(i, (i - 1) % D) for i in range(D)]

    def migrate(m, shift_new):
        me, C, B = mesh.rank, m.capacity, m.bucket
        has_mom = m.mom is not None
        live = (m.key & voxel_hash._LIVE_BIT) != 0
        coords = voxel_hash._voxel_of(m.points[:, 0, :], m.voxel_size)
        send = live & (slab_owner(coords, D, shift_new, slab_log2) != me)
        sel = nonzero_static(send, max_rows, C)
        act = sel < C
        safe = torch.clamp(sel, max=C - 1)
        b_coords = torch.where(act[:, None], coords[safe], 0)
        b_count = torch.where(act, m.count[safe], 0)
        b_pts = torch.where(act[:, None, None], m.points[safe],
                            voxel_hash._SENTINEL)
        b_mom = (torch.where(act[:, None], m.mom[safe], 0.0) if has_mom
                 else None)

        # tombstone the handed-off rows (chains stay walkable)
        dst = torch.where(act, sel, C)
        m = m._replace(
            key=_put_rows(m.key, dst, voxel_hash._KEY_TOMB),
            count=_put_rows(m.count, dst, 0),
            points=_put_rows(m.points, dst, voxel_hash._SENTINEL),
            mom=_put_rows(m.mom, dst, 0.0) if has_mom else None)

        # ring handoff: every mis-owned row's new owner is me - 1
        r_coords = ppermute(b_coords, mesh, perm)
        r_count = ppermute(b_count, mesh, perm)
        r_pts = ppermute(b_pts, mesh, perm)
        r_act = ppermute(act, mesh, perm)
        r_mom = ppermute(b_mom, mesh, perm) if has_mom else None

        # claim a slot per received voxel (its centre claims the right
        # cell), then write the rows whole: a receiver cannot hold these
        # voxels already (one owner per voxel)
        centers = (r_coords.to(m.points.dtype) + 0.5) * m.voxel_size
        m = voxel_hash.insert(m, centers, r_act, max_probe=4 * max_probe,
                              claim_only=True)
        slots = voxel_hash._lookup_slots(m.key, r_coords, 4 * max_probe)
        ok = r_act & (slots >= 0)
        sdst = torch.where(ok, slots, C)
        m = m._replace(
            count=_put_rows(m.count, sdst, r_count),
            points=_put_rows(m.points, sdst, r_pts),
            mom=_put_rows(m.mom, sdst, r_mom) if has_mom else None)

        n_sent = torch.sum(act.to(torch.int32))
        n_left = psum(torch.sum(send.to(torch.int32)) - n_sent, mesh)
        n_lost = psum(torch.sum((r_act & (slots < 0)).to(torch.int32)), mesh)
        # coords (3 int32) + count (1 int32) + bucket points + moments
        row_bytes = 12 + 4 + B * 3 * 4 + (40 if has_mom else 0)
        bytes_moved = psum(n_sent * row_bytes, mesh)
        return m, n_left, bytes_moved, n_lost

    return migrate


def comm_volume_per_scan(cfg, n_dev: int) -> dict:
    """Estimated bytes per rank for one scan of the ownership-sharded tick
    (make_sharded_step_fn), by collective (SURVEY.md §7.3), ring
    accounting as spmd_comm_volume_per_scan."""
    sh = cfg.shapes
    f = (n_dev - 1) / n_dev
    iters = cfg.ikdtree.max_iteration + 1  # worst-case ESIKF passes
    S_ds = sh.n_ds * 3 * 2  # int16 positions
    S_mom = sh.n_ds * 10 * 4
    k = 5
    S_knn = sh.n_ds * k * (4 + 12)  # d2 + points partial top-k
    S_gram = 8 * 8 * 4
    vol = {
        "all_gather_downsample_bytes": S_ds * f,
        "psum_moment_partials_bytes": 2 * S_mom * f,
        "all_gather_knn_merge_bytes": S_knn * f * n_dev,  # (D, N, k) gather
        "psum_normal_eqs_bytes": 2 * S_gram * f * iters,
        "n_devices": n_dev,
    }
    vol["steady_total_bytes_per_scan"] = (
        vol["all_gather_downsample_bytes"]
        + vol["psum_moment_partials_bytes"]
        + vol["psum_normal_eqs_bytes"])
    vol["warmup_total_bytes_per_scan"] = (
        vol["all_gather_downsample_bytes"]
        + vol["all_gather_knn_merge_bytes"]
        + vol["psum_normal_eqs_bytes"])
    return vol


def _factor_products(poses, bw_i, bw_j, bw_meas, bw_w):
    """(Ji, Jj, e, seg, Jv-product function) of this rank's factors: the
    Jacobian blocks, residuals, the sorted segment sum over the poses
    (backend/posegraph._SegmentSum: the same bits every run) and
    JTWJ(v), the factors' sum of J^T W J v."""
    K = poses.shape[0]
    e, Ji, Jj = pg._between_residual_jac(poses, bw_i, bw_j, bw_meas)
    bi, bj = bw_i.long(), bw_j.long()
    seg = pg._SegmentSum([bw_i, bw_j], K)

    def jtwj(v):
        Jv = (torch.einsum("fab,fb->fa", Ji, v[bi])
              + torch.einsum("fab,fb->fa", Jj, v[bj]))
        WJv = bw_w * Jv
        return seg([torch.einsum("fab,fa->fb", Ji, WJv),
                    torch.einsum("fab,fa->fb", Jj, WJv)])

    return Ji, Jj, e, seg, jtwj


def sharded_posegraph_hvp(mesh: Mesh):
    """hvp(poses (K, 7) replicated, bw_i, bw_j, bw_meas, bw_w: this rank's
    factor shard, v (K, 6)) -> H v summed over the ranks: the pose-graph
    CG's product with the factors sharded."""

    def hvp(poses, bw_i, bw_j, bw_meas, bw_w, v):
        return psum(_factor_products(poses, bw_i, bw_j, bw_meas,
                                     bw_w)[4](v), mesh)

    return hvp


def sharded_gn_step(mesh: Mesh, cg_iters: int = 10):
    """step(poses, bw_i, bw_j, bw_meas, bw_w (this rank's factors),
    prior_w) -> poses': one Gauss-Newton step over a between-factor graph
    (residuals, right-hand side and `cg_iters` CG iterations) with the
    factors sharded and a psum per product; pose 0 is held by the gauge
    prior of weight prior_w."""

    def step(poses, bw_i, bw_j, bw_meas, bw_w, prior_w):
        Ji, Jj, e, seg, jtwj = _factor_products(poses, bw_i, bw_j, bw_meas,
                                                bw_w)
        # the gauge prior's residual is zero (it holds pose 0 where it is)
        b = -psum(seg([torch.einsum("fab,fa->fb", Ji, bw_w * e),
                       torch.einsum("fab,fa->fb", Jj, bw_w * e)]), mesh)

        def hvp(v):
            out = psum(jtwj(v), mesh)
            out[0] += prior_w * v[0]
            return out + 1e-6 * v

        x = torch.zeros_like(b)
        r, p = b, b
        rr = torch.sum(b * b)
        for _ in range(cg_iters):
            Ap = hvp(p)
            alpha = rr / torch.clamp(torch.sum(p * Ap), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            rr_new = torch.sum(r * r)
            p = r + (rr_new / torch.clamp(rr, min=1e-20)) * p
            rr = rr_new
        new_t = se3.trans(poses) + x[:, 0:3]
        new_q = so3.quat_normalize(so3.quat_multiply(
            se3.rot(poses), so3.quat_exp(x[:, 3:6])))
        return se3.make(new_q, new_t)

    return step
