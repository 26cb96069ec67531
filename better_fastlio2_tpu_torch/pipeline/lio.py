"""LIO odometry pipeline — one scan tick of the mapping main loop.

Port of better_fastlio2_tpu/pipeline/lio.py (laserMapping.cpp:2225-2460):

    IMU forward propagation + undistortion      (ImuProcess::Process)
    moving-FoV map crop                         (lasermap_fov_segment)
    scan voxel downsample                       (VoxelGrid, :2322)
    iterated ESIKF point-to-plane update        (update_iterated_dyn_share_modified)
    map incremental insert                      (map_incremental)

The JAX reference runs the tick as one jitted device program, and a
window of W ticks as one program (lax.scan).  Here the tick is PyTorch
on the chosen device, and every program branches on the device: the
update gate, the ESIKF passes of both gain paths, the re-association and
lazy-refresh gates and the hash map's probe and claim rounds are device
selects or fixed predicated rounds, so a tick reads nothing on the host.
On CUDA each program runs as replays of a captured CUDA graph
(pipeline/graphs.py), the counterpart of the reference's jitted program:
one graph of one tick a scan in per-scan mode, one graph of `unroll`
ticks for the steady windows in window mode.  On the CPU the ticks run
eagerly.

Ported: the fused single-association solve (slice 1), the ESIKF row path
(slice 2), the bench configuration (slice 3: the plane cache with its
5-NN warmup program, the budgeted moment inserts, mom_dense, the
compacted solve), the windowed, pipelined, quantized mode (slice 4) and
the map rebuild at the kd_step cadence with the map reset after a loop
correction (slice 5), LOAM plane-feature extraction on the host
(`preprocess.feature_extract_enable`, io/features.py) with the C++
wire packer of io/native.py, the SPMD window step over a
torch.distributed mesh (`mesh=`, slice 8; parallel/sharded.py), and the
per-scan programs as one CUDA-graph replay a scan (slice 9).

The filter state is replaced between scans in one way, the `ls`
property's setter: the rebuild, the map reset and the SLAM back end's
pose feedback and rollback all go through it.  Once the program that
runs next is a captured CUDA graph, the setter copies the new state into
the graph's own tensors (the graph reads them by address), so the next
replay starts from it.
"""

from __future__ import annotations

import functools
import sys
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from ..config import LIOConfig, derive_map_dense_log2
from ..core import esikf, imu, measurement
from ..core.state import State
from ..io import native
from ..io.features import feature_filter
from ..map import voxel_hash
from ..ops.downsample import voxel_downsample
from ..parallel import collectives
from ..utils import so3
from ..utils.device import (readback_async, readback_wait, resolve_device,
                            to_host)
from ..utils.trace import Tracer, span, tracing
from ..utils.trace import active as trace_active
from ..utils.tree import tree_where
from . import graphs

__all__ = ["LIOState", "LIOPipeline", "make_step_fn", "check_config",
           "WindowInputs", "QuantWindowInputs", "POS_SCALE",
           "decode_quant", "make_window_step_fn"]

MOV_THRESHOLD = 1.5  # laserMapping.cpp MOV_THRESHOLD
TRACE_RING = 4096  # scan records a traced pipeline keeps (LIOPipeline.traces)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class LIOState(NamedTuple):
    """Complete filter state threaded through scan ticks (device tensors)."""

    x: State
    P: torch.Tensor
    map: voxel_hash.VoxelHashMap
    cube_lo: torch.Tensor  # (3,) local-map box
    cube_hi: torch.Tensor
    cube_init: torch.Tensor  # () bool
    last_acc_w: torch.Tensor  # (3,) terminal world acceleration, prev scan
    last_gyr_b: torch.Tensor  # (3,) terminal bias-corrected gyro, prev scan
    ekf_inited: torch.Tensor  # () bool — the first scan only builds the map


def check_config(cfg: LIOConfig) -> None:
    """Raise NotImplementedError for every option the port does not carry
    yet, naming the later slice that brings it."""
    checks = [
        (cfg.dtype not in _DTYPES, f"dtype {cfg.dtype!r}", "no slice"),
    ]
    for bad, what, where in checks:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet: it comes with {where}")


def _fov_segment(ls: LIOState, pos_lid: torch.Tensor, cube_len,
                 det_range, enabled: torch.Tensor | None = None,
                 skip_points: bool = False,
                 no_crop: bool = False) -> LIOState:
    """Moving-cube local map management (laserMapping.cpp:1136-1200), all
    on the device: the first scan centres the cube on the lidar, later
    scans shift it by `mov` along each axis whose face came within
    MOV_THRESHOLD * det_range, and a shift crops the map to the new box.
    enabled=False (a padded window slot) suppresses the crop; the caller
    selects the cube fields back.  skip_points: see crop_outside_box (the steady plane-cache program).
    no_crop=True only moves the cube: the dense-moment steady program
    forgets by torus aliasing instead (IkdtreeConfig.mom_dense)."""
    half = cube_len / 2.0
    d_lo = torch.abs(pos_lid - ls.cube_lo)
    d_hi = torch.abs(ls.cube_hi - pos_lid)
    thr = MOV_THRESHOLD * det_range
    near_lo = d_lo <= thr
    near_hi = d_hi <= thr
    mov = max((cube_len - 2.0 * MOV_THRESHOLD * det_range) * 0.45,
              det_range * (MOV_THRESHOLD - 1.0))
    movt = torch.full_like(pos_lid, mov)
    shift = torch.where(near_lo, -movt,
                        torch.where(near_hi, movt, torch.zeros_like(movt)))
    init = ls.cube_init
    lo = torch.where(init, ls.cube_lo + shift, pos_lid - half)
    hi = torch.where(init, ls.cube_hi + shift, pos_lid + half)
    if no_crop:
        return ls._replace(cube_lo=lo, cube_hi=hi,
                           cube_init=torch.ones_like(init))
    need_crop = init & torch.any(near_lo | near_hi)
    if enabled is not None:
        need_crop = need_crop & enabled
    m = voxel_hash.crop_outside_box(ls.map, lo, hi, enabled=need_crop,
                                    skip_points=skip_points)
    return ls._replace(map=m, cube_lo=lo, cube_hi=hi,
                       cube_init=torch.ones_like(init))


def _mom_dense_window(cfg: LIOConfig) -> tuple[float, float, float]:
    """Check the dense-moment steady program's preconditions and return
    the per-axis half-widths of its sensor-centred insert window.

    Sizes the torus from the detection geometry when
    shapes.map_dense_log2 is None (derive_map_dense_log2, written back
    into the config as the reference does).  The insert's delta scatter
    corrupts a cell that two distinct voxels of one batch reach, so: one
    row per voxel (scan leaf == map voxel); the torus spans 2 * det_range
    horizontally; vertically at least det_range, unless
    shapes.map_dense_z_clip opts into a shorter span.  The window (half
    the span less one voxel per axis) keeps every batch inside the span,
    also for returns past det_range."""
    sh, mp, kd = cfg.shapes, cfg.mapping, cfg.ikdtree
    vox = kd.filter_size_map_min
    if sh.map_dense_log2 is None:
        sh.map_dense_log2 = derive_map_dense_log2(mp.det_range, vox)
    if mp.surf_leaf_size != vox:
        raise ValueError(
            "mom_dense requires surf_leaf_size == filter_size_map_min "
            f"(got {mp.surf_leaf_size} vs {vox})")
    for ax, lg in enumerate(sh.map_dense_log2):
        span = (1 << lg) * vox
        if ax < 2 and 2.0 * mp.det_range > span:
            raise ValueError(
                f"mom_dense torus axis {ax} spans {span:.0f} m (2^{lg} "
                f"cells x {vox} m) < 2*det_range = {2.0 * mp.det_range:.0f}"
                " m: distinct voxels in one scan batch would alias; raise "
                "shapes.map_dense_log2 or lower mapping.det_range")
        if ax == 2 and span < mp.det_range and not sh.map_dense_z_clip:
            raise ValueError(
                f"mom_dense torus z axis spans {span:.0f} m < det_range = "
                f"{mp.det_range:.0f} m: a scan whose vertical spread "
                "exceeds the span would alias distinct voxels within one "
                "insert batch and corrupt the moment table.  Raise "
                "shapes.map_dense_log2[2] (or leave map_dense_log2=None to "
                "auto-size), or set shapes.map_dense_z_clip=True to clip "
                "inserts to a sensor-centred z window of the span")
    return tuple(0.5 * (1 << lg) * vox - vox for lg in sh.map_dense_log2)


def make_step_fn(cfg: LIOConfig, device: torch.device,
                 plane_cache: bool | None = None, mesh=None,
                 ndev: int | None = None):
    """The one-scan tick on `device`:

    step(ls, pts, pt_t, pt_valid, imu_b, last_end_rel, scan_end_t,
         acc_norm, scan_valid=None) -> (ls', info_vec)

    pts (n_raw, 3) lidar-frame points, pt_t (n_raw,) offsets from the scan
    begin, IMU times relative to the scan begin, scan_end_t the scan
    duration, last_end_rel the previous scan's end relative to this scan's
    begin (computed on the host in f64: absolute epoch stamps never reach
    the device).  The map tensors are updated in place (the reference
    donates its state buffers the same way).

    scan_valid (window mode's padded-tail gate, a device bool) is handled
    as the reference does, without a branch around the tick: the point
    and IMU masks are sanitised (with every row masked out the map update
    is a bit-exact no-op) and the small state leaves are selected back.

    Every program gates the update on the device, as the reference's
    lax.cond (:337): the update always runs, and `ekf_inited & (n_valid
    >= 5)` selects its x, P and n_eff or the propagated ones (an update
    on an empty map may give NaN; the select drops it).  The returned
    step carries `sync_free`: it reads nothing on the host, so the
    pipeline may capture it in a CUDA graph; true for every program
    except under a gloo mesh, which stages its collectives through the
    host.

    plane_cache overrides cfg.ikdtree.plane_cache when not None: the
    pipeline builds the 5-NN warmup program with plane_cache=False beside
    the plane-cache one.  The plane-cache program under a warmup split is
    the steady program: its crop skips the points, its insert takes the
    budgets and touches only the moments (moments_only), or, with
    mom_dense, writes only the dense moment table and the crop is
    replaced by torus-wrap forgetting.

    mesh (a parallel.collectives.Mesh of D = ndev or mesh.size ranks; the
    reference's _make_step_core(spmd_axis, spmd_ndev), :98-375): the
    step is one rank's program of the SPMD window step.  The map and the
    filter state are replicated; `pts` / `pt_t` / `pt_valid` are this
    rank's contiguous 1/D shard of the raw scan.  It undistorts the
    shard and all_gathers the batch (rank order = row order), runs the
    replicated downsample, associates and solves on its contiguous 1/D
    slice of the downsampled rows (start = rank * n_ds / D) with the
    Gram and the steering counts psum'd per pass, and the dense-moment
    insert shares its arithmetic (insert_dense_moments' mesh mode, the
    budget rounded up to a multiple of D).  With
    ShapesConfig.spmd_local_downsample the steady program downsamples
    each shard to n_ds / D rows instead and psums the valid count.  At
    D = 1 every collective is an identity and the results are the
    one-device step's.  ndev > mesh.size (the reference's override_ndev,
    timing only) runs one rank's share of a D-rank program on this mesh:
    its results are partial by construction."""
    check_config(cfg)
    sh, mp, kd = cfg.shapes, cfg.mapping, cfg.ikdtree
    dtype = _DTYPES[cfg.dtype]
    packed_key = (2.2 * mp.det_range / mp.surf_leaf_size) < 1000.0
    n_cols = 12 if mp.extrinsic_est_en else 6
    # downsample centroids at the map's own leaf are one row per map voxel
    pre_grouped = mp.surf_leaf_size == kd.filter_size_map_min
    Q = imu.build_Q(mp.gyr_cov, mp.acc_cov, mp.b_gyr_cov, mp.b_acc_cov, dtype,
                    device)
    eff_pc = kd.plane_cache if plane_cache is None else plane_cache
    steady = eff_pc and kd.plane_cache_warmup > 0
    mom_dense = steady and kd.mom_dense
    D = (ndev or mesh.size) if mesh is not None else 1
    if sh.n_raw % D or sh.n_ds % D:
        raise ValueError(f"SPMD mode needs n_raw and n_ds divisible by the "
                         f"rank count (got {sh.n_raw}/{sh.n_ds} over {D})")
    local_ds = mesh is not None and mom_dense and sh.spmd_local_downsample
    if mom_dense:
        clip_hw = torch.tensor(_mom_dense_window(cfg), dtype=dtype,
                               device=device)
        dshape = tuple(1 << b for b in sh.map_dense_log2) + (2,)
    # the insert budgets and the moment freeze belong to the steady program
    budgets = (dict(claim_budget=sh.insert_claim_budget,
                    dense_budget=sh.insert_dense_budget) if steady else {})

    def update(ls, x_prop, P_prop, pts_ds, ds_valid, n_valid):
        """(x_post, P_post, n_eff, passes) of the iterated update, gated
        by laserMapping.cpp:2347 (ekf inited, >= 5 downsampled points);
        pts_ds / ds_valid are this rank's rows under a mesh, n_valid the
        global count.  `passes` (2,) f32: the ESIKF passes the update ran
        and whether its lazy refresh fired (whether or not the gate keeps
        the update: the update runs either way)."""
        def run():
            measure, aux0 = measurement.make_measure_fn(
                ls.map, pts_ds, ds_valid,
                extrinsic_est=mp.extrinsic_est_en,
                max_probe=sh.map_max_probe,
                n_neighbors=sh.knn_neighbors,
                single_association=kd.single_association,
                max_live=sh.knn_max_live,
                plane_cache=eff_pc,
                fused_solve=kd.fused_solve,
                early_converge=kd.early_converge,
                solve_compact=sh.solve_compact // D,
                assoc_cells=sh.assoc_cells,
                psum=mesh,
            )
            x_u, P_u, aux_u, info_u = esikf.update_iterated(
                x_prop, P_prop, measure, aux0,
                max_iter=kd.max_iteration, n_cols=n_cols, psum=mesh)
            passes = torch.stack([info_u["iters"].to(torch.float32),
                                  aux_u.refreshed.to(torch.float32)])
            return x_u, P_u, info_u["n_eff"].to(dtype), passes

        zero = torch.zeros((), dtype=dtype, device=device)
        ok = ls.ekf_inited & (n_valid >= 5)  # device gate: run, then select
        x_u, P_u, n_eff, passes = run()
        return (tree_where(ok, x_u, x_prop), torch.where(ok, P_u, P_prop),
                torch.where(ok, n_eff, zero), passes)

    def step(ls: LIOState, pts, pt_t, pt_valid, imu_b: imu.ImuBatch,
             last_end_rel, scan_end_t, acc_norm, scan_valid=None):
        with span("lio.scan"):
            ls, x_prop, x_post, n_valid, n_eff, passes = scan(
                ls, pts, pt_t, pt_valid, imu_b, last_end_rel, scan_end_t,
                acc_norm, scan_valid)
        # every per-scan output in ONE flat f32 vector (one readback):
        #   [0:3] post pos  [3:7] post quat  [7] n_valid  [8] map voxels
        #   [9:12] prop pos  [12:16] prop quat  [16:19] vel  [19:22] bg
        #   [22:25] ba  [25:28] grav  [28] n_eff  [29] ESIKF passes run
        #   [30] lazy refresh fired (0/1)  [31] pad
        # and, while the step is traced, the scan's spans and counts after
        # them (utils/trace.py: Tracer.readout)
        f32 = torch.float32
        parts = [
            x_post.pos.to(f32), x_post.rot.to(f32),
            torch.stack([n_valid.to(f32),
                         voxel_hash.num_voxels(ls.map).to(f32)]),
            x_prop.pos.to(f32), x_prop.rot.to(f32), x_post.vel.to(f32),
            x_post.bg.to(f32), x_post.ba.to(f32), x_post.grav.to(f32),
            n_eff[None].to(f32), passes,
            torch.zeros(1, dtype=f32, device=device),
        ]
        tr = trace_active()
        if tr is not None:
            parts.append(tr.readout())
        info_vec = torch.cat(parts)
        if scan_valid is not None:
            info_vec = torch.where(scan_valid, info_vec, 0.0)
        return ls, info_vec

    def scan(ls, pts, pt_t, pt_valid, imu_b, last_end_rel, scan_end_t,
             acc_norm, scan_valid):
        """The stages of the tick: (ls', x_prop, x_post, n_valid, n_eff,
        passes)."""
        ls_in = ls
        if scan_valid is not None:
            pt_valid = pt_valid & scan_valid
            imu_b = imu_b._replace(mask=imu_b.mask & scan_valid)

        # ---- IMU forward propagation + backward undistortion -------------
        with span("lio.imu"):
            x_prop, P_prop, poses, pts_body = imu.stage(
                ls.x, ls.P, imu_b, Q, acc_norm, last_end_rel, scan_end_t,
                ls.last_acc_w, ls.last_gyr_b, pts, pt_t)
        if mesh is not None and not local_ds:
            # the full undistorted batch from the ranks' shards (rank
            # order is row order; exact rows)
            pts_body = collectives.all_gather(pts_body, mesh)
            pt_valid = collectives.all_gather(pt_valid, mesh)

        # ---- local map FoV crop around the lidar position -----------------
        with span("lio.fov_crop"):
            pos_lid = x_prop.pos + so3.quat_rotate(x_prop.rot, x_prop.off_t)
            ls = _fov_segment(ls, pos_lid, mp.cube_len, mp.det_range,
                              enabled=scan_valid, skip_points=steady,
                              no_crop=mom_dense)

        # ---- scan downsample ---------------------------------------------
        with span("lio.downsample"):
            pts_ds, ds_valid = voxel_downsample(
                pts_body, pt_valid, mp.surf_leaf_size,
                out_size=sh.n_ds // D if local_ds else sh.n_ds,
                packed_key=packed_key, drop_high_z=sh.ds_drop_high_z)

        # ---- iterated ESIKF update ----------------------------------------
        with span("lio.update"):
            n_valid = torch.sum(ds_valid.to(torch.int32))
            if local_ds:  # the global count: the same gate on every rank
                n_valid = collectives.psum(n_valid, mesh)
            pts_meas, val_meas = pts_ds, ds_valid
            if mesh is not None and not local_ds:
                # this rank associates and solves its contiguous 1/D slice
                n_loc = sh.n_ds // D
                start = mesh.rank * n_loc
                pts_meas = pts_ds[start:start + n_loc]
                val_meas = ds_valid[start:start + n_loc]
            x_post, P_post, n_eff, passes = update(ls, x_prop, P_prop,
                                                   pts_meas, val_meas, n_valid)

        # ---- map incremental insert --------------------------------------
        with span("lio.insert"):
            pts_world = measurement.transform_to_world(x_post, pts_ds)
            if mom_dense:
                # one header gather and one budgeted row scatter into the
                # dense moment table, inside the sensor-centred window;
                # the hash keys, slot index and buckets stay as the
                # warmup left them
                ins_valid = ds_valid & torch.all(
                    torch.abs(pts_world - pos_lid) <= clip_hw, dim=-1)
                budget = max(sh.insert_mom_budget, 1024)
                voxel_hash.insert_dense_moments(
                    ls.map.dmom, dshape, ls.map.voxel_size, pts_world,
                    ins_valid, mom_cap=kd.mom_cap,
                    mom_budget=-(-budget // D) * D,  # divisible by D
                    mesh=mesh, spmd_ndev=D, spmd_pre_sliced=local_ds)
                m = ls.map
            else:
                has_mom = ls.map.mom is not None
                m = voxel_hash.insert(
                    ls.map, pts_world, ds_valid, max_probe=sh.map_max_probe,
                    pre_grouped=pre_grouped, **budgets,
                    # the steady program's association reads only the
                    # moments, the keys and the dense index
                    moments_only=steady and has_mom,
                    mom_cap=kd.mom_cap if has_mom else 0,
                    mom_budget=(sh.insert_mom_budget
                                if steady and has_mom else 0))

        ls = LIOState(
            x=x_post, P=P_post, map=m, cube_lo=ls.cube_lo,
            cube_hi=ls.cube_hi, cube_init=ls.cube_init,
            last_acc_w=poses.acc_w[-1], last_gyr_b=poses.gyr_b[-1],
            ekf_inited=torch.ones_like(ls.ekf_inited))
        if scan_valid is not None:
            # a padded slot keeps the small leaves (the map is untouched
            # by construction: every row was masked out)
            ls = ls._replace(**{
                f: tree_where(scan_valid, getattr(ls, f), getattr(ls_in, f))
                for f in ls._fields if f != "map"})
        return ls, x_prop, x_post, n_valid, n_eff, passes

    # a gloo mesh stages its collectives through the host
    step.sync_free = mesh is None or mesh.capturable
    return step


class WindowInputs(NamedTuple):
    """W scans' stacked tick inputs of the windowed step."""

    pts: torch.Tensor  # (W, n_raw, 3)
    pt_t: torch.Tensor  # (W, n_raw)
    pt_valid: torch.Tensor  # (W, n_raw) bool
    imu_acc: torch.Tensor  # (W, m_imu, 3)
    imu_gyr: torch.Tensor  # (W, m_imu, 3)
    imu_t: torch.Tensor  # (W, m_imu)
    imu_mask: torch.Tensor  # (W, m_imu) bool
    last_end_rel: torch.Tensor  # (W,)
    scan_end_t: torch.Tensor  # (W,)
    scan_valid: torch.Tensor  # (W,) bool


# The quantized wire format of the window (reference :478-492): per scan
#   bulk (3.5 * n_raw) uint16: cols [0, 3n) point coords as int16 bits,
#        quantized by POS_SCALE (3.7 mm steps, +-120 m); cols [3n, 3.5n)
#        per-point times as uint8 fractions of the scan duration, packed in
#        pairs (lo | hi << 8);
#   meta (8 * m_imu + 4) f32: the IMU acc | gyr | t | mask rows, then
#        [n_points, last_end_rel, scan_end_t, scan_valid].
# The port ships the bulk as int16 (the same bytes): bitwise operations on
# torch.uint16 are missing on CUDA, so the time pairs unpack in int32.
POS_SCALE = 120.0 / 32767.0  # ~3.66 mm/step, +-120 m range


class QuantWindowInputs(NamedTuple):
    bulk: torch.Tensor  # (W, 3.5 * n_raw) int16 (the uint16 wire bytes)
    meta: torch.Tensor  # (W, 8 * m_imu + 4) f32; padded tail rows are 0


def _bulk_cols(n_raw: int) -> int:
    """int16 columns of the quantized bulk in the window buffer, padded to
    an even count so that the f32 meta after it is 4-byte aligned."""
    return 3 * n_raw + n_raw // 2 + (n_raw // 2) % 2


def _view_window(win: torch.Tensor, n_raw: int, n_imu: int,
                 quantized: bool):
    """WindowInputs / QuantWindowInputs views of a (W', R) window buffer
    (any leading count W')."""
    n, m = n_raw, n_imu
    if quantized:
        return QuantWindowInputs(
            bulk=win[:, :3 * n + n // 2],
            meta=win[:, _bulk_cols(n):].view(torch.float32))
    k = win.shape[0]
    c = np.cumsum([0, 3 * n, n, n, 3 * m, 3 * m, m, m])
    return WindowInputs(
        pts=win[:, c[0]:c[1]].reshape(k, n, 3), pt_t=win[:, c[1]:c[2]],
        pt_valid=win[:, c[2]:c[3]] > 0.5,
        imu_acc=win[:, c[3]:c[4]].reshape(k, m, 3),
        imu_gyr=win[:, c[4]:c[5]].reshape(k, m, 3),
        imu_t=win[:, c[5]:c[6]], imu_mask=win[:, c[6]:c[7]] > 0.5,
        last_end_rel=win[:, -3], scan_end_t=win[:, -2],
        scan_valid=win[:, -1] > 0.5)


def decode_quant(bulk: torch.Tensor, meta: torch.Tensor, n_raw: int,
                 m_imu: int, dtype) -> WindowInputs:
    """One scan's tick inputs from its quantized (bulk, meta) rows, on the
    device, as the reference's wstep_q decodes them (:544-570).  The IMU
    rows, last_end_rel and scan_end_t stay f32, as there."""
    qp = bulk[:3 * n_raw].to(dtype).reshape(n_raw, 3)
    n = meta[8 * m_imu].to(torch.int32)
    scan_end_t = meta[8 * m_imu + 2]
    tw = bulk[3 * n_raw:3 * n_raw + n_raw // 2].to(torch.int32) & 0xFFFF
    t8 = torch.stack([tw & 0xFF, tw >> 8], dim=1).reshape(n_raw)
    im = meta[:8 * m_imu].reshape(m_imu, 8)
    imu_mask = im[:, 7] > 0.5
    return WindowInputs(
        pts=qp * POS_SCALE,
        # the reference's scan_end_t / 255.0 as XLA compiles it: a product
        # with the f32 reciprocal (the same f32 rounding in every run)
        pt_t=t8.to(dtype) * (scan_end_t * (1.0 / 255.0)),
        pt_valid=torch.arange(n_raw, device=bulk.device) < n,
        imu_acc=im[:, 0:3], imu_gyr=im[:, 3:6],
        imu_t=torch.where(imu_mask, im[:, 6], float("inf")),
        imu_mask=imu_mask, last_end_rel=meta[8 * m_imu + 1],
        scan_end_t=scan_end_t, scan_valid=meta[8 * m_imu + 3] > 0.5)


def _slot(w: tuple, k: int) -> tuple:
    """Slot k of a stacked window."""
    return type(w)(*(a[k] for a in w))


def _make_tick(cfg: LIOConfig, step, quantized: bool):
    """tick(ls, xs, acc_norm) -> (ls, info): one window slot `xs` (a
    WindowInputs slot, or a QuantWindowInputs slot decoded first) through
    `step`."""
    n_raw, m_imu = cfg.shapes.n_raw, cfg.shapes.n_imu
    dtype = _DTYPES[cfg.dtype]

    def tick(ls, xs, acc_norm):
        if quantized:
            xs = decode_quant(xs.bulk, xs.meta, n_raw, m_imu, dtype)
        batch = imu.ImuBatch(acc=xs.imu_acc, gyr=xs.imu_gyr, t=xs.imu_t,
                             mask=xs.imu_mask)
        return step(ls, xs.pts, xs.pt_t, xs.pt_valid, batch,
                    xs.last_end_rel, xs.scan_end_t, acc_norm,
                    scan_valid=xs.scan_valid)

    return tick


def _window_fn(tick, window: int):
    """wstep(ls, w, acc_norm) -> (ls, infos (window, 32)): the slots of
    the stacked window `w` through `tick`, one after the other."""
    def wstep(ls, w, acc_norm):
        infos = []
        for k in range(window):
            ls, info = tick(ls, _slot(w, k), acc_norm)
            infos.append(info)
        return ls, torch.stack(infos)

    return wstep


def make_window_step_fn(cfg: LIOConfig, window: int, device: torch.device,
                        plane_cache: bool | None = None,
                        quantized: bool = False):
    """The W-scan window (reference make_window_step_fn, :500-576), run
    eagerly: wstep(ls, w, acc_norm) -> (ls, infos (W, 32)) with `w` a
    WindowInputs or, quantized, a QuantWindowInputs; each slot goes
    through the one-scan tick, padded slots (scan_valid false) change
    nothing.  LIOPipeline captures the sync-free steady program's window
    function in a CUDA graph and replays it (pipeline/graphs.py)."""
    return _window_fn(_make_tick(cfg, make_step_fn(cfg, device, plane_cache),
                                 quantized), window)


class LIOPipeline:
    """Host-side loop: IMU init bookkeeping + scan ticks.

    The analog of the reference main() loop: the first MAX_INI_COUNT IMU
    samples run static initialisation (IMU_Processing.hpp:393-433), then
    every scan runs the tick.  With the plane cache the first
    `plane_cache_warmup` scans run the 5-NN warmup program while the
    moments densify, then the steady program; under mom_dense the slot
    moments move into the dense moment table once, right before the
    first steady scan (in window mode: the first steady window; warmup is
    rounded up to whole windows, as in the reference).  Runs on ``cuda``
    unless `device` names another device; raises if no GPU is present and
    no device was named.
    """

    MAX_INI_COUNT = 10  # IMU_Processing.hpp:4

    def __init__(self, cfg: LIOConfig, device=None, pipelined: bool = False,
                 window: int = 1, quantized: bool = False,
                 readback_depth: int = 1, unroll: int = 1, mesh=None,
                 graphed: bool = True, trace: bool = False):
        """The options of the reference's LIOPipeline (:590-697):

        Per scan (window=1, unquantized) on CUDA, each scan is one packed
        unquantized row (the window wire with W = 1) shipped in one
        pinned non-blocking copy, and its tick is a replay of the
        program's one-tick CUDA graph: the warmup program's graph is
        captured at its first scan and released at the handoff, the
        steady program's at its first scan (each program's first scan
        runs eagerly on the capture stream and the graph is captured from
        the state it leaves).  On the CPU the step runs eagerly on the
        scan's tensors.

        graphed=False asks for eager ticks on CUDA (the same ticks, the
        same results; the tests hold the replays to them).  A capture that
        fails raises; nothing falls back to eager ticks by itself.

        trace=True (per-scan mode, no mesh) traces the step
        (utils/trace.py): its stage spans are stamped on the device inside
        the captured graph, its counters (IF bodies taken, map claims,
        probe rounds) ride the same readback as the info vector, and each
        scan's record (`traces`, a ring of the last TRACE_RING scans;
        also the "trace" entry of its result) holds them with the host's
        spans of the call (lio.host.pack, lio.host.launch, lio.host.wait,
        lio.host.record) and the device's wait for the scan's start
        (lio.launch, from a mark stamped right before the input copy).
        Off, the step and its graph are the untraced ones, node for node.

        pipelined=True overlaps the info readback with the next scan's
        work: process_scan returns the PREVIOUS scan's result (or, in
        window mode, the results of windows dispatched earlier).  The
        readback is a non-blocking copy into pinned host memory with a
        CUDA event that the consumer waits on.

        window=W > 1 batches W scans: they are buffered on the host, shipped
        in one pinned non-blocking host->device copy, run back to back and
        read back once; results come W scans late.  The steady program
        runs on CUDA as replays of one captured CUDA graph of `steps`
        ticks (graphs.graph_steps(W, unroll): unroll sets how many ticks
        one graph holds, and changes no result); the warmup windows run
        their ticks eagerly.

        quantized=True ships a window as the compact wire format
        (QuantWindowInputs, packed by _pack_quant); at window=1
        it runs the window machinery with W = 1.  n_raw must be even.

        readback_depth=D (pipelined window mode) keeps up to D windows'
        readbacks pending before consuming them together.

        mesh (a parallel.collectives.Mesh; window > 1 and the unquantized
        wire only, as in the reference): every tick is one rank's program
        of the SPMD window step (make_step_fn(mesh=...),
        parallel.sharded.make_spmd_window_step_fn): the map and the
        filter state replicated, the per-point work shared by rows, the
        Gram summed over the ranks each pass.  Every rank's pipeline is
        handed the same scans, as every JAX process is, and ships only its
        rows [r n_raw / D, (r + 1) n_raw / D) of each scan to its device.
        The 5-NN warmup program and the steady program both run under the
        mesh.  On an NCCL mesh the steady program is captured and replayed
        as a CUDA graph, its collectives inside; a gloo mesh stages its
        collectives through the host, so its ticks run eagerly (the rule
        follows the group's backend, Mesh.capturable).  The device is the
        mesh's."""
        if mesh is not None and (int(window) <= 1 or quantized):
            raise ValueError("mesh mode: use window > 1 and the unquantized "
                             "wire")
        if trace and (mesh is not None or int(window) > 1 or quantized):
            raise ValueError("trace=True traces the per-scan step on one "
                             "device: no mesh, window or quantized wire")
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        if mesh is not None and device is not None:
            dev = resolve_device(device)
            if dev.type != mesh.device.type or dev.index not in (
                    None, mesh.device.index):
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"{mesh.device}")
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.cfg = cfg
        self.window = int(window)
        self.quantized = bool(quantized)
        if self.quantized and cfg.shapes.n_raw % 2:
            raise ValueError("quantized window mode requires an even "
                             f"shapes.n_raw (got {cfg.shapes.n_raw})")
        self._use_window = self.window > 1 or self.quantized
        self.unroll = max(1, int(unroll))
        self.pipelined = bool(pipelined)
        self.readback_depth = max(1, int(readback_depth))
        # scan rows shipped to this device (this rank's shard under a mesh)
        self._n_pts = cfg.shapes.n_raw // (mesh.size if mesh else 1)
        self._step = make_step_fn(cfg, self.device, mesh=mesh)  # validates
        kd = cfg.ikdtree
        # plane-cache warmup: the 5-NN association for the first scans,
        # while the moment cache densifies (its n >= 5 gate starves on a
        # young map), then the plane-cache program
        self._warmup_scans = kd.plane_cache_warmup if kd.plane_cache else 0
        if self._warmup_scans > 0:
            self._step_warm = make_step_fn(cfg, self.device,
                                           plane_cache=False, mesh=mesh)
        if kd.mom_dense and not (self._warmup_scans > 0
                                 and cfg.shapes.map_dense_log2 is not None):
            raise ValueError("mom_dense requires plane_cache, "
                             "plane_cache_warmup > 0 and "
                             "shapes.map_dense_log2")
        self._scan_count = 0  # scans run through a step program
        self.dtype = _DTYPES[cfg.dtype]
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise NotImplementedError(
                "on CUDA the port runs in float32 (the fused_normal_eqs "
                "and fused_hth kernels take f32); float64 runs on the CPU")
        # the graph holds this view; a bound method would tie it and the
        # pipeline into a cycle that only the cyclic GC frees.  Per scan
        # the ticks read the unquantized row of one scan.
        self._view = functools.partial(
            _view_window, n_raw=self._n_pts, n_imu=cfg.shapes.n_imu,
            quantized=self.quantized)
        self._tick = _make_tick(cfg, self._step, self.quantized)
        if self._warmup_scans > 0:
            self._tick_warm = _make_tick(cfg, self._step_warm,
                                         self.quantized)
        # sync-free programs replay from CUDA graphs unless asked not to
        self._graphed = bool(graphed) and self.device.type == "cuda"
        # the graph of the program that runs next (window mode: the
        # steady program's); `_graph_of` names its program
        self.graph: graphs.StepGraph | None = None
        self._graph_of: str | None = None
        self._init_acc: list[np.ndarray] = []
        self._init_gyr: list[np.ndarray] = []
        self.inited = False
        self.acc_norm = 9.81
        self._acc_t: torch.Tensor | None = None  # window mode's acc_norm
        self._ls: LIOState | None = None
        self.last_scan_end_abs: float | None = None  # f64 host clock
        self.trajectory: list[np.ndarray] = []
        self._pending_info = None  # per-scan pipelined readback
        # the step's trace: the tracer, the records of the last scans, and
        # the host side of each scan launched and not yet recorded
        self._tracer = Tracer(self.device) if trace else None
        self.traces: deque = deque(maxlen=TRACE_RING)
        self._trace_meta: deque = deque()
        self._wbuf: list[tuple] = []  # buffered scans of the open window
        self._pending_ws: list[tuple] = []  # [(readback, n_valid)]
        self._results: list[dict] = []  # completed per-scan dicts (FIFO)
        self._scans_dispatched = 0

    @property
    def ls(self) -> LIOState | None:
        """The filter state (device tensors)."""
        return self._ls

    @ls.setter
    def ls(self, new: LIOState | None) -> None:
        """Replace the filter state.  Once the graph of the program that
        runs next is captured, its kernels read the state and the map
        tables by address: every tensor leaf of `new` is copied into the
        graph's own (on the current stream, ahead of the next replay) and
        `ls` stays the graph's.  A state of another structure or shape
        raises; nothing falls back to eager execution.  Scans already
        buffered for the open window run from the new state, as in the
        reference's window dispatch."""
        if (self.graph is not None and new is not None
                and new is not self.graph.ls):
            self.graph.load_state(new)
            new = self.graph.ls
        self._ls = new

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype or self.dtype,
                               device=self.device)

    def _make_ls(self, x: State, P: torch.Tensor) -> LIOState:
        sh = self.cfg.shapes
        m = voxel_hash.make_map(
            capacity_log2=sh.map_capacity_log2, bucket=sh.map_bucket,
            voxel_size=self.cfg.ikdtree.filter_size_map_min,
            dtype=self.dtype, device=self.device,
            dense_log2=sh.map_dense_log2,
            moments=self.cfg.ikdtree.plane_cache)

        def z3():
            return torch.zeros(3, dtype=self.dtype, device=self.device)

        false = torch.zeros((), dtype=torch.bool, device=self.device)
        return LIOState(x=x, P=P, map=m, cube_lo=z3(), cube_hi=z3(),
                        cube_init=false, last_acc_w=z3(), last_gyr_b=z3(),
                        ekf_inited=false.clone())

    def reset_map_from_world_points(self, world_pts: np.ndarray) -> None:
        """Rebuild the local map from corrected world-frame points (the
        recontructIKdTree-after-correctPoses analog, laserMapping.cpp:
        797-800): after a loop-closure pose jump the old map lies in the
        drifted odometry frame.  Inserts the points in n_ds chunks into a
        fresh map, rebuilds the dense moment table from it when the steady
        program has one, and re-centres the FoV cube on the corrected
        lidar position."""
        sh = self.cfg.shapes
        m = voxel_hash.make_map(
            capacity_log2=sh.map_capacity_log2, bucket=sh.map_bucket,
            voxel_size=self.cfg.ikdtree.filter_size_map_min,
            dtype=self.dtype, device=self.device,
            dense_log2=sh.map_dense_log2,
            moments=self.ls.map.mom is not None)
        chunk = sh.n_ds
        world_pts = np.asarray(world_pts, np.float32)
        for i in range(0, len(world_pts), chunk):
            blk = world_pts[i:i + chunk]
            buf = np.zeros((chunk, 3), np.float32)
            buf[:len(blk)] = blk
            valid = np.zeros(chunk, bool)
            valid[:len(blk)] = True
            m = voxel_hash.insert(m, self._t(buf), self._t(valid, torch.bool),
                                  max_probe=sh.map_max_probe)
        ls = self.ls
        # the reference widens the lidar position to f64 on the host
        pos_lid = (ls.x.pos + so3.quat_rotate(ls.x.rot, ls.x.off_t)).double()
        half = self.cfg.mapping.cube_len / 2.0
        if ls.map.dmom is not None:
            m = m._replace(dmom=voxel_hash.build_dense_moments(m, pos_lid))
        self.ls = ls._replace(
            map=m, cube_lo=(pos_lid - half).to(self.dtype),
            cube_hi=(pos_lid + half).to(self.dtype),
            cube_init=torch.ones_like(ls.cube_init))

    def _ensure_dmom(self) -> None:
        """The warmup->steady handoff of the dense-moment program: build
        the torus moment table from the warmup map's slot moments, around
        the FoV-cube centre, once (no host read)."""
        if not self.cfg.ikdtree.mom_dense or self.ls.map.dmom is not None:
            return
        center = (self.ls.cube_lo + self.ls.cube_hi) * 0.5
        dmom = voxel_hash.build_dense_moments(self.ls.map, center)
        self.ls = self.ls._replace(map=self.ls.map._replace(dmom=dmom))

    def _try_init(self, imu_acc: np.ndarray, imu_gyr: np.ndarray) -> bool:
        self._init_acc.append(imu_acc)
        self._init_gyr.append(imu_gyr)
        if sum(len(a) for a in self._init_acc) <= self.MAX_INI_COUNT:
            return False
        acc = np.concatenate(self._init_acc)
        gyr = np.concatenate(self._init_gyr)
        mpc = self.cfg.mapping
        off_r = so3.matrix_to_quat(
            self._t(np.array(mpc.extrinsic_R, float).reshape(3, 3)))
        off_t = self._t(np.array(mpc.extrinsic_T, float))
        x0, P0, acc_norm = imu.imu_init(
            self._t(acc), self._t(gyr),
            torch.ones(len(acc), dtype=torch.bool, device=self.device),
            off_r, off_t, self.dtype)
        self.acc_norm = float(to_host(acc_norm))
        self.ls = self._make_ls(x0, P0)
        self.inited = True
        return True

    def process_scan(self, pts: np.ndarray, pt_t: np.ndarray,
                     imu_acc: np.ndarray, imu_gyr: np.ndarray,
                     imu_t: np.ndarray, scan_beg_abs: float,
                     scan_end_t: float):
        """Feed one synchronised measurement group (sync_packages analog).

        pts (n,3) lidar frame; pt_t (n,) seconds from scan begin; imu_t
        seconds from scan begin (sample 0 the tail of the previous packet).
        Returns an info dict, or None while initialising, for a dropped
        group, or while the result is still pending (pipelined or window
        mode; flush() drains)."""
        # sensor-stream sanity (laserMapping.cpp:1209-1213, 1241-1244,
        # 1316-1320): a timestamp regression means the source looped back
        if (self.last_scan_end_abs is not None
                and scan_beg_abs + scan_end_t < self.last_scan_end_abs - 1e-6):
            print("lidar loop back, skipping scan group", file=sys.stderr)
            self.last_scan_end_abs = scan_beg_abs + scan_end_t
            return None
        imu_t = np.asarray(imu_t)
        if imu_t.size > 1 and np.any(np.diff(imu_t) < -1e-6):
            print("imu loop back, skipping scan group", file=sys.stderr)
            return None
        if imu_t.size and abs(float(imu_t[-1]) - scan_end_t) > 10.0:
            print(f"IMU and LiDAR not synced ({float(imu_t[-1]):.1f}s vs "
                  f"{scan_end_t:.1f}s scan end)", file=sys.stderr)

        if not self.inited:
            self._try_init(imu_acc, imu_gyr)
            self.last_scan_end_abs = scan_beg_abs + scan_end_t
            return None

        if self.cfg.preprocess.feature_extract_enable:
            # the plane features of give_feature (reference :871-877)
            pts, pt_t = feature_filter(
                np.asarray(pts, np.float32), np.asarray(pt_t),
                n_rings=self.cfg.preprocess.scan_line)

        if self._tracer is not None:
            return self._traced_scan(pts, pt_t, imu_acc, imu_gyr, imu_t,
                                     scan_beg_abs, scan_end_t)
        prog, entry, host = self._prepare(pts, pt_t, imu_acc, imu_gyr, imu_t,
                                          scan_beg_abs, scan_end_t)
        if self._use_window:
            return self._results.pop(0) if self._results else None
        info_vec = self._launch(prog, entry, host)
        if not self.pipelined:
            return self._record(np.asarray(to_host(info_vec), np.float32))
        # overlap the result's host copy with the next scan
        prev, self._pending_info = (self._pending_info,
                                    readback_async(info_vec))
        return None if prev is None else self._record(readback_wait(prev))

    def _prepare(self, pts, pt_t, imu_acc, imu_gyr, imu_t, scan_beg_abs,
                 scan_end_t):
        """A scan's host work before its tick: the padded arrays, the map
        rebuild at its cadence, and per scan the program that runs it
        (the warmup->steady handoff) with, on CUDA, the packed pinned row.
        Returns (program, padded entry, row); in window mode the scan is
        buffered (its window dispatched when full) and the program and row
        are None."""
        P, T, V = self._pad_points(pts, pt_t)
        A, G, Tt, Mk = self._pad_imu(imu_acc, imu_gyr, imu_t)
        self._scan_count += 1
        # periodic map compaction (recontructIKdTree, laserMapping.cpp:
        # 612-669): rebuild when the tombstones left by FoV crops pass a
        # tenth of the table, at the kd_step cadence
        kd = self.cfg.ikdtree
        if (kd.recontruct_kdtree
                and self._scan_count % max(kd.kd_step, 1) == 0
                and to_host(voxel_hash.tombstone_fraction(self.ls.map)) > 0.1):
            # the cube centre keys the coord unwrap, so point-less
            # (moments_only) voxels survive with their moments
            center = (self.ls.cube_lo + self.ls.cube_hi) * 0.5
            self.ls = self.ls._replace(
                map=voxel_hash.rebuild(self.ls.map, center=center))
        # f64 host clock: only relative times reach the device
        last_end_rel = (self.last_scan_end_abs - scan_beg_abs
                        if self.last_scan_end_abs is not None else 0.0)
        self.last_scan_end_abs = scan_beg_abs + scan_end_t
        entry = (P, T, V, A, G, Tt, Mk, last_end_rel, scan_end_t)

        if self._use_window:
            if self.quantized:
                self._wbuf.append(self._pack_quant(*entry))
            else:
                if self.mesh is not None:  # this rank's rows only
                    rows = slice(self.mesh.rank * self._n_pts,
                                 (self.mesh.rank + 1) * self._n_pts)
                    P, T, V = P[rows], T[rows], V[rows]
                self._wbuf.append((P, T, V, A, G, Tt, Mk, last_end_rel,
                                   scan_end_t))
            if len(self._wbuf) == self.window:
                self._dispatch_window()
            return None, entry, None

        if self._scan_count > self._warmup_scans:
            if self._graph_of == "warmup":
                # the handoff: the warmup graph is done; release it (and
                # its pool) before the steady state takes its dense table
                self.graph, self._graph_of = None, None
            self._ensure_dmom()
            prog = "steady"
        else:
            prog = "warmup"
        host = (self._pack_window([entry]) if self.device.type == "cuda"
                else None)
        return prog, entry, host

    def _launch(self, prog: str, entry: tuple, host) -> torch.Tensor:
        """The scan's tick: on CUDA from its packed row (_scan_tick), on
        the CPU eagerly on its own tensors.  Returns the info vector."""
        if host is not None:  # (per scan there is no mesh)
            return self._scan_tick(prog, host)
        step = self._step if prog == "steady" else self._step_warm
        return self._scan_eager(step, *entry)

    def _traced_scan(self, *args):
        """process_scan with the step traced: the host's spans of the call
        around the tick, which runs with the tracer active, and the scan's
        record built where its result is (now, or pipelined at the next
        call)."""
        t_pack = time.perf_counter_ns()
        prog, entry, host = self._prepare(*args)
        t_launch = time.perf_counter_ns()
        self._tracer.mark()
        with tracing(self._tracer):
            info_vec = self._launch(prog, entry, host)
        self._trace_meta.append(
            (self._scan_count, args[5], self._tracer.sites,
             {"lio.host.pack": (t_pack, t_launch),
              "lio.host.launch": (t_launch, time.perf_counter_ns())}))
        if not self.pipelined:
            t_wait = time.perf_counter_ns()
            v = np.asarray(to_host(info_vec), np.float32)
            return self._record(v, (t_wait, time.perf_counter_ns()))
        prev, self._pending_info = (self._pending_info,
                                    readback_async(info_vec))
        return None if prev is None else self._wait_record(prev)

    def _wait_record(self, rb) -> dict:
        """The record of a pipelined readback `rb`, once it has arrived."""
        if self._tracer is None:
            return self._record(readback_wait(rb))
        t_wait = time.perf_counter_ns()
        v = readback_wait(rb)
        return self._record(v, (t_wait, time.perf_counter_ns()))

    def _scan_eager(self, step, P, T, V, A, G, Tt, Mk, last_end_rel,
                    scan_end_t) -> torch.Tensor:
        """One scan through `step` on its own tensors (the CPU path)."""
        batch = imu.ImuBatch(acc=self._t(A), gyr=self._t(G), t=self._t(Tt),
                             mask=self._t(Mk, torch.bool))
        self.ls, info_vec = step(
            self.ls, self._t(P), self._t(T), self._t(V, torch.bool), batch,
            self._t(last_end_rel), self._t(scan_end_t), self._t(self.acc_norm))
        return info_vec

    def _scan_tick(self, prog: str, host: torch.Tensor) -> torch.Tensor:
        """One scan on CUDA as one tick of `prog` ("warmup" or "steady")
        on its packed unquantized row `host` (_pack_window, W = 1,
        pinned): a replay of the program's one-tick graph, which takes the
        row in one non-blocking copy.  The program's first scan is copied
        to the device, run eagerly on the capture stream, and the graph
        captured from the state it leaves
        (StepGraph.warm_up_and_capture); with graphed=False every tick
        runs eagerly.  Returns the (32,) info (more while traced)."""
        if self._acc_t is None:  # read by the ticks and the graph
            self._acc_t = self._t(self.acc_norm)
        if self.graph is not None and self._graph_of == prog:
            return self.graph.replay(host)[0]
        tick = self._tick if prog == "steady" else self._tick_warm
        row = host.to(self.device, non_blocking=True)
        if not self._graphed:
            self.ls, infos = _window_fn(tick, 1)(self.ls, self._view(row),
                                                 self._acc_t)
            return infos[0]
        graph = graphs.StepGraph(_window_fn(tick, 1), self._view, 1,
                                 self._acc_t)
        self.ls, infos = graph.warm_up_and_capture(self.ls, row)
        self.graph, self._graph_of = graph, prog
        return infos[0]

    def _pad_points(self, pts, pt_t):
        n_pad = self.cfg.shapes.n_raw
        n = len(pts)
        if n > n_pad:  # stride-subsample on the host
            stride = -(-n // n_pad)
            pts, pt_t = pts[::stride][:n_pad], pt_t[::stride][:n_pad]
            n = len(pts)
        np_dt = np.float32 if self.dtype == torch.float32 else np.float64
        P = np.zeros((n_pad, 3), np_dt)
        T = np.zeros(n_pad, np_dt)
        V = np.zeros(n_pad, bool)
        P[:n], T[:n], V[:n] = pts, pt_t, True
        return P, T, V

    def _pad_imu(self, imu_acc, imu_gyr, imu_t):
        m_imu = self.cfg.shapes.n_imu
        k = min(len(imu_acc), m_imu)
        np_dt = np.float32 if self.dtype == torch.float32 else np.float64
        A = np.zeros((m_imu, 3), np_dt)
        G = np.zeros((m_imu, 3), np_dt)
        Tt = np.full(m_imu, np.inf, np_dt)
        Mk = np.zeros(m_imu, bool)
        A[:k], G[:k], Tt[:k], Mk[:k] = imu_acc[:k], imu_gyr[:k], imu_t[:k], True
        return A, G, Tt, Mk

    def _pack_quant(self, P, T, V, A, G, Tt, Mk, last_end_rel, scan_end_t):
        """One scan -> (bulk uint16 row, meta f32 row) of the quantized
        wire format (reference :975-998): the C++ packer where
        io/native.py has built it, else the numpy formula."""
        n_raw, m_imu = self.cfg.shapes.n_raw, self.cfg.shapes.n_imu
        dur = max(float(scan_end_t), 1e-9)
        bulk = native.pack_quant_bulk(P, T, POS_SCALE, dur)
        if bulk is None:
            bulk = np.zeros(3 * n_raw + n_raw // 2, np.uint16)
            qp = np.clip(np.round(P / POS_SCALE), -32767,
                         32767).astype(np.int16)
            bulk[:3 * n_raw] = qp.reshape(-1).view(np.uint16)
            t8 = np.clip(np.round(T / dur * 255.0), 0, 255).astype(np.uint16)
            bulk[3 * n_raw:] = t8[0::2] | (t8[1::2] << 8)
        meta = np.zeros(8 * m_imu + 4, np.float32)
        im = meta[:8 * m_imu].reshape(m_imu, 8)
        im[:, 0:3] = A
        im[:, 3:6] = G
        im[:, 6] = np.where(Mk, Tt, 0.0)
        im[:, 7] = Mk
        meta[8 * m_imu:] = [float(V.sum()), last_end_rel, scan_end_t, 1.0]
        return bulk, meta

    def _record(self, v: np.ndarray, wait=None) -> dict:
        """The result dict of a scan's readback `v`; while traced, with the
        scan's trace record (`wait`: the host's wait for `v`, ns)."""
        t_record = time.perf_counter_ns() if self._tracer is not None else 0
        out = {
            "pos": v[0:3],
            "quat": v[3:7],
            "n_ds": int(v[7]),
            "map_voxels": int(v[8]),
            "prop_pos": v[9:12],  # post-predict state (mat_pre analog)
            "prop_quat": v[12:16],
            "vel": v[16:19],
            "bg": v[19:22],
            "ba": v[22:25],
            "grav": v[25:28],
            "n_eff": int(v[28]),
            # the update's ESIKF passes and lazy refresh (run even where
            # the gate drops the update)
            "iters": int(v[29]),
            "refreshed": bool(v[30]),
        }
        self.trajectory.append(v[0:7].copy())
        if self._tracer is not None:
            scan, stamp, sites, host = self._trace_meta.popleft()
            host["lio.host.wait"] = wait
            rec = self._tracer.record(v[32:], sites, scan, stamp, host)
            out["trace"] = rec
            self.traces.append(rec)
            host["lio.host.record"] = (t_record, time.perf_counter_ns())
        return out

    # -- window mode --------------------------------------------------------
    def _pack_window(self, buf: list[tuple]) -> torch.Tensor:
        """The W buffered scans as ONE (W, R) host tensor (pinned when the
        pipeline runs on CUDA; per scan W = 1): quantized, int16 rows
        [bulk | pad | meta as int16 pairs]; else rows of the pipeline
        dtype [pts | pt_t | pt_valid | imu acc | gyr | t | mask |
        last_end_rel | scan_end_t | scan_valid].  Rows past the buffered
        scans are zeros (scan_valid 0), as the reference pads the tail."""
        W, (n, m) = self.window, (self._n_pts, self.cfg.shapes.n_imu)
        if self.quantized:
            L, Lp = 3 * n + n // 2, _bulk_cols(n)
            R, dt = Lp + 2 * (8 * m + 4), torch.int16
        else:
            R, dt = 5 * n + 8 * m + 3, self.dtype
        host = torch.zeros((W, R), dtype=dt,
                           pin_memory=self.device.type == "cuda")
        rows = host.numpy()
        for i, entry in enumerate(buf):
            if self.quantized:
                bulk, meta = entry
                rows[i, :L] = bulk.view(np.int16)
                rows[i, Lp:] = meta.view(np.int16)
            else:
                P, T, V, A, G, Tt, Mk, ler, set_ = entry
                rows[i] = np.concatenate([
                    P.reshape(-1), T, V, A.reshape(-1), G.reshape(-1), Tt, Mk,
                    [ler, set_, 1.0]])
        return host

    def _dispatch_window(self) -> None:
        """Run the buffered scans as one W-scan window: one host->device
        copy, the ticks (graph replays for the sync-free steady program),
        and one readback, consumed now or (pipelined) later."""
        W = self.window
        buf, self._wbuf = self._wbuf, []
        n_valid = len(buf)
        done = self._scans_dispatched
        self._scans_dispatched = done + n_valid
        # warmup windows (rounded up to whole windows) run the 5-NN step
        steady = done >= self._warmup_scans
        if steady:
            self._ensure_dmom()
        if self._acc_t is None:  # read by the window ticks and the graph
            self._acc_t = self._t(self.acc_norm)
        win = self._pack_window(buf).to(self.device, non_blocking=True)
        if steady and self._graphed and self._step.sync_free:
            infos = self._run_graph(win)
        else:
            wstep = _window_fn(self._tick if steady else self._tick_warm, W)
            self.ls, infos = wstep(self.ls, self._view(win),
                                   self._acc_t)
        self._pending_ws.append((readback_async(infos), n_valid))
        if not self.pipelined:
            self._consume_pending(self._pending_ws)
            self._pending_ws = []
        elif len(self._pending_ws) > self.readback_depth:
            # consume every window but the one just dispatched, so the
            # wait never covers the newest window's compute
            ready, self._pending_ws = (self._pending_ws[:-1],
                                       self._pending_ws[-1:])
            self._consume_pending(ready)

    def _run_graph(self, win: torch.Tensor) -> torch.Tensor:
        """The window's ticks as graph replays; the first steady window
        runs its first graph's worth of ticks eagerly as the warm-up and
        captures the graph from the state they leave."""
        W = self.window
        U = graphs.graph_steps(W, self.unroll)
        infos = torch.empty((W, 32), dtype=torch.float32, device=self.device)
        start = 0
        if self.graph is None:
            self.graph = graphs.StepGraph(
                _window_fn(self._tick, U), self._view, U, self._acc_t)
            self._graph_of = "steady"
            self.ls, infos[:U] = self.graph.warm_up_and_capture(
                self.ls, win[:U])
            start = U
        for k in range(start, W, U):
            infos[k:k + U] = self.graph.replay(win[k:k + U])
        self.ls = self.graph.ls
        return infos

    def _consume_pending(self, pending: list[tuple]) -> None:
        for rb, n_valid in pending:
            v = readback_wait(rb)
            for i in range(n_valid):
                self._results.append(self._record(v[i]))

    def poll(self) -> int:
        """Harvest every pending window readback now (blocks until the
        device has finished them) without feeding a scan; returns the
        number of results made available (popped by the next
        process_scan, or read from `trajectory`).  Window mode only."""
        if not self._use_window or not self._pending_ws:
            return 0
        p, self._pending_ws = self._pending_ws, []
        n0 = len(self._results)
        self._consume_pending(p)
        return len(self._results) - n0

    def flush(self):
        """Drain buffered scans and pending readbacks (call at the end).
        Returns the final scan's result dict (None if nothing was
        pending); every drained result is appended to `trajectory` in
        order."""
        if self._use_window:
            if self._wbuf:
                self._dispatch_window()
            if self._pending_ws:
                p, self._pending_ws = self._pending_ws, []
                self._consume_pending(p)
            out = self._results[-1] if self._results else None
            self._results = []
            return out
        if self._pending_info is None:
            return None
        rb, self._pending_info = self._pending_info, None
        return self._wait_record(rb)
