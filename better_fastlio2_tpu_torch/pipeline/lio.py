"""LIO odometry pipeline — one scan tick of the mapping main loop.

Port of better_fastlio2_tpu/pipeline/lio.py (laserMapping.cpp:2225-2460),
per-scan mode:

    IMU forward propagation + undistortion      (ImuProcess::Process)
    moving-FoV map crop                         (lasermap_fov_segment)
    scan voxel downsample                       (VoxelGrid, :2322)
    iterated ESIKF point-to-plane update        (update_iterated_dyn_share_modified)
    map incremental insert                      (map_incremental)

The JAX reference runs the tick as one jitted device program; here it is
eager PyTorch on the chosen device, with host reads where the reference
branched on the device (counted by utils.device.host_syncs): the update
gate, one or two per ESIKF pass, one per insert claim round, and the one
flat 32-float info readback per scan.

Ported: the fused single-association solve (slice 1), the ESIKF row path
(slice 2: reference re-association or single association, with or without
extrinsic estimation) over the 5-NN association and the voxel-hash insert,
grouped or pre-grouped, and the bench configuration (slice 3): the plane
cache with its 5-NN warmup program, the budgeted moment inserts, the
dense-moment steady program (mom_dense) and the compacted solve.  The map
rebuild, feature extraction, the windowed and pipelined modes and mesh
mode raise NotImplementedError naming the slice that brings them.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import LIOConfig, derive_map_dense_log2
from ..core import esikf, imu, measurement
from ..core.state import State
from ..map import voxel_hash
from ..ops.downsample import voxel_downsample
from ..utils import so3
from ..utils.device import resolve_device, to_host

__all__ = ["LIOState", "LIOPipeline", "make_step_fn", "check_config"]

MOV_THRESHOLD = 1.5  # laserMapping.cpp MOV_THRESHOLD

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
    kd = cfg.ikdtree
    checks = [
        (kd.recontruct_kdtree, "ikdtree.recontruct_kdtree",
         "a later slice (map rebuild)"),
        (cfg.preprocess.feature_extract_enable,
         "preprocess.feature_extract_enable", "the host I/O slice"),
        (cfg.dtype not in _DTYPES, f"dtype {cfg.dtype!r}", "no slice"),
    ]
    for bad, what, where in checks:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet: it comes with {where}")


def _fov_segment(ls: LIOState, pos_lid: torch.Tensor, cube_len,
                 det_range, skip_points: bool = False,
                 no_crop: bool = False) -> LIOState:
    """Moving-cube local map management (laserMapping.cpp:1136-1200), all
    on the device: the first scan centres the cube on the lidar, later
    scans shift it by `mov` along each axis whose face came within
    MOV_THRESHOLD * det_range, and a shift crops the map to the new box.
    skip_points: see crop_outside_box (the steady plane-cache program).
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
                 plane_cache: bool | None = None):
    """The one-scan tick on `device`:

    step(ls, pts, pt_t, pt_valid, imu_b, last_end_rel, scan_end_t,
         acc_norm) -> (ls', info_vec)

    pts (n_raw, 3) lidar-frame points, pt_t (n_raw,) offsets from the scan
    begin, IMU times relative to the scan begin, scan_end_t the scan
    duration, last_end_rel the previous scan's end relative to this scan's
    begin (computed on the host in f64: absolute epoch stamps never reach
    the device).  The map tensors are updated in place (the reference
    donates its state buffers the same way).

    plane_cache overrides cfg.ikdtree.plane_cache when not None: the
    pipeline builds the 5-NN warmup program with plane_cache=False beside
    the plane-cache one.  The plane-cache program under a warmup split is
    the steady program: its crop skips the points, its insert takes the
    budgets and touches only the moments (moments_only), or, with
    mom_dense, writes only the dense moment table and the crop is
    replaced by torus-wrap forgetting."""
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
    if mom_dense:
        clip_hw = torch.tensor(_mom_dense_window(cfg), dtype=dtype,
                               device=device)
        dshape = tuple(1 << b for b in sh.map_dense_log2) + (2,)
    # the insert budgets and the moment freeze belong to the steady program
    budgets = (dict(claim_budget=sh.insert_claim_budget,
                    dense_budget=sh.insert_dense_budget) if steady else {})

    def step(ls: LIOState, pts, pt_t, pt_valid, imu_b: imu.ImuBatch,
             last_end_rel, scan_end_t, acc_norm):
        # ---- IMU forward propagation + backward undistortion -------------
        with record_function("lio.imu"):
            x_prop, P_prop, poses = imu.propagate(
                ls.x, ls.P, imu_b, Q, acc_norm, last_end_rel, scan_end_t,
                ls.last_acc_w, ls.last_gyr_b)
            pts_body = imu.undistort(x_prop, poses, pts, pt_t)

        # ---- local map FoV crop around the lidar position -----------------
        with record_function("lio.fov_crop"):
            pos_lid = x_prop.pos + so3.quat_rotate(x_prop.rot, x_prop.off_t)
            ls = _fov_segment(ls, pos_lid, mp.cube_len, mp.det_range,
                              skip_points=steady, no_crop=mom_dense)

        # ---- scan downsample ---------------------------------------------
        with record_function("lio.downsample"):
            pts_ds, ds_valid = voxel_downsample(
                pts_body, pt_valid, mp.surf_leaf_size, out_size=sh.n_ds,
                packed_key=packed_key, drop_high_z=sh.ds_drop_high_z)

        # ---- iterated ESIKF update (host gate: one read) ------------------
        n_valid = torch.sum(ds_valid.to(torch.int32))
        n_valid_h, inited = to_host(torch.stack(
            [n_valid, ls.ekf_inited.to(torch.int32)]))
        if inited and n_valid_h >= 5:  # laserMapping.cpp:2347
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
                solve_compact=sh.solve_compact,
                assoc_cells=sh.assoc_cells,
            )
            with record_function("lio.update"):
                x_post, P_post, _, info_u = esikf.update_iterated(
                    x_prop, P_prop, measure, aux0,
                    max_iter=kd.max_iteration, n_cols=n_cols)
            n_eff = info_u["n_eff"].to(dtype)
        else:
            x_post, P_post = x_prop, P_prop
            n_eff = torch.zeros((), dtype=dtype, device=device)

        # ---- map incremental insert --------------------------------------
        with record_function("lio.insert"):
            pts_world = measurement.transform_to_world(x_post, pts_ds)
            if mom_dense:
                # one header gather and one budgeted row scatter into the
                # dense moment table, inside the sensor-centred window;
                # the hash keys, slot index and buckets stay as the
                # warmup left them
                ins_valid = ds_valid & torch.all(
                    torch.abs(pts_world - pos_lid) <= clip_hw, dim=-1)
                voxel_hash.insert_dense_moments(
                    ls.map.dmom, dshape, ls.map.voxel_size, pts_world,
                    ins_valid, mom_cap=kd.mom_cap,
                    mom_budget=max(sh.insert_mom_budget, 1024))
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
        # every per-scan output in ONE flat f32 vector (one readback):
        #   [0:3] post pos  [3:7] post quat  [7] n_valid  [8] map voxels
        #   [9:12] prop pos  [12:16] prop quat  [16:19] vel  [19:22] bg
        #   [22:25] ba  [25:28] grav  [28] n_eff  [29:32] pad
        f32 = torch.float32
        info_vec = torch.cat([
            x_post.pos.to(f32), x_post.rot.to(f32),
            torch.stack([n_valid.to(f32), voxel_hash.num_voxels(m).to(f32)]),
            x_prop.pos.to(f32), x_prop.rot.to(f32), x_post.vel.to(f32),
            x_post.bg.to(f32), x_post.ba.to(f32), x_post.grav.to(f32),
            n_eff[None].to(f32), torch.zeros(3, dtype=f32, device=device),
        ])
        return ls, info_vec

    return step


class LIOPipeline:
    """Host-side loop: IMU init bookkeeping + one scan tick per call.

    The analog of the reference main() loop: the first MAX_INI_COUNT IMU
    samples run static initialisation (IMU_Processing.hpp:393-433), then
    every scan runs the tick.  With the plane cache the first
    `plane_cache_warmup` scans run the 5-NN warmup program while the
    moments densify, then the steady program; under mom_dense the slot
    moments move into the dense moment table once, right before the
    first steady scan.  Runs on ``cuda`` unless `device` names another
    device; raises if no GPU is present and no device was named.
    """

    MAX_INI_COUNT = 10  # IMU_Processing.hpp:4

    def __init__(self, cfg: LIOConfig, device=None, pipelined: bool = False,
                 window: int = 1, quantized: bool = False, mesh=None):
        self.device = resolve_device(device)
        if pipelined or window != 1 or quantized or mesh is not None:
            raise NotImplementedError(
                "pipelined readback, window > 1, the quantized wire format "
                "and mesh mode come with a later slice of the port (CUDA "
                "graphs / torch.distributed)")
        self.cfg = cfg
        self._step = make_step_fn(cfg, self.device)  # validates cfg
        kd = cfg.ikdtree
        # plane-cache warmup: the 5-NN association for the first scans,
        # while the moment cache densifies (its n >= 5 gate starves on a
        # young map), then the plane-cache program
        self._warmup_scans = kd.plane_cache_warmup if kd.plane_cache else 0
        if self._warmup_scans > 0:
            self._step_warm = make_step_fn(cfg, self.device,
                                           plane_cache=False)
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
        self._init_acc: list[np.ndarray] = []
        self._init_gyr: list[np.ndarray] = []
        self.inited = False
        self.acc_norm = 9.81
        self.ls: LIOState | None = None
        self.last_scan_end_abs: float | None = None  # f64 host clock
        self.trajectory: list[np.ndarray] = []

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
        Returns an info dict, or None while initialising or for a dropped
        group."""
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

        P, T, V = self._pad_points(pts, pt_t)
        A, G, Tt, Mk = self._pad_imu(imu_acc, imu_gyr, imu_t)
        self._scan_count += 1
        if self._scan_count > self._warmup_scans:
            self._ensure_dmom()
            step = self._step
        else:
            step = self._step_warm
        # f64 host clock: only relative times reach the device
        last_end_rel = (self.last_scan_end_abs - scan_beg_abs
                        if self.last_scan_end_abs is not None else 0.0)
        self.last_scan_end_abs = scan_beg_abs + scan_end_t

        batch = imu.ImuBatch(acc=self._t(A), gyr=self._t(G), t=self._t(Tt),
                             mask=self._t(Mk, torch.bool))
        self.ls, info_vec = step(
            self.ls, self._t(P), self._t(T), self._t(V, torch.bool), batch,
            self._t(last_end_rel), self._t(scan_end_t), self._t(self.acc_norm))
        return self._record(np.asarray(to_host(info_vec), np.float32))

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

    def _record(self, v: np.ndarray) -> dict:
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
        }
        self.trajectory.append(v[0:7].copy())
        return out
