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

Ported: the fused single-association solve (slice 1) and the ESIKF row
path (slice 2: reference re-association or single association, with or
without extrinsic estimation), over the 5-NN association and the voxel-hash
insert, grouped or pre-grouped.  Everything else (the plane cache and the
rest of the bench configuration, the map rebuild, feature extraction)
raises NotImplementedError naming the slice that brings it.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import LIOConfig
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
    kd, sh = cfg.ikdtree, cfg.shapes
    bench = "the bench-configuration slice (plane cache, mom_dense)"
    checks = [
        (kd.plane_cache, "plane_cache", bench),
        (kd.mom_dense, "mom_dense", bench),
        (sh.solve_compact > 0, "shapes.solve_compact", bench),
        (sh.insert_claim_budget > 0 or sh.insert_dense_budget > 0
         or sh.insert_mom_budget > 0, "the insert budgets", bench),
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
                 det_range) -> LIOState:
    """Moving-cube local map management (laserMapping.cpp:1136-1200), all
    on the device: the first scan centres the cube on the lidar, later
    scans shift it by `mov` along each axis whose face came within
    MOV_THRESHOLD * det_range, and a shift crops the map to the new box."""
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
    need_crop = init & torch.any(near_lo | near_hi)
    m = voxel_hash.crop_outside_box(ls.map, lo, hi, enabled=need_crop)
    return ls._replace(map=m, cube_lo=lo, cube_hi=hi,
                       cube_init=torch.ones_like(init))


def make_step_fn(cfg: LIOConfig, device: torch.device):
    """The one-scan tick on `device`:

    step(ls, pts, pt_t, pt_valid, imu_b, last_end_rel, scan_end_t,
         acc_norm) -> (ls', info_vec)

    pts (n_raw, 3) lidar-frame points, pt_t (n_raw,) offsets from the scan
    begin, IMU times relative to the scan begin, scan_end_t the scan
    duration, last_end_rel the previous scan's end relative to this scan's
    begin (computed on the host in f64: absolute epoch stamps never reach
    the device).  The map tensors are updated in place (the reference
    donates its state buffers the same way)."""
    check_config(cfg)
    sh, mp, kd = cfg.shapes, cfg.mapping, cfg.ikdtree
    dtype = _DTYPES[cfg.dtype]
    packed_key = (2.2 * mp.det_range / mp.surf_leaf_size) < 1000.0
    n_cols = 12 if mp.extrinsic_est_en else 6
    # downsample centroids at the map's own leaf are one row per map voxel
    pre_grouped = mp.surf_leaf_size == kd.filter_size_map_min
    Q = imu.build_Q(mp.gyr_cov, mp.acc_cov, mp.b_gyr_cov, mp.b_acc_cov, dtype,
                    device)

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
            ls = _fov_segment(ls, pos_lid, mp.cube_len, mp.det_range)

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
                fused_solve=kd.fused_solve,
                early_converge=kd.early_converge,
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
            m = voxel_hash.insert(ls.map, pts_world, ds_valid,
                                  max_probe=sh.map_max_probe,
                                  pre_grouped=pre_grouped)

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
    every scan runs the tick.  Runs on ``cuda`` unless `device` names
    another device; raises if no GPU is present and no device was named.
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
            dense_log2=sh.map_dense_log2)

        def z3():
            return torch.zeros(3, dtype=self.dtype, device=self.device)

        false = torch.zeros((), dtype=torch.bool, device=self.device)
        return LIOState(x=x, P=P, map=m, cube_lo=z3(), cube_hi=z3(),
                        cube_init=false, last_acc_w=z3(), last_gyr_b=z3(),
                        ekf_inited=false.clone())

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
        # f64 host clock: only relative times reach the device
        last_end_rel = (self.last_scan_end_abs - scan_beg_abs
                        if self.last_scan_end_abs is not None else 0.0)
        self.last_scan_end_abs = scan_beg_abs + scan_end_t

        batch = imu.ImuBatch(acc=self._t(A), gyr=self._t(G), t=self._t(Tt),
                             mask=self._t(Mk, torch.bool))
        self.ls, info_vec = self._step(
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
