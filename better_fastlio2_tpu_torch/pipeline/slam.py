"""Full SLAM pipeline: LIO front end + keyframes + loops + pose graph.

Port of better_fastlio2_tpu/pipeline/slam.py, the back-end orchestration
of the reference's mapping node (src/laserMapping.cpp):

  saveFrame                 :525-547  keyframe gating (dist/angle)
  addOdomFactor             :550-582  odom between-factors
  performLoopClosure        :890-1018 radius+time candidate, submaps,
                                      Scan Context gate, yaw pre-align,
                                      ICP verify, loop factor
  saveKeyFramesAndFactor    :680-766  optimize, feed pose back to filter
  correctPoses              :769-805  rewrite keyframe poses after loop

The sync mode runs loop closure every `loop_every` keyframes;
async_backend=True moves detection, Scan Context gating and ICP
verification onto a worker thread (the loopClosureThread analog) and the
pose-graph optimization onto parallel.distributed.AsyncBackend, with the
results applied by the feed thread on a later scan.  The front end runs
on the pipeline's device; the back end (descriptors, ICP, pose graph) on
the host CPU with backend_on_host=True, as the reference pins it, else on
the same device.  Keyframe clouds and timestamps live on the host.

Every state the back end hands to the front end (the pose feedback of a
correction, the non-finite rollback, the map reset after a jump) goes
through `LIOPipeline.ls`'s setter, which reaches a captured CUDA graph.
Nothing here is compiled ahead, so the reference's compile-priming block
has no counterpart.

Live dynamic-object removal (cfg.dynamic_removal, the integration the
reference shipped commented out, laserMapping.cpp:2271-2307) runs before
each scan enters the front end: Patchwork ground, curved-voxel clusters
and either the overlap tracker against the grid `dyn_track_gap` scans
back or the K-frame world-occupancy appearance test.  The perception runs
on the front end's device in cfg.dtype; its pose extrapolation from the
front end's trajectory runs on the host in f32, as the reference's.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import posegraph as pg
from ..config import LIOConfig
from ..ops import icp as icp_ops
from ..ops import scancontext as sc
from ..perception import dynamic as dyn
from ..perception import patchwork
from ..utils import se3, so3
from .lio import _DTYPES, LIOPipeline

__all__ = ["Keyframe", "SLAMPipeline"]

_F64 = torch.float64


def _h(a) -> torch.Tensor:
    """A host f64 tensor of an array (the back end's small-op pose math)."""
    return torch.as_tensor(np.asarray(a, np.float64))


@dataclass
class Keyframe:
    idx: int
    t: float
    pose: np.ndarray  # (7,) current best estimate [wxyz|t]
    odom_pose: np.ndarray  # (7,) pose at creation (odometry frame)
    cloud: np.ndarray  # (n, 3) body-frame points
    desc: np.ndarray  # (20, 60) scan context


class SLAMPipeline:
    """LIOPipeline + pose-graph back end, mirroring the mapping node."""

    # fixed padded sizes of the loop-verification calls (the reference's
    # static shapes; the valid masks make padded rows no-ops)
    _CUR_PAD = 8192
    _OLD_PAD = 20480

    def __init__(self, cfg: LIOConfig, max_keyframes: int = 2048,
                 loop_every: int = 5, sc_params: sc.SCParams | None = None,
                 async_backend: bool = False,
                 lio_kwargs: dict | None = None,
                 backend_on_host: bool = False, device=None):
        """async_backend=True runs pose-graph optimization and loop
        verification off the feed thread; corrections land on a later
        scan.  lio_kwargs forwards LIOPipeline options (window=W,
        quantized=True, unroll=W — bench.py's configuration); results then
        lag by up to a window and a scan FIFO pairs each with its raw
        points.  The front end runs on `device` (cuda unless named);
        backend_on_host=True runs the back end's tensors on the CPU (the
        reference's CPU back-end thread, laserMapping.cpp:1021-1038),
        else on the front end's device."""
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        # pipelined: each result describes an earlier scan, paired with
        # its raw points through the FIFO
        self.lio = LIOPipeline(cfg, device=device, pipelined=True,
                               **(lio_kwargs or {}))
        self.backend_device = (torch.device("cpu") if backend_on_host
                               else self.lio.device)
        self._scan_fifo: deque = deque()
        self.sc_params = sc_params or sc.SCParams()
        self.keyframes: list[Keyframe] = []
        self.loop_pairs: list[tuple[int, int, float]] = []  # (i, j, fitness)
        self.loop_every = loop_every
        self._kf_count_at_last_loop = 0
        self.graph = pg.make_graph(
            max_poses=max_keyframes, max_priors=8,
            max_between=4 * max_keyframes,
            max_gps=max_keyframes if cfg.gps.enable else 0,
            dtype=self.dtype, device=self.backend_device)
        self._graph_dirty = False
        # GPS stream buffer + factor bookkeeping (addGPSFactor analog)
        self._gps_buf: list[tuple[float, np.ndarray, float]] = []
        self._gps_added = 0
        self._last_gps_pos: np.ndarray | None = None
        self._async = None
        if async_backend:
            from ..parallel.distributed import AsyncBackend

            self._async = AsyncBackend(device=self.backend_device)
        # the loop worker (loopClosureThread): detection, submaps, the
        # Scan Context gate and ICP off the feed thread; the feed thread
        # applies the verified factors
        self._loop_async = bool(async_backend and cfg.loop.enable)
        self._loop_inflight = 0
        if self._loop_async:
            self._loop_req: queue.Queue = queue.Queue(maxsize=2)
            self._loop_res: queue.Queue = queue.Queue()
            self._loop_thread = threading.Thread(
                target=self._loop_thread_main, daemon=True)
            self._loop_thread.start()
        # live dynamic removal: the perception parameters and the tracking
        # histories (the grids `gap` scans back, or the appearance test's
        # K-frame world keys and sensor positions)
        h = cfg.sensor_height
        self._ssc_params = dyn.SSCParams(
            sensor_height=cfg.ssc_sensor_height or h)
        self._pw_params = patchwork.PatchworkParams(sensor_height=h)
        self._grid_hist: deque = deque(
            maxlen=max(1, int(cfg.dyn_track_gap)))
        K = max(4, int(cfg.dyn_track_k))
        self._app_hist: deque = deque(maxlen=K)
        self._app_sens: deque = deque(maxlen=K + 1)
        self._app_n = 0  # appearance-mode scan counter (dump names)
        self._dyn_dump_idx = 0
        self.dynamic_dump_dir: str | None = None
        self.last_dynamic_mask: np.ndarray | None = None

    def _bt(self, a, dtype=None) -> torch.Tensor:
        """A back-end tensor (the pipeline dtype unless given)."""
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.backend_device)

    def close(self) -> None:
        """Stop the loop worker thread (at the end of a run)."""
        if self._loop_async:
            self._loop_req.put(None)
            self._loop_thread.join()
            self._loop_async = False

    def flush(self):
        """Drain the front end's buffered window and readbacks (end of
        stream).  The trailing results land in lio.trajectory without
        keyframing; in-flight loop verifications and the async
        optimization are drained, and factors that landed after the last
        optimization get a final one.  Returns the last drained LIO
        result or None."""
        out = self.lio.flush()
        self._scan_fifo.clear()
        if self._loop_async and self._loop_inflight > 0:
            applied = False
            while self._loop_inflight > 0:
                res = self._loop_res.get()
                self._loop_inflight -= 1
                if self._take_loop_result(res):
                    applied = True
            if applied:
                self._graph_dirty = True
        if self._async is not None and self._async.busy:
            res = self._async.wait()
            if res is not None:
                poses, n_snap = res
                self._apply_correction(np.asarray(poses, np.float64),
                                       n=n_snap)
        if self._graph_dirty:
            self._optimize_and_correct()
            self._graph_dirty = False
        return out

    # -- keyframe gating (saveFrame, laserMapping.cpp:525-547) -------------
    def _is_keyframe(self, pose7: np.ndarray) -> bool:
        """The reference's gate on the distance and on PER-AXIS roll,
        pitch and yaw of the between rotation (:537-543), in numpy."""
        if not self.keyframes:
            return True
        prev = self.keyframes[-1].pose
        d = float(np.linalg.norm(pose7[4:7] - prev[4:7]))
        # relative quaternion prev^-1 * cur -> rpy (ZYX convention)
        pw, px, py, pz = prev[0:4]
        cw, cx, cy, cz = pose7[0:4]
        rw = pw * cw + px * cx + py * cy + pz * cz
        rx = pw * cx - px * cw - py * cz + pz * cy
        ry = pw * cy + px * cz - py * cw - pz * cx
        rz = pw * cz - px * cy + py * cx - pz * cw
        roll = np.arctan2(2 * (rw * rx + ry * rz),
                          1 - 2 * (rx * rx + ry * ry))
        pitch = np.arcsin(np.clip(2 * (rw * ry - rz * rx), -1.0, 1.0))
        yaw = np.arctan2(2 * (rw * rz + rx * ry),
                         1 - 2 * (ry * ry + rz * rz))
        mp = self.cfg.mapping
        thr = mp.keyframe_adding_angle_threshold
        return (d > mp.keyframe_adding_dist_threshold
                or abs(float(roll)) > thr or abs(float(pitch)) > thr
                or abs(float(yaw)) > thr)

    # -- GPS stream (addGPSFactor analog; reference stub :689) -------------
    def feed_gps(self, t_abs: float, pos, cov: float | None = None):
        """Buffer one GPS fix (world position, optional position cov in
        m^2).  Keyframes created near `t_abs` (within gps.max_age) pick
        it up as a unary factor, spaced >= gps.min_dist apart."""
        self._gps_buf.append((float(t_abs), np.asarray(pos, np.float64),
                              float(cov) if cov is not None else -1.0))
        if len(self._gps_buf) > 1024:
            self._gps_buf = self._gps_buf[-512:]

    def _maybe_add_gps(self, kf: Keyframe):
        g = self.cfg.gps
        if not g.enable or not self._gps_buf:
            return
        ts = np.array([b[0] for b in self._gps_buf])
        covs = np.array([b[2] for b in self._gps_buf])
        # candidates in the pairing window that pass the gpsCovThreshold
        # gate: lowest covariance first, then closest in time
        ok = (np.abs(ts - kf.t) <= g.max_age) & ~(
            (covs >= 0.0) & (covs > g.cov_threshold))
        if not ok.any():
            return
        cand = np.nonzero(ok)[0]
        j = int(cand[np.lexsort((np.abs(ts[cand] - kf.t), covs[cand]))[0]])
        _, pos_g, cov = self._gps_buf[j]
        if (self._last_gps_pos is not None
                and np.linalg.norm(pos_g - self._last_gps_pos) < g.min_dist):
            return
        pos = pos_g.copy()
        if not g.use_elevation:
            pos[2] = kf.pose[6]  # keep the odometry height (LIO-SAM)
        sigma = float(np.sqrt(cov)) if cov > 0 else g.sigma
        self.graph = pg.add_gps(self.graph, kf.idx, self._bt(pos), sigma)
        self._gps_added += 1
        self._last_gps_pos = pos_g

    def process_scan(self, pts, pt_t, imu_acc, imu_gyr, imu_t,
                     scan_beg_abs, scan_end_t):
        # optional live dynamic-object removal: segment the ground,
        # cluster the rest, drop the clusters tracked as moving
        if self.cfg.dynamic_removal:
            pts, pt_t = self._remove_dynamic(pts, pt_t)
        tracked = self.lio.inited  # this scan will yield a result later
        out = self.lio.process_scan(pts, pt_t, imu_acc, imu_gyr, imu_t,
                                    scan_beg_abs, scan_end_t)
        if tracked:
            self._scan_fifo.append((pts, scan_beg_abs, scan_end_t))
        if out is None or not self._scan_fifo:
            return None
        # `out` is the OLDEST unconsumed scan's: pair it with its points
        pts, scan_beg_abs, scan_end_t = self._scan_fifo.popleft()
        if (np.any(~np.isfinite(out["pos"]))
                or np.any(~np.isfinite(out["quat"]))):
            # check_safe_update analog (esekfom.hpp:1991-2008): refuse a
            # non-finite estimate, roll the filter back to the last
            # keyframe pose
            if self.keyframes:
                last = self.keyframes[-1].pose
                ls = self.lio.ls
                self.lio.ls = ls._replace(x=ls.x._replace(
                    pos=self.lio._t(last[4:7]), rot=self.lio._t(last[0:4])))
            return None
        pose7 = np.concatenate([out["quat"], out["pos"]]).astype(np.float64)

        # a finished async optimization applies with n = the keyframe
        # count AT SNAPSHOT time: keyframes created while it ran are
        # shifted by the last optimized keyframe's correction instead
        if self._async is not None:
            res = self._async.poll()
            if res is not None:
                poses, n_snap = res
                self._apply_correction(np.asarray(poses, np.float64),
                                       n=n_snap)

        closed = self._loop_async and self._poll_loop_results()
        if self._is_keyframe(pose7):
            self._add_keyframe(pose7, pts, scan_beg_abs + scan_end_t)
            self._maybe_add_gps(self.keyframes[-1])
            if (self.cfg.loop.enable
                    and len(self.keyframes) - self._kf_count_at_last_loop
                    >= self.loop_every):
                self._kf_count_at_last_loop = len(self.keyframes)
                if self._loop_async:
                    try:
                        self._loop_req.put_nowait(len(self.keyframes) - 1)
                        self._loop_inflight += 1
                    except queue.Full:
                        pass  # worker saturated: skip, like the 1 Hz thread
                else:
                    closed = self._try_loop_closure() or closed
            # optimize on a closed loop, or periodically once GPS factors
            # accumulate
            gps_due = (self._gps_added > 0
                       and len(self.keyframes) % self.loop_every == 0)
            closed = closed or gps_due
        if closed or self._graph_dirty:
            if self._async is not None:
                # False while an optimization is in flight: retry later
                ok = self._async.submit(self.graph, tag=len(self.keyframes))
                self._graph_dirty = not ok
            else:
                self._optimize_and_correct()
                self._graph_dirty = False
        out["n_keyframes"] = len(self.keyframes)
        out["n_loops"] = len(self.loop_pairs)
        return out

    # -- live dynamic removal (config-gated) --------------------------------
    def _pose_estimate(self):
        """(current scan's pose estimate, T_prev<-cur of the tracked grid)
        from the front end's trajectory, on the host in f32 as the
        reference computes them (the current scan's pose is extrapolated
        at constant velocity over the front end's result lag)."""
        gap = max(1, int(self.cfg.dyn_track_gap))
        traj = self.lio.trajectory
        ident = se3.identity(self.dtype)
        rel, cur_est = ident, None

        def t2pose(row):
            # trajectory rows are [pos(3) | quat(4)] (LIOPipeline._record);
            # se3 poses are [quat(4) | pos(3)]
            r = np.asarray(row, np.float32)
            return torch.as_tensor(np.concatenate([r[3:7], r[0:3]]))

        if len(traj) >= 1:
            # the newest result is `pend` scans older than the scan before
            # this one: in window mode the pending windows and the open
            # window's scans, per scan the one readback in flight
            lio = self.lio
            if lio._use_window:
                pend = (sum(nv for _, nv in lio._pending_ws)
                        + len(lio._wbuf))
            else:
                pend = 1 if lio._pending_info is not None else 0
            p_last = t2pose(traj[-1])
            step = (se3.between(t2pose(traj[-2]), p_last)
                    if len(traj) >= 2 else ident)
            cur_est = p_last
            for _ in range(pend + 1):
                cur_est = se3.compose(cur_est, step)
        if len(traj) >= gap + 1:
            # T_prev<-cur = prev^-1 * cur; the tracked grid's scan (`gap`
            # scans before this one) has pose trajectory[-gap]
            rel = se3.between(t2pose(traj[-gap]), cur_est).to(self.dtype)
        return cur_est, rel

    def _remove_dynamic(self, pts, pt_t):
        """The removal step of one scan: returns the kept (pts, pt_t) and
        sets last_dynamic_mask (the removed points)."""
        cfg, prm = self.cfg, self._ssc_params
        dev = self.lio.device
        p = torch.as_tensor(np.asarray(pts), dtype=self.dtype, device=dev)
        valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
        gm = patchwork.estimate_ground(p, valid, self._pw_params)
        cur_est, rel = self._pose_estimate()
        if cfg.dyn_track_mode == "appearance":
            keep, grid = self._appearance_keep(pts, p, valid, gm, cur_est)
        else:
            hist = self._grid_hist
            prev_grid = hist[0] if len(hist) == hist.maxlen else None
            static, grid = dyn.dynamic_removal_masks(
                p, valid, gm, prev_grid, rel.to(dev), prm)
            hist.append(grid)
            keep = static.cpu().numpy()
        # the removal decision, for the PR/RR/F1 evaluation
        self.last_dynamic_mask = ~keep
        # inspection dumps (saveColorCloud analog, tgrs.cpp:214-243): the
        # cluster-colored cloud and the removed points of each scan
        if self.dynamic_dump_dir:
            from ..io.pcd import write_pcd

            dump = self.dynamic_dump_dir
            os.makedirs(dump, exist_ok=True)
            k = self._dyn_dump_idx
            self._dyn_dump_idx = k + 1
            dyn.save_cluster_cloud(
                os.path.join(dump, f"{k:06d}_color.pcd"), pts, grid)
            removed = pts[~keep]
            if len(removed):
                write_pcd(os.path.join(dump, f"{k:06d}_removed.pcd"),
                          removed.astype(np.float32))
        return pts[keep], pt_t[keep]

    def _appearance_keep(self, pts, p, valid, gm, cur_est):
        """The K-frame world-occupancy appearance test (dyn_track_mode=
        "appearance"): a mover's current world voxels were free space
        ~2 s ago.  Returns (keep mask, grid)."""
        cfg, prm = self.cfg, self._ssc_params
        hist, sens = self._app_hist, self._app_sens
        K = hist.maxlen
        old_lo = max(2, int(round(K * 5 / 6)))  # frames 20..24 of 24
        band = ((valid & ~gm) & (p[:, 2] <= cfg.dyn_appear_z_band))
        grid = dyn.cluster_grid(dyn.encode_scan(p, band, prm), prm)
        band = band.cpu().numpy()
        lab_pt = dyn.point_labels(grid)
        cur_np = (cur_est.numpy().astype(np.float64) if cur_est is not None
                  else np.array([1.0, 0, 0, 0, 0, 0, 0]))
        R = so3.quat_to_matrix(torch.as_tensor(
            cur_np[0:4], dtype=self.dtype)).numpy().astype(np.float64)
        pts_w = np.asarray(pts, np.float64) @ R.T + cur_np[4:7]
        keys = dyn.world_voxel_keys(pts_w, cfg.dyn_appear_voxel)
        sens.append(cur_np[4:7].copy())
        dynmask = np.zeros(len(pts), bool)
        if len(hist) >= K:
            old_sorted = np.unique(np.concatenate(
                [hist[-k] for k in range(old_lo, K + 1)]))
            r_max = cfg.dyn_appear_range
            d_now = np.linalg.norm(pts_w - cur_np[4:7], axis=1)
            d_old = np.linalg.norm(pts_w - sens[0], axis=1)
            scored = band & (lab_pt >= 0) & (d_now <= r_max) & (
                d_old <= r_max)
            dynmask = dyn.appearance_dynamic_mask(
                keys, scored, band, lab_pt, old_sorted,
                thr_strong=cfg.dyn_appear_thr_strong,
                thr_weak=cfg.dyn_appear_thr_weak,
                min_cnt=cfg.dyn_appear_min_cnt,
                min_scored_frac=cfg.dyn_appear_min_scored_frac)
            # threshold-tuning dump: each scan's decision inputs, so a
            # threshold sweep replays offline (tools/tune_dynamic.py)
            dump_dir = os.environ.get("LIO_DYN_TUNE_DUMP")
            if dump_dir:
                os.makedirs(dump_dir, exist_ok=True)
                np.savez_compressed(
                    os.path.join(dump_dir, f"scan_{self._app_n:05d}.npz"),
                    keys=keys, scored=scored, band=band, lab_pt=lab_pt,
                    old_sorted=old_sorted, d_now=d_now.astype(np.float32),
                    d_old=d_old.astype(np.float32))
        hist.append(np.unique(keys[band & (lab_pt >= 0)]))
        self._app_n += 1
        return ~dynmask, grid

    # -- keyframe + odom factor (addOdomFactor, :550-582) ------------------
    def _add_keyframe(self, pose7, pts, t_abs):
        k = len(self.keyframes)
        sub = pts[::max(1, len(pts) // 4096)]
        buf, vmask = self._pad_fix(np.asarray(sub, np.float32),
                                   self._CUR_PAD)
        desc = sc.make_descriptor(
            self._bt(buf), self._bt(vmask, torch.bool),
            self.sc_params).cpu().numpy()
        kf = Keyframe(idx=k, t=t_abs, pose=pose7.copy(),
                      odom_pose=pose7.copy(), cloud=sub.astype(np.float32),
                      desc=desc)
        self.keyframes.append(kf)
        pose_t = self._bt(pose7)
        self.graph = pg.set_pose(self.graph, k, pose_t)
        if k == 0:
            # prior noise 1e-12 (laserMapping.cpp:556)
            self.graph = pg.add_prior(self.graph, 0, pose_t, 1e-6, 1e-6)
        else:
            rel = se3.between(self._bt(self.keyframes[-2].odom_pose),
                              self._bt(self.keyframes[-1].odom_pose))
            # between noise: rot 1e-6 var, trans 1e-4 var (:569)
            self.graph = pg.add_between(self.graph, k - 1, k, rel, 1e-2,
                                        1e-3)

    # -- loop detection (detectLoopClosureDistance, :815-850) --------------
    def _detect_candidate(self, cur_idx: int | None = None) -> int | None:
        if cur_idx is None:
            cur_idx = len(self.keyframes) - 1
        if cur_idx < 1:
            return None
        cur = self.keyframes[cur_idx]
        prev = self.keyframes[:cur_idx]
        ps = np.stack([k.pose[4:7] for k in prev])
        d = np.linalg.norm(ps - cur.pose[4:7], axis=1)
        ok = (d < self.cfg.loop.search_radius) & (
            np.array([abs(k.t - cur.t) for k in prev])
            > self.cfg.loop.search_time_diff)
        if not ok.any():
            return None
        return int(np.argmin(np.where(ok, d, np.inf)))

    # -- submap assembly (loopFindNearKeyframes, :856-883) -----------------
    def _submap(self, center_idx: int, half: int, frame_pose: np.ndarray,
                max_pts: int = 20000) -> np.ndarray:
        """The keyframe clouds of [center - half, center + half] in the
        frame of `frame_pose`, in f32 as the reference builds them."""
        lo = max(0, center_idx - half)
        hi = min(len(self.keyframes), center_idx + half + 1)
        f32 = torch.float32
        inv = se3.inverse(self._bt(frame_pose, f32))
        parts = []
        for k in range(lo, hi):
            kf = self.keyframes[k]
            w = se3.apply(self._bt(kf.pose, f32), self._bt(kf.cloud, f32))
            parts.append(se3.apply(inv, w).cpu().numpy())
        cat = np.concatenate(parts)
        if len(cat) > max_pts:
            cat = cat[::len(cat) // max_pts + 1]
        return cat

    # -- loop closure (performLoopClosure, :890-1018) ----------------------
    def _try_loop_closure(self) -> bool:
        res = self._loop_detect_verify(len(self.keyframes) - 1)
        if res is None:
            return False
        self._apply_loop_factor(*res)
        return True

    def _loop_thread_main(self):
        """Worker loop (loopClosureThread analog): one detection and
        verification per queued request; None ends it.  A failed attempt
        does not end the thread: its exception goes to the feed thread,
        which raises it."""
        while True:
            cur_idx = self._loop_req.get()
            if cur_idx is None:
                return
            try:
                with torch.no_grad():
                    res = self._loop_detect_verify(cur_idx)
            except Exception as e:  # handed to the feed thread, raised there
                res = e
            self._loop_res.put(res)

    def _take_loop_result(self, res) -> bool:
        """Apply one worker result; True if it added a factor."""
        if isinstance(res, Exception):
            raise RuntimeError("loop verification failed on the loop "
                               "worker") from res
        if res is None:
            return False
        self._apply_loop_factor(*res)
        return True

    def _apply_loop_factor(self, cand, cur_idx, rel_pose, sigma, fitness):
        """Feed-thread-only graph mutation for a verified loop."""
        self.graph = pg.add_between(self.graph, cand, cur_idx,
                                    self._bt(rel_pose), sigma, sigma)
        self.loop_pairs.append((cand, cur_idx, fitness))

    def _poll_loop_results(self) -> bool:
        """Drain finished worker verifications and apply their factors;
        True if any factor was added (an optimization is due)."""
        applied = False
        while self._loop_inflight > 0:
            try:
                res = self._loop_res.get_nowait()
            except queue.Empty:
                break
            self._loop_inflight -= 1
            applied = self._take_loop_result(res) or applied
        return applied

    @staticmethod
    def _pad_fix(pts: np.ndarray, size: int):
        n = min(len(pts), size)
        if len(pts) > size:
            pts = pts[::len(pts) // size + 1][:size]
            n = len(pts)
        buf = np.zeros((size, 3), np.float32)
        buf[:n] = pts[:n]
        valid = np.zeros(size, bool)
        valid[:n] = True
        return buf, valid

    def _loop_detect_verify(self, cur_idx: int):
        """Detection, the Scan Context gate and ICP verification (no graph
        mutation: it runs on the loop worker in async mode).  Returns
        (cand, cur_idx, rel_pose (7,), sigma, fitness) or None.  The SC
        distance and the ICP fitness are read on the host after their
        calls, as in the reference."""
        cand = self._detect_candidate(cur_idx)
        if cand is None:
            return None
        cur = self.keyframes[cur_idx]
        # pose snapshots: a concurrent _apply_correction may swap kf.pose
        cur_pose = cur.pose.copy()
        cand_pose = self.keyframes[cand].pose.copy()
        half = self.cfg.loop.search_num
        cur_local, cur_valid = self._pad_fix(
            self._submap(cur.idx, 0, cur_pose), self._CUR_PAD)
        old_local, old_valid = self._pad_fix(
            self._submap(cand, half, cand_pose), self._OLD_PAD)

        # Scan Context gate on the two submaps (:932-943)
        f32, b = torch.float32, torch.bool
        d1 = sc.make_descriptor(self._bt(cur_local, f32),
                                self._bt(cur_valid, b), self.sc_params)
        d2 = sc.make_descriptor(self._bt(old_local, f32),
                                self._bt(old_valid, b), self.sc_params)
        dist, shift = sc.sc_distance(d1, d2)
        if float(dist) > self.sc_params.dist_thresh:
            return None

        # yaw pre-alignment from the SC shift (:954-962)
        yaw0 = -float(shift) * 2.0 * np.pi / self.sc_params.num_sector
        init = se3.make(so3.quat_exp(self._bt([0.0, 0.0, yaw0])),
                        self._bt(np.zeros(3)))
        # ICP: the current keyframe cloud against the old submap, in the
        # old keyframe's frame through the current relative estimate
        rel_est = se3.between(self._bt(cand_pose), self._bt(cur_pose))
        res = icp_ops.icp_point2plane(
            self._bt(cur_local), self._bt(cur_valid, b),
            self._bt(old_local), self._bt(old_valid, b),
            se3.compose(init, rel_est) if abs(yaw0) > 0.3 else rel_est,
            max_corr=10.0, iters=25, voxel=1.0)
        fitness = float(res.fitness)
        if fitness > self.cfg.loop.fitness_score:
            return None
        # loop factor T_cand->cur, noise = fitness (:1010-1017)
        return (cand, cur.idx, res.pose.cpu().numpy().astype(np.float64),
                max(fitness, 1e-3), fitness)

    # -- optimize + correct (saveKeyFramesAndFactor/correctPoses) ----------
    def _optimize_and_correct(self):
        self.graph = pg.optimize(self.graph, iters=6, cg_iters=50)
        self._apply_correction(
            self.graph.poses.cpu().numpy().astype(np.float64),
            n=len(self.keyframes))

    def _apply_correction(self, poses: np.ndarray, n: int | None = None):
        """correctPoses (laserMapping.cpp:769-805) + filter feedback
        (kf.change_x, :744-754).  A stale async result (keyframes created
        after its snapshot) shifts the later keyframes and the live filter
        pose by the last optimized keyframe's correction.  A material jump
        rebuilds the front end's map from the corrected keyframe clouds
        (recontructIKdTree after correctPoses, :797-800)."""
        n = min(n if n is not None else len(self.keyframes),
                len(self.keyframes))
        if n == 0:
            return
        old_last = _h(self.keyframes[n - 1].pose)
        new_last = _h(poses[n - 1])
        delta = se3.compose(new_last, se3.inverse(old_last))
        for k in range(n):
            self.keyframes[k].pose = poses[k]
        if len(self.keyframes) > n:
            tail = np.stack([kf.pose for kf in self.keyframes[n:]])
            shifted = se3.compose(delta, _h(tail)).numpy()
            for i, kf in enumerate(self.keyframes[n:]):
                kf.pose = shifted[i]
        allp = np.stack([kf.pose for kf in self.keyframes])
        self.graph = pg.set_poses(self.graph, self._bt(allp),
                                  len(self.keyframes))
        # live filter pose: the same drift correction
        ls = self.lio.ls
        if ls is None:  # front end not initialised (offline correction)
            return
        cur = torch.cat([ls.x.rot.to(_F64), ls.x.pos.to(_F64)]).cpu()
        corrected = se3.compose(delta, cur).numpy()
        self.lio.ls = ls._replace(x=ls.x._replace(
            pos=self.lio._t(corrected[4:7]), rot=self.lio._t(corrected[0:4])))

        # a material jump leaves the map in the drifted frame: rebuild it
        # from the corrected keyframe clouds around the new pose (small
        # corrections stay below the association's voxel tolerance)
        d_np = delta.numpy()
        jump = float(np.linalg.norm(d_np[4:7]))
        ang = 2.0 * float(np.arccos(np.clip(abs(d_np[0]), -1.0, 1.0)))
        leaf = self.cfg.ikdtree.filter_size_map_min
        if jump > 0.5 * leaf or ang > 0.02:
            pos = corrected[4:7]
            radius = 2.0 * self.cfg.mapping.det_range
            clouds = []
            for kf in self.keyframes:
                if np.linalg.norm(kf.pose[4:7] - pos) > radius:
                    continue
                R = so3.quat_to_matrix(_h(kf.pose[0:4])).numpy()
                clouds.append(kf.cloud @ R.T + kf.pose[4:7])
            if clouds:
                self.lio.reset_map_from_world_points(
                    np.concatenate(clouds).astype(np.float32))

    # -- persistence --------------------------------------------------------
    def save_session(self, root: str):
        """The session directory (io/session.py) with every keyframe, the
        odometry chain and the loop edges, plus loop_markers.txt: one row
        per accepted loop with both endpoint positions (the file analog of
        the reference's RViz loop markers, laserMapping.cpp:456-522).  An
        in-flight async optimization is applied first."""
        from ..io.session import SessionWriter

        if self._async is not None and self._async.busy:
            res = self._async.wait()
            if res is not None:
                poses, n_snap = res
                self._apply_correction(np.asarray(poses, np.float64),
                                       n=n_snap)
        w = SessionWriter(root=root)
        for kf in self.keyframes:
            w.add_keyframe(kf.cloud, np.zeros(len(kf.cloud)), kf.desc,
                           kf.pose, t=kf.t)

        def rel(i, j):
            return se3.between(_h(self.keyframes[i].pose),
                               _h(self.keyframes[j].pose)).numpy()

        for k in range(1, len(self.keyframes)):
            w.add_edge(k - 1, k, rel(k - 1, k))
        for (i, j, _fit) in self.loop_pairs:
            w.add_edge(i, j, rel(i, j))
        w.save()
        with open(os.path.join(root, "loop_markers.txt"), "w") as f:
            f.write("# i j fitness xi yi zi xj yj zj\n")
            for (i, j, fit) in self.loop_pairs:
                pi = np.asarray(self.keyframes[i].pose)[4:7]
                pj = np.asarray(self.keyframes[j].pose)[4:7]
                f.write(f"{i} {j} {fit:.6f} "
                        + " ".join(f"{v:.6f}" for v in pi) + " "
                        + " ".join(f"{v:.6f}" for v in pj) + "\n")
