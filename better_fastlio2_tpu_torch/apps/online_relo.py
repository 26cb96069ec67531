"""Online relocalization against a prior session map.

Port of better_fastlio2_tpu/apps/online_relo.py, the re-design of the
reference's online-relo node (include/online-relo/pose_estimator.{h,cpp},
src/online_relocalization.cpp).  The reference subscribes to the running
odometry's /cloud_registered + /Odometry topics; here the two streams
arrive as per-scan method calls.

* global initialisation (globalRelo, pose_estimator.cpp:463-534): Scan
  Context match of the first scan against the prior SCD database, an
  optional trust gate against an external initial-pose guess (the RViz
  /initialpose click, :545-559), then robust ICP refinement against the
  nearest prior keyframes (:596-634).
* per-frame mode switch (easyToRelo, :387-461): with a prior keyframe
  within `search_dis` of the corrected pose, "relo mode" registers the
  scan to a submap of the `search_num` nearest prior keyframes (FRICP-
  class robust point-to-plane with Welsch weights) and updates the
  map<-odom correction; otherwise "lio mode" appends the scan as a new
  keyframe extending the prior session (:271-368).

Registration and pose math run on the relocalizer's device in cfg.dtype
(the reference names float64, which its users run as float32 without
x64); Scan Context descriptors are float32, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.session import SessionReader
from ..ops import icp as icp_ops
from ..ops import scancontext as sc
from ..utils import se3, so3
from ..pipeline.lio import _DTYPES
from ..utils.device import resolve_device, to_host

__all__ = ["ReloConfig", "OnlineRelocalizer"]


@dataclass
class ReloConfig:
    search_dis: float = 10.0  # searchDis: relo-mode gate
    search_num: int = 3  # nearest prior keyframes in the submap
    trust_dis: float = 5.0  # trustDis vs external initial guess
    sc_dist_thresh: float = 0.4
    icp_fitness_thresh: float = 0.3
    welsch_sigma: float = 0.5
    # registration algorithm, the regMode of the reference's FRICP
    # toolkit (registeration.h:20-27): an int 0-8 or a REG_MODES name.
    # None keeps the default robust point-to-plane (Welsch); any other
    # value dispatches through ops.icp.register_run.
    reg_mode: int | str | None = None
    dtype: str = "float32"

    @classmethod
    def from_yaml(cls, path: str) -> "ReloConfig":
        """Load the relo: block of a config/online_relo.yaml-style file
        (reference key names: searchDis/searchNum/trustDis/regMode)."""
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        blk = d.get("relo", {})
        cfg = cls()
        for src, dst in [("searchDis", "search_dis"),
                         ("searchNum", "search_num"),
                         ("trustDis", "trust_dis"),
                         ("regMode", "reg_mode"),
                         ("sc_dist_thresh", "sc_dist_thresh"),
                         ("icp_fitness_thresh", "icp_fitness_thresh"),
                         ("welsch_sigma", "welsch_sigma")]:
            if src in blk:
                setattr(cfg, dst, blk[src])
        return cfg


class OnlineRelocalizer:
    def __init__(self, prior_dir: str, cfg: ReloConfig | None = None,
                 device=None):
        """Runs on `device` (cuda unless named)."""
        self.cfg = cfg or ReloConfig()
        self.device = resolve_device(device)
        self.prior = SessionReader(prior_dir)
        self.dtype = _DTYPES[self.cfg.dtype]
        n = self.prior.num_keyframes
        params = sc.SCParams(num_exclude_recent=0,
                             dist_thresh=self.cfg.sc_dist_thresh)
        self.sc_params = params
        db = sc.make_database(max(n, 8) + 256, params, torch.float32,
                              self.device)
        for k in range(n):
            db = sc.add_descriptor(db, self._t(self.prior.scd(k),
                                               torch.float32))
        self.db = db
        self.kf_poses = [self.prior.poses[k] for k in range(n)]
        self._cloud_cache: dict[int, np.ndarray] = {}
        self.new_keyframes: list[tuple[np.ndarray, np.ndarray]] = []
        # map <- odom correction, updated in relo mode
        self.T_corr = se3.identity(self.dtype).numpy().astype(np.float64)
        self.initialized = False
        self.mode = "init"

    # -- helpers ------------------------------------------------------------
    def _t(self, a, dtype=None) -> torch.Tensor:
        """A tensor on the relocalizer's device (cfg.dtype unless given)."""
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    def _h(self, t: torch.Tensor) -> np.ndarray:
        """A pose read back to the host as f64 numpy (one counted read)."""
        return np.asarray(to_host(t), np.float64)

    def _register(self, cloud_body, submap, init, max_corr, iters):
        """One registration under cfg.reg_mode: the Registeration::run
        dispatch of the reference (registeration.h:36-175)."""
        src = self._t(cloud_body)
        sv = torch.ones(len(cloud_body), dtype=torch.bool, device=self.device)
        tgt = self._t(submap)
        tv = torch.ones(len(submap), dtype=torch.bool, device=self.device)
        ini = self._t(init)
        if self.cfg.reg_mode is None:
            return icp_ops.icp_point2plane(
                src, sv, tgt, tv, ini, max_corr=max_corr, iters=iters,
                voxel=1.0, welsch_sigma=self.cfg.welsch_sigma)
        return icp_ops.register_run(
            self.cfg.reg_mode, src, sv, tgt, tv, ini, max_corr=max_corr,
            iters=iters, voxel=1.0, welsch_sigma=self.cfg.welsch_sigma)

    def _kf_cloud(self, k: int) -> np.ndarray:
        if k not in self._cloud_cache:
            xyz, _ = self.prior.cloud(k)
            self._cloud_cache[k] = xyz.astype(np.float64)
        return self._cloud_cache[k]

    def _prior_submap_world(self, center: int, num: int) -> np.ndarray:
        ps = np.stack(self.kf_poses)
        d = np.linalg.norm(ps[:, 4:7] - self.kf_poses[center][4:7], axis=1)
        near = np.argsort(d)[:num]
        parts = [se3.apply(self._t(self.kf_poses[k]),
                           self._t(self._kf_cloud(k))).cpu().numpy()
                 for k in near]
        cat = np.concatenate(parts)
        if len(cat) > 20000:
            cat = cat[:: len(cat) // 20000 + 1]
        return cat

    def _nearest_kf(self, pos: np.ndarray) -> tuple[int, float]:
        ps = np.stack(self.kf_poses)
        d = np.linalg.norm(ps[:, 4:7] - pos, axis=1)
        i = int(np.argmin(d))
        return i, float(d[i])

    def _descriptor(self, cloud_body: np.ndarray) -> torch.Tensor:
        return sc.make_descriptor(
            self._t(cloud_body, torch.float32),
            torch.ones(len(cloud_body), dtype=torch.bool, device=self.device),
            self.sc_params)

    def _compose(self, a, b) -> np.ndarray:
        return self._h(se3.compose(self._t(a), self._t(b)))

    def _inverse(self, a) -> np.ndarray:
        return self._h(se3.inverse(self._t(a)))

    # -- global initialisation ---------------------------------------------
    def global_relo(self, cloud_body: np.ndarray,
                    external_guess: np.ndarray | None = None) -> bool:
        """SC global match + optional trust gate + ICP refine
        (globalRelo, pose_estimator.cpp:463-634).  Returns success."""
        idx, dist, shift = to_host(torch.stack([
            t.to(torch.float64) for t in sc.detect_loop(
                self.db, self._descriptor(cloud_body), self.sc_params)]))
        if int(idx) < 0 or dist > self.cfg.sc_dist_thresh:
            return False
        k = int(idx)
        yaw = -float(shift) * 2 * np.pi / self.sc_params.num_sector
        init = self._h(se3.compose(
            self._t(self.kf_poses[k]),
            se3.make(so3.quat_exp(self._t([0.0, 0.0, yaw])),
                     self._t(np.zeros(3)))))
        if external_guess is not None:
            if np.linalg.norm(init[4:7] - external_guess[4:7]) > \
                    self.cfg.trust_dis:
                return False  # cross-check failed (:545-559)
        submap = self._prior_submap_world(k, self.cfg.search_num + 2)
        res = self._register(cloud_body, submap, init, max_corr=10.0,
                             iters=25)
        if to_host(res.fitness) > self.cfg.icp_fitness_thresh:
            return False
        self.T_init_map = self._h(res.pose)
        self.initialized = True
        return True

    # -- per-frame ----------------------------------------------------------
    def process(self, cloud_body: np.ndarray, odom_pose: np.ndarray):
        """One frame from the running odometry.  Returns a dict with the
        corrected map-frame pose and the active mode."""
        if not self.initialized:
            if not self.global_relo(cloud_body):
                return None
            # T_corr maps the odom frame to the map frame
            self.T_corr = self._compose(self.T_init_map,
                                        self._inverse(odom_pose))

        pose_map = self._compose(self.T_corr, odom_pose)
        k, d = self._nearest_kf(pose_map[4:7])
        if d <= self.cfg.search_dis:
            # relo mode: register the scan to the prior submap (:180-270)
            self.mode = "relo"
            submap = self._prior_submap_world(k, self.cfg.search_num)
            res = self._register(cloud_body, submap, pose_map,
                                 max_corr=5.0, iters=12)
            if to_host(res.fitness) <= self.cfg.icp_fitness_thresh:
                pose_map = self._h(res.pose)
                self.T_corr = self._compose(pose_map,
                                            self._inverse(odom_pose))
        else:
            # lio mode: extend the prior session (:271-368)
            self.mode = "lio"
            self.db = sc.add_descriptor(self.db, self._descriptor(cloud_body))
            self.kf_poses.append(pose_map)
            self.new_keyframes.append((cloud_body, pose_map))
            self._cloud_cache[len(self.kf_poses) - 1] = cloud_body.astype(
                np.float64)
        return {"pose": pose_map, "mode": self.mode, "nearest_kf": k,
                "nearest_dist": d}
