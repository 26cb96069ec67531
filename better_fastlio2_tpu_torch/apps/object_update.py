"""Object-level map updating between two sessions.

Port of better_fastlio2_tpu/apps/object_update.py, the re-design of the
reference's offline object-update demo (src/object_update.cpp): for
selected keyframes of a central ("global") and a query ("local") session,
ground segmentation + curved-voxel clustering + PD recognition per frame,
each session's PD clusters gathered in the shared central frame, bounding
boxes intersected across sessions, and the diff:

  local-found & global-matched  -> fused   (object persists; :3-137)
  local-only                    -> new     (appeared)
  global-only                   -> old     (disappeared)

Outputs per-category clouds (the reference colors them blue/green/red and
writes PCDs; :139-470).  The perception runs on the updater's device in
cfg.dtype.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.pcd import write_pcd
from ..io.session import SessionReader
from ..perception import dynamic as dyn
from ..perception.patchwork import PatchworkParams, estimate_ground
from ..utils import se3
from ..pipeline.lio import _DTYPES
from ..utils.device import resolve_device

__all__ = ["ObjectUpdateConfig", "ObjectUpdater", "ObjectSet"]


@dataclass
class ObjectUpdateConfig:
    sensor_height: float = 0.4  # tgrs.h SENSOR_HEIGHT
    frame_stride: int = 1
    min_cluster_pts: int = 20
    dtype: str = "float32"


@dataclass
class ObjectSet:
    """Per-session aggregated PD objects in the shared frame."""

    clouds: list = field(default_factory=list)  # list[(n,3)] per object
    bboxes: list = field(default_factory=list)  # list[(2,3)] min/max


def _bbox(pts: np.ndarray) -> np.ndarray:
    return np.stack([pts.min(0), pts.max(0)])


def _bbox_overlap(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.all(a[0] <= b[1]) and np.all(b[0] <= a[1]))


class ObjectUpdater:
    def __init__(self, central_dir: str, query_dir: str,
                 cfg: ObjectUpdateConfig | None = None, device=None):
        """Runs on `device` (cuda unless named)."""
        self.cfg = cfg or ObjectUpdateConfig()
        self.device = resolve_device(device)
        self.central = SessionReader(central_dir)
        self.query = SessionReader(query_dir)
        self.prm = dyn.SSCParams(sensor_height=self.cfg.sensor_height)
        self.pw = PatchworkParams(sensor_height=self.cfg.sensor_height)

    def _extract_objects(self, sess: SessionReader,
                         frames: list[int]) -> ObjectSet:
        """detect() per frame (object_update.cpp:3-137): ground seg ->
        SSC cluster -> PD recognition; PD cluster points to the shared
        frame via the keyframe pose."""
        dtype = _DTYPES[self.cfg.dtype]
        out = ObjectSet()
        for k in frames:
            xyz, _ = sess.cloud(k)
            pts = torch.as_tensor(xyz, dtype=dtype, device=self.device)
            valid = torch.ones(len(xyz), dtype=torch.bool, device=self.device)
            gm = estimate_ground(pts, valid, self.pw)
            grid = dyn.cluster_grid(
                dyn.encode_scan(pts, valid & ~gm, self.prm), self.prm)
            pd = dyn.recognize_pd(grid, self.prm).reshape(-1).cpu().numpy()
            lab = grid.labels.reshape(-1).cpu().numpy()
            pv = grid.pt_voxel.cpu().numpy()
            ok = pv >= 0
            pt_lab = np.where(ok, lab[np.maximum(pv, 0)], -1)
            pt_pd = ok & pd[np.maximum(pv, 0)]
            pose = torch.as_tensor(sess.poses[k], dtype=dtype,
                                   device=self.device)
            world = se3.apply(pose, pts).cpu().numpy()
            for L in np.unique(pt_lab[pt_pd]):
                cl = world[pt_lab == L]
                if len(cl) < self.cfg.min_cluster_pts:
                    continue
                out.clouds.append(cl)
                out.bboxes.append(_bbox(cl))
        return out

    def run(self, central_frames: list[int] | None = None,
            query_frames: list[int] | None = None):
        """Full diff (main, object_update.cpp:139-470).

        Returns dict with 'fused' (persisting objects, merged points from
        both sessions), 'new' (query-only), 'old' (central-only)."""
        cf = central_frames or list(
            range(0, self.central.num_keyframes, self.cfg.frame_stride))
        qf = query_frames or list(
            range(0, self.query.num_keyframes, self.cfg.frame_stride))
        glob = self._extract_objects(self.central, cf)
        loc = self._extract_objects(self.query, qf)

        matched_g = np.zeros(len(glob.clouds), bool)
        fused, new = [], []
        for cl, bb in zip(loc.clouds, loc.bboxes):
            hits = [j for j, gb in enumerate(glob.bboxes)
                    if _bbox_overlap(bb, gb)]
            if hits:
                fused.append(np.concatenate([cl] + [glob.clouds[j]
                                                    for j in hits]))
                matched_g[hits] = True
            else:
                new.append(cl)
        old = [c for j, c in enumerate(glob.clouds) if not matched_g[j]]
        return {"fused": fused, "new": new, "old": old,
                "n_central_objects": len(glob.clouds),
                "n_query_objects": len(loc.clouds)}

    def write_outputs(self, result: dict, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        for name in ("fused", "new", "old"):
            cls = result[name]
            cloud = (np.concatenate(cls) if cls
                     else np.zeros((0, 3), np.float32))
            write_pcd(os.path.join(out_dir, f"objects_{name}.pcd"), cloud)
