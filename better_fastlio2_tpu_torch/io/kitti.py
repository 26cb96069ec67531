"""KITTI raw-sequence loader (Velodyne HDL-64E + OXTS IMU).

The port's own numpy copy of better_fastlio2_tpu/io/kitti.py.

Replaces the reference's kitti2bag + rosbag-replay path (reference:
include/kitti2bag/kitti2bag.py + config/velodyne64_kitti_dataset.yaml):
reads the raw-sync directory layout directly —

    <seq>/velodyne_points/data/0000000000.bin   (N, 4) f32 x y z refl
    <seq>/velodyne_points/timestamps.txt
    <seq>/oxts/data/0000000000.txt              30-field OXTS rows
    <seq>/oxts/timestamps.txt

IMU channels follow kitti2bag (kitti2bag.py:39-44): linear acceleration =
(af, al, au) [fields 14:17], angular velocity = (wf, wl, wu) [20:23].

Per-point times: KITTI clouds are ego-motion-compensated by the vendor,
so `deskewed=True` (default) assigns every point the scan-end time —
undistortion reduces to the rigid scan-end transform, matching how the
reference behaves on KITTI (its yaw-synthesised times then rotate an
already-deskewed cloud; see preprocess.cpp:302-474 velodyne_handler).
Set deskewed=False to synthesise yaw-proportional times like the
reference does.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np

__all__ = ["KittiRawSequence", "synthesize_velodyne_times"]

SCAN_PERIOD = 0.1  # 10 Hz HDL-64E


def _read_timestamps(path: str) -> np.ndarray:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            # format: 2011-09-26 13:02:25.964389445
            dt, frac = line.rsplit(".", 1)
            base = datetime.strptime(dt, "%Y-%m-%d %H:%M:%S").timestamp()
            out.append(base + float("0." + frac))
    return np.asarray(out)


def synthesize_velodyne_times(pts: np.ndarray, scan_period: float = SCAN_PERIOD
                              ) -> np.ndarray:
    """Yaw-proportional per-point time synthesis for clouds without stamps
    (velodyne_handler behavior, preprocess.cpp:329-391): the HDL spins
    clockwise (decreasing yaw); offset = sweep fraction * period."""
    yaw = np.degrees(np.arctan2(pts[:, 1], pts[:, 0]))
    # clockwise from the first point's yaw
    rel = (yaw[0] - yaw) % 360.0
    return rel / 360.0 * scan_period


class KittiRawSequence:
    def __init__(self, root: str, deskewed: bool = True):
        self.root = root
        self.deskewed = deskewed
        self.velo_dir = os.path.join(root, "velodyne_points", "data")
        self.oxts_dir = os.path.join(root, "oxts", "data")
        self.velo_files = sorted(os.listdir(self.velo_dir))
        self.oxts_files = sorted(os.listdir(self.oxts_dir))
        self.velo_t = _read_timestamps(
            os.path.join(root, "velodyne_points", "timestamps.txt")
        )
        self.oxts_t = _read_timestamps(
            os.path.join(root, "oxts", "timestamps.txt")
        )
        self._imu = None

    def scan(self, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(xyz (N,3), intensity (N,), t_offsets (N,)) for frame k."""
        raw = np.fromfile(
            os.path.join(self.velo_dir, self.velo_files[k]), dtype=np.float32
        ).reshape(-1, 4)
        xyz = raw[:, :3]
        if self.deskewed:
            t = np.full(len(xyz), SCAN_PERIOD, np.float64)
        else:
            t = synthesize_velodyne_times(xyz)
        return xyz, raw[:, 3], t

    def imu_all(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(t (M,), acc (M,3), gyr (M,3)) for the whole sequence."""
        if self._imu is None:
            acc, gyr = [], []
            for f in self.oxts_files:
                row = np.loadtxt(os.path.join(self.oxts_dir, f))
                acc.append(row[14:17])
                gyr.append(row[20:23])
            self._imu = (self.oxts_t, np.stack(acc), np.stack(gyr))
        return self._imu

    def __len__(self) -> int:
        return len(self.velo_files)

    def groups(self, blind: float = 1.0, point_filter_num: int = 1):
        """Yield synchronized measurement groups (sync_packages analog,
        laserMapping.cpp:1374-1437): one scan + the IMU samples in
        (prev_tail, scan_end], with the previous packet's tail prepended."""
        t_imu, acc, gyr = self.imu_all()
        for k in range(len(self)):
            xyz, inten, toff = self.scan(k)
            r = np.linalg.norm(xyz[:, :2], axis=1)
            keep = r > blind
            xyz, toff = xyz[keep][::point_filter_num], toff[keep][::point_filter_num]
            beg = self.velo_t[k] - SCAN_PERIOD
            end = self.velo_t[k]
            lo = np.searchsorted(t_imu, beg - 0.11)
            hi = np.searchsorted(t_imu, end + 1e-9, side="right")
            idx = np.arange(max(lo, 0), hi)
            if len(idx) == 0:
                continue
            yield dict(
                pts=xyz,
                pt_t=toff,
                imu_acc=acc[idx],
                imu_gyr=gyr[idx],
                imu_t=t_imu[idx] - beg,
                scan_beg_abs=beg,
                scan_end_t=SCAN_PERIOD,
            )
