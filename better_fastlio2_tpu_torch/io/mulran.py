"""MulRan dataset loader (Ouster OS1-64 + Xsens IMU).

The port's own numpy copy of better_fastlio2_tpu/io/mulran.py.

The reference runs MulRan through a ROS "fileplayer" + config/mulran.yaml
(reference: note.txt:2-5, config/mulran.yaml — Ouster64, lidar_type 3).
This loader reads the on-disk layout directly:

    <seq>/sensor_data/Ouster/<stamp_ns>.bin   (N, 4) f32 x y z intensity
    <seq>/sensor_data/xsens_imu.csv           stamp_ns, quat(x y z w),
                                              euler(3), gyro(3), accel(3),
                                              mag(3)
    <seq>/global_pose.csv                     stamp_ns, 3x4 row-major pose

Ouster scans carry no per-point stamps in this export; per-point times
are synthesised from azimuth like the reference's no-stamp path.
"""

from __future__ import annotations

import os

import numpy as np

from .preprocess import preprocess_velodyne

__all__ = ["MulranSequence"]

SCAN_PERIOD = 0.1


class MulranSequence:
    def __init__(self, root: str):
        self.root = root
        self.scan_dir = os.path.join(root, "sensor_data", "Ouster")
        self.scan_files = sorted(
            f for f in os.listdir(self.scan_dir) if f.endswith(".bin")
        )
        self.scan_t = np.array(
            [int(f[:-4]) * 1e-9 for f in self.scan_files]
        )
        imu = np.loadtxt(
            os.path.join(root, "sensor_data", "xsens_imu.csv"),
            delimiter=",", usecols=range(14),
        )
        self.imu_t = imu[:, 0] * 1e-9
        self.imu_gyr = imu[:, 8:11]
        self.imu_acc = imu[:, 11:14]

    def __len__(self):
        return len(self.scan_files)

    def scan(self, k: int):
        raw = np.fromfile(
            os.path.join(self.scan_dir, self.scan_files[k]), dtype=np.float32
        ).reshape(-1, 4)
        return raw[:, :3], raw[:, 3]

    def ground_truth(self):
        """(t (K,), poses (K, 3, 4)) from global_pose.csv."""
        gp = np.loadtxt(os.path.join(self.root, "global_pose.csv"),
                        delimiter=",")
        return gp[:, 0] * 1e-9, gp[:, 1:13].reshape(-1, 3, 4)

    def groups(self, blind: float = 1.0, point_filter_num: int = 1):
        for k in range(len(self)):
            xyz, inten = self.scan(k)
            pts, toff, inten = preprocess_velodyne(
                xyz, inten, None, blind=blind,
                point_filter_num=point_filter_num,
            )
            beg = self.scan_t[k]
            end = beg + SCAN_PERIOD
            lo = np.searchsorted(self.imu_t, beg - 0.02)
            hi = np.searchsorted(self.imu_t, end + 1e-9, side="right")
            idx = np.arange(max(lo - 1, 0), hi)  # prepend previous tail
            if len(idx) < 2:
                continue
            yield dict(
                pts=pts,
                pt_t=toff,
                imu_acc=self.imu_acc[idx],
                imu_gyr=self.imu_gyr[idx],
                imu_t=self.imu_t[idx] - beg,
                scan_beg_abs=beg,
                scan_end_t=SCAN_PERIOD,
            )
