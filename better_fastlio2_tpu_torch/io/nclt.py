"""NCLT dataset loader (Velodyne HDL-32E + MS25 IMU).

The port's own numpy copy of better_fastlio2_tpu/io/nclt.py.

The reference's NCLT runs used the same velodyne config path
(config/nclt.yaml is an empty placeholder — SURVEY.md §5.6); this loader
reads NCLT's native export:

    <seq>/velodyne_sync/<utime>.bin   packed points: x,y,z uint16
                                      (value*0.005 - 100.0 m), intensity
                                      u8, ring u8 — 8 bytes/point
    <seq>/ms25.csv                    utime, mag(3), accel(3), gyro(3)
    <seq>/groundtruth_<seq>.csv       utime, x, y, z, r, p, h
"""

from __future__ import annotations

import os

import numpy as np

from .preprocess import preprocess_velodyne

__all__ = ["NcltSequence", "decode_nclt_bin", "decode_nclt_records"]

SCAN_PERIOD = 0.1


def decode_nclt_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Unpack NCLT's 8-byte point records -> (xyz (N,3) f32, intensity)."""
    return decode_nclt_records(np.fromfile(path, dtype=np.uint8))


def decode_nclt_records(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """decode_nclt_bin on the file's bytes (a uint8 array)."""
    n = len(raw) // 8
    raw = raw[: n * 8].reshape(n, 8)
    xyz_u16 = raw[:, :6].copy().view("<u2").reshape(n, 3)
    xyz = xyz_u16.astype(np.float32) * 0.005 - 100.0
    inten = raw[:, 6].astype(np.float32)
    return xyz, inten


class NcltSequence:
    def __init__(self, root: str):
        self.root = root
        self.scan_dir = os.path.join(root, "velodyne_sync")
        self.scan_files = sorted(
            f for f in os.listdir(self.scan_dir) if f.endswith(".bin")
        )
        self.scan_t = np.array(
            [int(f[:-4]) * 1e-6 for f in self.scan_files]
        )
        ms25 = np.loadtxt(os.path.join(root, "ms25.csv"), delimiter=",")
        self.imu_t = ms25[:, 0] * 1e-6
        self.imu_acc = ms25[:, 4:7]
        self.imu_gyr = ms25[:, 7:10]

    def __len__(self):
        return len(self.scan_files)

    def scan(self, k: int):
        return decode_nclt_bin(
            os.path.join(self.scan_dir, self.scan_files[k])
        )

    def ground_truth(self):
        for f in os.listdir(self.root):
            if f.startswith("groundtruth") and f.endswith(".csv"):
                gt = np.loadtxt(os.path.join(self.root, f), delimiter=",")
                return gt[:, 0] * 1e-6, gt[:, 1:]
        raise FileNotFoundError("no groundtruth csv in " + self.root)

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
            idx = np.arange(max(lo - 1, 0), hi)
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
