"""Per-vendor LiDAR preprocessing — decode, cull, subsample, time-normalise.

The port's own numpy copy of better_fastlio2_tpu/io/preprocess.py.

Host-side analog of the reference Preprocess class (reference:
src/preprocess.cpp).  In the ROS-less design the drivers/loaders hand us
plain arrays; this module applies the same per-vendor semantics:

* Livox  (livox_handler, preprocess.cpp:105-206): keep single/first
  returns — tag bits (tag & 0x30) in {0x00, 0x10} — finite points,
  stride subsample, blind cull; per-point offset_time given in ns.
* Velodyne (velodyne_handler, :302-474): per-point time in the cloud is
  scaled by time_unit; when absent, synthesise from azimuth assuming
  clockwise rotation at SCAN_RATE (the omega/yaw logic of :329-391).
* Ouster  (oust64_handler, :207-301): per-point `t` field in ns.
* Robosense (rslidar_handler): absolute per-point stamps — convert to
  offsets from the scan head.

All handlers output (pts (N,3) f32, t_offset (N,) f64 seconds,
intensity (N,) f32) with culling applied.  time_unit values follow
preprocess.h:21-28: 0 s, 1 ms, 2 us, 3 ns.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "TIME_UNIT_SCALE",
    "preprocess_common",
    "preprocess_livox",
    "preprocess_livox_ros",
    "preprocess_velodyne",
    "preprocess_ouster",
    "preprocess_robosense",
    "handler_for",
]


def handler_for(pre_cfg):
    """The decode handler a PreprocessConfig selects — the dispatch of
    Preprocess::process (preprocess.cpp:51-63: lidar_type, plus the
    livox_type custom-msg/PointCloud2 split of config/hap_ros.yaml).
    Returns a callable taking the vendor-specific raw arrays; callers
    feeding their own sensor stream use this so the yaml keys
    (lidar_type / livox_type) are authoritative."""
    lt = int(getattr(pre_cfg, "lidar_type", 1))
    if lt == 1:
        if int(getattr(pre_cfg, "livox_type", 1)) == 2:
            return preprocess_livox_ros
        return preprocess_livox
    if lt == 2:
        return preprocess_velodyne
    if lt == 3:
        return preprocess_ouster
    if lt == 4:
        return preprocess_robosense
    raise ValueError(f"unknown lidar_type {lt}")

TIME_UNIT_SCALE = {0: 1.0, 1: 1e-3, 2: 1e-6, 3: 1e-9}


def preprocess_common(
    pts: np.ndarray,
    t_offset: np.ndarray,
    intensity: np.ndarray | None,
    blind: float,
    point_filter_num: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shared tail: finite filter, stride subsample, blind-range cull.

    The reference culls on the squared planar... full 3D range vs blind
    (preprocess.cpp:195-199 uses x^2+y^2+z^2 > blind^2) and strides by
    point_filter_num (:188).
    """
    if intensity is None:
        intensity = np.zeros(len(pts), np.float32)
    finite = np.isfinite(pts).all(axis=1)
    pts, t_offset, intensity = pts[finite], t_offset[finite], intensity[finite]
    if point_filter_num > 1:
        pts = pts[::point_filter_num]
        t_offset = t_offset[::point_filter_num]
        intensity = intensity[::point_filter_num]
    r2 = np.einsum("ij,ij->i", pts, pts)
    keep = r2 > blind * blind
    return (
        pts[keep].astype(np.float32),
        t_offset[keep].astype(np.float64),
        intensity[keep].astype(np.float32),
    )


def preprocess_livox(
    pts: np.ndarray,
    intensity: np.ndarray,
    tag: np.ndarray,
    offset_time_ns: np.ndarray,
    blind: float = 0.01,
    point_filter_num: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Livox custom-msg decode (livox_handler, preprocess.cpp:105-206).

    Return-type filter: (tag & 0x30) == 0x10 or 0x00 (:191)."""
    ret = tag.astype(np.int64) & 0x30
    ok = (ret == 0x00) | (ret == 0x10)
    t = offset_time_ns.astype(np.float64) * 1e-9
    return preprocess_common(
        pts[ok], t[ok], intensity[ok], blind, point_filter_num
    )


def preprocess_livox_ros(
    pts: np.ndarray,
    intensity: np.ndarray,
    tag: np.ndarray,
    line: np.ndarray,
    n_scans: int = 6,
    blind: float = 4.0,
    point_filter_num: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Livox-via-PointCloud2 decode (livoxros_handler,
    preprocess.cpp:477-526 — the config/hap_ros.yaml path).

    Same return-type gate as the custom-msg handler ((tag & 0x30) in
    {0x00, 0x10}) plus the line < N_SCANS gate, stride subsample,
    consecutive-duplicate suppression (the |Δp| > 1e-7 test of :519) and
    blind cull.  The PointCloud2 layout carries NO usable per-point
    offset time in the reference path (curvature is left unset), so
    t_offset is all-zero — undistortion degrades to scan-level, exactly
    as the reference behaves on this topic."""
    ret = tag.astype(np.int64) & 0x30
    ok = ((ret == 0x00) | (ret == 0x10)) & (line.astype(np.int64) < n_scans)
    pts, intensity = pts[ok], intensity[ok]
    if point_filter_num > 1:
        pts = pts[::point_filter_num]
        intensity = intensity[::point_filter_num]
    if len(pts) > 1:
        dup = np.all(np.abs(np.diff(pts, axis=0)) <= 1e-7, axis=1)
        keep = np.concatenate([[True], ~dup])
        pts, intensity = pts[keep], intensity[keep]
    return preprocess_common(
        pts, np.zeros(len(pts)), intensity, blind, 1
    )


def preprocess_velodyne(
    pts: np.ndarray,
    intensity: np.ndarray | None = None,
    time_field: np.ndarray | None = None,
    time_unit: int = 2,
    scan_rate: float = 10.0,
    blind: float = 0.01,
    point_filter_num: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Velodyne decode (velodyne_handler, preprocess.cpp:302-474).

    With per-point stamps: scale by time_unit.  Without: synthesise from
    azimuth — the HDL spins clockwise, so offset = (yaw_first - yaw) mod
    360 over the sweep (:329-391 omega = 0.361 * SCAN_RATE deg/ms)."""
    if time_field is not None and np.ptp(time_field) > 0:
        t = time_field.astype(np.float64) * TIME_UNIT_SCALE[time_unit]
        t = t - t.min()
    else:
        yaw = np.degrees(np.arctan2(pts[:, 1], pts[:, 0]))
        rel = (yaw[0] - yaw) % 360.0
        t = rel / 360.0 / scan_rate
    return preprocess_common(pts, t, intensity, blind, point_filter_num)


def preprocess_ouster(
    pts: np.ndarray,
    intensity: np.ndarray | None = None,
    t_ns: np.ndarray | None = None,
    blind: float = 0.01,
    point_filter_num: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ouster decode (oust64_handler, preprocess.cpp:207-301): `t` is
    per-point ns from scan start."""
    t = (
        t_ns.astype(np.float64) * 1e-9
        if t_ns is not None
        else np.zeros(len(pts))
    )
    return preprocess_common(pts, t, intensity, blind, point_filter_num)


def preprocess_robosense(
    pts: np.ndarray,
    intensity: np.ndarray | None = None,
    timestamp_abs: np.ndarray | None = None,
    blind: float = 0.01,
    point_filter_num: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Robosense decode: absolute per-point stamps -> offsets from the
    first point (rslidar path of preprocess.cpp)."""
    t = (
        timestamp_abs.astype(np.float64) - timestamp_abs.min()
        if timestamp_abs is not None
        else np.zeros(len(pts))
    )
    return preprocess_common(pts, t, intensity, blind, point_filter_num)
