"""Minimal PCD (Point Cloud Data v0.7) reader/writer.

The port's own copy of better_fastlio2_tpu/io/pcd.py (numpy only).

Replaces the reference's use of pcl::io::savePCDFileBinary / loadPCDFile
(reference: src/laserMapping.cpp:2494-2554, include/multi-session/
Incremental_mapping.cpp:142-191).  Supports the XYZI layout the session
directory uses, in binary and ascii encodings — byte-compatible with PCL
so the reference's offline tooling keeps working on our session dirs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_pcd", "read_pcd"]


def write_pcd(path: str, xyz: np.ndarray, intensity: np.ndarray | None = None,
              binary: bool = True) -> None:
    n = len(xyz)
    if intensity is None:
        intensity = np.zeros(n, np.float32)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z intensity\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    data = np.empty((n, 4), np.float32)
    data[:, :3] = xyz
    data[:, 3] = intensity
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def write_pcd_fields(path: str, fields: list[str], data: np.ndarray,
                     binary: bool = True) -> None:
    """PCD with arbitrary F4 fields (e.g. the reference's PointTypePose
    rows x y z intensity roll pitch yaw time in transformations.pcd,
    laserMapping.cpp:2533-2538)."""
    n, m = data.shape
    assert m == len(fields)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * m)}\n"
        f"TYPE {' '.join(['F'] * m)}\n"
        f"COUNT {' '.join(['1'] * m)}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    arr = np.ascontiguousarray(data, np.float32)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(arr.tobytes())
        else:
            np.savetxt(f, arr, fmt="%.6f")


def read_pcd_fields(path: str) -> tuple[list[str], np.ndarray]:
    """Full-field PCD reader: returns (field names, (N, F) f32 data)."""
    with open(path, "rb") as f:
        fields = []
        n_points = 0
        data_mode = "ascii"
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, *vals = line.split()
            if key == "FIELDS":
                fields = vals
            elif key == "POINTS":
                n_points = int(vals[0])
            elif key == "DATA":
                data_mode = vals[0]
                break
        m = len(fields)
        if data_mode == "binary":
            data = np.frombuffer(f.read(4 * m * n_points),
                                 np.float32).reshape(n_points, m)
        else:
            data = np.loadtxt(f).reshape(n_points, m).astype(np.float32)
    return fields, data


def read_pcd(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (xyz (N,3) f32, intensity (N,) f32). Handles F4 fields in
    any order containing x,y,z[,intensity]; binary and ascii."""
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n_points = 0
        data_mode = "ascii"
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, *vals = line.split()
            if key == "FIELDS":
                fields = vals
            elif key == "SIZE":
                sizes = [int(v) for v in vals]
            elif key == "TYPE":
                types = vals
            elif key == "COUNT":
                counts = [int(v) for v in vals]
            elif key == "POINTS":
                n_points = int(vals[0])
            elif key == "DATA":
                data_mode = vals[0]
                break
        counts = counts or [1] * len(fields)
        dt = np.dtype(
            {
                "names": fields,
                "formats": [
                    f"{'f' if t == 'F' else ('i' if t == 'I' else 'u')}{s}"
                    if c == 1
                    else f"({c},){'f' if t == 'F' else 'i'}{s}"
                    for t, s, c in zip(types, sizes, counts)
                ],
            }
        )
        if data_mode == "binary":
            raw = np.frombuffer(f.read(dt.itemsize * n_points), dtype=dt,
                                count=n_points)
        elif data_mode == "ascii":
            raw = np.loadtxt(f, dtype=dt, max_rows=n_points, ndmin=1)
        else:
            raise ValueError(f"unsupported PCD DATA mode {data_mode}")
    xyz = np.stack(
        [raw["x"].astype(np.float32), raw["y"].astype(np.float32),
         raw["z"].astype(np.float32)], axis=1
    )
    inten = (
        raw["intensity"].astype(np.float32)
        if "intensity" in fields
        else np.zeros(len(xyz), np.float32)
    )
    return xyz, inten
