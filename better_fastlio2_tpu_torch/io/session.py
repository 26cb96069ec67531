"""Session directory persistence — the inter-application API.

The port's own copy of better_fastlio2_tpu/io/session.py: numpy only, its
quaternion-to-matrix conversion a numpy function (`_quat_to_matrix`).

The single most important data-flow fact about the reference (SURVEY.md
§1): the session directory on disk is how the mapping run hands off to
multi-session merging, online relocalization, and object update.  Format
kept byte-compatible (reference: src/laserMapping.cpp:2465-2554 writer;
include/multi-session/Incremental_mapping.cpp:142-282,
include/online-relo/pose_estimator.cpp:57-75 readers):

    <root>/
      PCDs/000000.pcd ...         per-keyframe body-frame clouds (XYZI)
      SCDs/000000.scd ...         per-keyframe Scan Context (20x60, %.3f)
      singlesession_posegraph.g2o VERTEX_SE3:QUAT / EDGE_SE3:QUAT lines
      globalMap.pcd               all keyframe clouds in world frame
      trajectory.pcd              keyframe positions (x,y,z,intensity=idx)
      transformations.pcd         keyframe 6D poses packed like the
                                  reference's PointTypePose (pose txt here)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .pcd import read_pcd, write_pcd

__all__ = ["SessionWriter", "SessionReader", "write_g2o", "read_g2o",
           "write_scd", "read_scd", "kitti_pose_line"]


def _quat_to_matrix(q) -> np.ndarray:
    """Rotation matrix of a [w, x, y, z] quaternion (numpy, f64)."""
    w, x, y, z = np.asarray(q, np.float64)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return np.array([[ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)],
                     [2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)],
                     [2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz]])


def write_scd(path: str, desc: np.ndarray, delimiter: str = " ") -> None:
    """Scan Context descriptor, precision 3 (saveCurrentSCD,
    Scancontext.cpp:515-532)."""
    np.savetxt(path, desc, fmt="%.3f", delimiter=delimiter)


def read_scd(path: str) -> np.ndarray:
    return np.loadtxt(path)


def write_g2o(path: str, poses: np.ndarray, edges: list) -> None:
    """poses: (K, 7) [qw qx qy qz | x y z]; edges: list of (i, j, pose7).

    Line format matches common_lib.h writeVertex/writeEdge (:869-895):
    translation then quaternion as (x y z qx qy qz qw), no information
    matrix block.
    """
    with open(path, "w") as f:
        for i, p in enumerate(poses):
            qw, qx, qy, qz, x, y, z = p
            f.write(
                f"VERTEX_SE3:QUAT {i} {x:.6f} {y:.6f} {z:.6f} "
                f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n"
            )
        for (i, j, p) in edges:
            qw, qx, qy, qz, x, y, z = p
            f.write(
                f"EDGE_SE3:QUAT {i} {j} {x:.6f} {y:.6f} {z:.6f} "
                f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n"
            )


def read_g2o(path: str) -> tuple[np.ndarray, list]:
    """Inverse of write_g2o (loadSessionGraph analog,
    Incremental_mapping.cpp:232-264). Returns (poses (K,7) wxyz|t, edges)."""
    poses = {}
    edges = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                idx = int(tok[1])
                x, y, z, qx, qy, qz, qw = map(float, tok[2:9])
                poses[idx] = [qw, qx, qy, qz, x, y, z]
            elif tok[0] == "EDGE_SE3:QUAT":
                i, j = int(tok[1]), int(tok[2])
                x, y, z, qx, qy, qz, qw = map(float, tok[3:10])
                edges.append((i, j, np.array([qw, qx, qy, qz, x, y, z])))
    K = max(poses) + 1 if poses else 0
    arr = np.zeros((K, 7))
    arr[:, 0] = 1.0
    for idx, p in poses.items():
        arr[idx] = p
    return arr, edges


def kitti_pose_line(R: np.ndarray, t: np.ndarray) -> str:
    """KITTI-format 3x4 row-major pose row (WriteText,
    common_lib.h:276-281)."""
    M = np.hstack([R, t.reshape(3, 1)])
    return " ".join(f"{v:.9f}" for v in M.reshape(-1))


@dataclass
class SessionWriter:
    """Accumulates keyframes during a run and writes the session dir at
    the end (the reference writes on SIGINT / save_map service)."""

    root: str
    clouds: list = field(default_factory=list)  # body-frame (N,3), intensity
    descs: list = field(default_factory=list)  # (20,60)
    poses: list = field(default_factory=list)  # (7,) [wxyz|t]
    times: list = field(default_factory=list)  # float per keyframe
    edges: list = field(default_factory=list)  # (i, j, pose7)

    def add_keyframe(self, cloud_xyz, intensity, desc, pose7, t: float = 0.0):
        self.clouds.append((np.asarray(cloud_xyz), np.asarray(intensity)))
        self.descs.append(np.asarray(desc))
        self.poses.append(np.asarray(pose7))
        self.times.append(float(t))

    def add_edge(self, i, j, rel_pose7):
        self.edges.append((i, j, np.asarray(rel_pose7)))

    def save(self) -> None:
        os.makedirs(os.path.join(self.root, "PCDs"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "SCDs"), exist_ok=True)
        world_clouds = []
        for k, ((xyz, inten), desc, pose) in enumerate(
            zip(self.clouds, self.descs, self.poses)
        ):
            write_pcd(os.path.join(self.root, "PCDs", f"{k:06d}.pcd"), xyz,
                      inten)
            write_scd(os.path.join(self.root, "SCDs", f"{k:06d}.scd"), desc)
            R = _quat_to_matrix(pose[:4])
            world_clouds.append(xyz @ R.T + pose[4:7])
        poses = np.stack(self.poses) if self.poses else np.zeros((0, 7))
        write_g2o(
            os.path.join(self.root, "singlesession_posegraph.g2o"),
            poses,
            self.edges,
        )
        if world_clouds:
            gm = np.concatenate(world_clouds)
            gi = np.concatenate([i for (_, i) in self.clouds])
            write_pcd(os.path.join(self.root, "globalMap.pcd"), gm, gi)
            write_pcd(
                os.path.join(self.root, "trajectory.pcd"),
                poses[:, 4:7],
                np.arange(len(poses), dtype=np.float32),
            )
            # transformations.pcd: full PointTypePose rows
            # (x y z intensity roll pitch yaw time) exactly as the
            # reference packs cloudKeyPoses6D (laserMapping.cpp:2533-2538)
            # so a reference-built consumer parses it unchanged
            from .pcd import write_pcd_fields

            rpy = np.zeros((len(poses), 3), np.float32)
            for k, p in enumerate(poses):
                qw, qx, qy, qz = p[0:4]
                rpy[k, 0] = np.arctan2(2 * (qw * qx + qy * qz),
                                       1 - 2 * (qx * qx + qy * qy))
                rpy[k, 1] = np.arcsin(np.clip(2 * (qw * qy - qz * qx),
                                              -1.0, 1.0))
                rpy[k, 2] = np.arctan2(2 * (qw * qz + qx * qy),
                                       1 - 2 * (qy * qy + qz * qz))
            rows = np.zeros((len(poses), 8), np.float32)
            rows[:, 0:3] = poses[:, 4:7]
            rows[:, 3] = np.arange(len(poses), dtype=np.float32)
            rows[:, 4:7] = rpy
            rows[:, 7] = np.asarray(self.times, np.float32)[: len(poses)]
            write_pcd_fields(
                os.path.join(self.root, "transformations.pcd"),
                ["x", "y", "z", "intensity", "roll", "pitch", "yaw",
                 "time"],
                rows,
            )
        # KITTI-format trajectory for evo-style evaluation
        with open(os.path.join(self.root, "poses_kitti.txt"), "w") as f:
            for p in poses:
                R = _quat_to_matrix(p[:4])
                f.write(kitti_pose_line(R, p[4:7]) + "\n")


class SessionReader:
    """Loads a session dir (Session ctor analog,
    Incremental_mapping.cpp:20-34,142-282)."""

    def __init__(self, root: str):
        self.root = root
        self.poses, self.edges = read_g2o(
            os.path.join(root, "singlesession_posegraph.g2o")
        )
        self.num_keyframes = len(self.poses)

    def cloud(self, k: int):
        return read_pcd(os.path.join(self.root, "PCDs", f"{k:06d}.pcd"))

    def scd(self, k: int) -> np.ndarray:
        return read_scd(os.path.join(self.root, "SCDs", f"{k:06d}.scd"))

    def global_map(self):
        return read_pcd(os.path.join(self.root, "globalMap.pcd"))
