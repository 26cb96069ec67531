"""Camera point-cloud colorization + detection-box tagging.

The port's own numpy copy of better_fastlio2_tpu/perception/colorize.py
(its quaternion-to-matrix conversion the numpy one of io/session.py).

Behavioral analog of the reference's camera path (reference:
src/laserMapping.cpp:231-392): a cached BGR image plus darknet person
bounding boxes (BoxCallback :292, probability > 0.6) colorize the
world-frame cloud — each LiDAR point is projected through the 3x4
intrinsic and 4x4 camera-from-LiDAR extrinsic (paramSetting :279,
yaml `camera:` block of config/mulran.yaml) and samples the pixel color;
points falling inside detection boxes are tagged (the reference colors
them red and can exclude them).

Pure numpy (host path — image-rate work, off the device hot loop).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CameraModel", "colorize_cloud", "points_in_boxes",
           "pack_rgb_float", "test_pattern_image", "load_image_bgr",
           "write_colored_keyframes"]


@dataclass
class CameraModel:
    intrinsics: np.ndarray  # (3, 4) projection matrix
    extrinsics: np.ndarray  # (4, 4) camera_T_lidar
    width: int
    height: int

    @classmethod
    def from_config(cls, cam_block: dict, width: int = 1280,
                    height: int = 720) -> "CameraModel":
        """Build from a reference-style yaml `camera:` block
        (config/hap_ros.yaml, config/mulran.yaml): `camera_internal` is
        the flattened 3x4 projection, `camera_external` the flattened
        4x4 camera-from-LiDAR transform (paramSetting,
        laserMapping.cpp:279-290)."""
        K = np.asarray(cam_block["camera_internal"], float).reshape(3, 4)
        T = np.asarray(cam_block["camera_external"], float).reshape(4, 4)
        return cls(intrinsics=K, extrinsics=T, width=int(width),
                   height=int(height))

    def project(self, pts_lidar: np.ndarray):
        """Returns (uv (N,2) float, depth (N,), in_image (N,))."""
        homo = np.concatenate(
            [pts_lidar, np.ones((len(pts_lidar), 1))], axis=1
        )
        cam = (self.extrinsics @ homo.T).T  # (N, 4)
        pix = (self.intrinsics @ cam.T).T  # (N, 3)
        depth = pix[:, 2]
        safe = np.where(np.abs(depth) > 1e-6, depth, 1e-6)
        uv = pix[:, :2] / safe[:, None]
        ok = (
            (depth > 0)
            & (uv[:, 0] >= 0)
            & (uv[:, 0] < self.width - 1)
            & (uv[:, 1] >= 0)
            & (uv[:, 1] < self.height - 1)
        )
        return uv, depth, ok


def colorize_cloud(
    cam: CameraModel, image_bgr: np.ndarray, pts_lidar: np.ndarray
):
    """Returns (rgb (N,3) uint8, valid (N,)) — nearest-pixel sampling like
    the reference (laserMapping.cpp:340-366)."""
    uv, depth, ok = cam.project(pts_lidar)
    u = np.clip(uv[:, 0].astype(int), 0, cam.width - 1)
    v = np.clip(uv[:, 1].astype(int), 0, cam.height - 1)
    bgr = image_bgr[v, u]
    rgb = bgr[:, ::-1].copy()
    rgb[~ok] = 0
    return rgb, ok


def points_in_boxes(
    cam: CameraModel,
    pts_lidar: np.ndarray,
    boxes: np.ndarray,
    probs: np.ndarray | None = None,
    prob_thresh: float = 0.6,
) -> np.ndarray:
    """Bool mask of points projecting inside any accepted detection box.

    boxes: (M, 4) [xmin, ymin, xmax, ymax]; probability gate > 0.6
    matches BoxCallback (laserMapping.cpp:292-302)."""
    uv, depth, ok = cam.project(pts_lidar)
    hit = np.zeros(len(pts_lidar), bool)
    for m in range(len(boxes)):
        if probs is not None and probs[m] <= prob_thresh:
            continue
        x0, y0, x1, y1 = boxes[m]
        hit |= (
            ok
            & (uv[:, 0] >= x0)
            & (uv[:, 0] <= x1)
            & (uv[:, 1] >= y0)
            & (uv[:, 1] <= y1)
        )
    return hit


def pack_rgb_float(rgb: np.ndarray) -> np.ndarray:
    """PCL `rgb` field convention: the 0x00RRGGBB bit pattern viewed as
    a float32 (what the reference's pcl::PointXYZRGB serialises)."""
    r = rgb[:, 0].astype(np.uint32)
    g = rgb[:, 1].astype(np.uint32)
    b = rgb[:, 2].astype(np.uint32)
    return ((r << 16) | (g << 8) | b).view(np.float32)


def test_pattern_image(width: int, height: int) -> np.ndarray:
    """Deterministic BGR test card (u-channel red ramp, v-channel green
    ramp, constant blue): the offline stand-in for the camera stream the
    reference subscribes to (imageCallback, laserMapping.cpp:250-258) —
    no camera topic exists in a dataset-replay container, and a known
    gradient makes pixel pickup assertable in tests."""
    u = np.linspace(0, 255, width, dtype=np.float32)
    v = np.linspace(0, 255, height, dtype=np.float32)
    img = np.zeros((height, width, 3), np.uint8)
    img[:, :, 2] = np.broadcast_to(u[None, :], (height, width))  # R ramp
    img[:, :, 1] = np.broadcast_to(v[:, None], (height, width))  # G ramp
    img[:, :, 0] = 64  # constant B
    return img


def load_image_bgr(path: str) -> np.ndarray:
    """Load an image file (.npy (H,W,3) uint8 passthrough, else via
    PIL) as BGR uint8 — the cv_bridge "bgr8" convention the reference's
    image callback produces."""
    if path.endswith(".npy"):
        img = np.load(path)
        assert img.ndim == 3 and img.shape[2] == 3, img.shape
        return img.astype(np.uint8)
    from PIL import Image

    rgb = np.asarray(Image.open(path).convert("RGB"))
    return rgb[:, :, ::-1].copy()


def write_colored_keyframes(
    dest_dir: str,
    keyframes,
    cam: CameraModel,
    image_for=None,
) -> int:
    """Colorize each keyframe's body-frame cloud through the camera
    model and write world-frame colored PCDs `ColoredPCDs/%06d.pcd`
    (x y z rgb) beside the session artifacts — the per-frame colored
    world cloud the reference publishes when camera_en
    (publish_frame_world_color, laserMapping.cpp:310-392), persisted
    instead of published.

    keyframes: iterable with .cloud (n,3 body frame), .pose ((7,)
    [wxyz|t]).  image_for(k) -> BGR image for keyframe k (defaults to
    the deterministic test pattern).  Returns #files written.
    """
    import os

    from ..io.pcd import write_pcd_fields
    from ..io.session import _quat_to_matrix

    os.makedirs(dest_dir, exist_ok=True)
    if image_for is None:
        pattern = test_pattern_image(cam.width, cam.height)
        image_for = lambda k: pattern  # noqa: E731
    n = 0
    for k, kf in enumerate(keyframes):
        cloud = np.asarray(kf.cloud, np.float32)
        if len(cloud) == 0:
            continue
        rgb, ok = colorize_cloud(cam, image_for(k), cloud)
        # world-frame output like the reference's published cloud
        pose = np.asarray(kf.pose, np.float64)
        R = _quat_to_matrix(pose[:4])
        world = cloud @ R.T + pose[4:7]
        rows = np.zeros((len(cloud), 4), np.float32)
        rows[:, :3] = world
        rows[:, 3] = pack_rgb_float(rgb)
        write_pcd_fields(
            os.path.join(dest_dir, f"{k:06d}.pcd"),
            ["x", "y", "z", "rgb"], rows)
        n += 1
    return n
