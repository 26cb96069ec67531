"""Port parity: the host numpy copies perception/colorize.py and
io/evaluate.py against the JAX package's modules.

* colorize_cloud, points_in_boxes, pack_rgb_float, test_pattern_image,
  CameraModel.from_config, load_image_bgr and write_colored_keyframes give
  the same arrays and the same files as the JAX package's on seeded
  inputs;
* pr_rr_f1, ate_rmse, rpe and rpe_rot give the same numbers;
* the colorize assertions of tests/test_features_colorize.py on the port.
"""

from dataclasses import dataclass

import numpy as np

import better_fastlio2_tpu.io.evaluate as jev
import better_fastlio2_tpu.perception.colorize as jcol
import better_fastlio2_tpu_torch.io.evaluate as tev
import better_fastlio2_tpu_torch.perception.colorize as tcol
from better_fastlio2_tpu_torch.io.pcd import read_pcd_fields
from torch_threads import one_torch_thread  # noqa: F401


@dataclass
class KF:
    cloud: np.ndarray
    pose: np.ndarray


def _cam(mod, w=64, h=48):
    K = np.array([[100.0, 0, 32, 0], [0, 100, 24, 0], [0, 0, 1, 0]])
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.05, 0.02]
    return mod.CameraModel(intrinsics=K, extrinsics=T, width=w, height=h)


def test_colorize_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-2, 2, 500), rng.uniform(-2, 2, 500),
                    rng.uniform(-1, 6, 500)], 1)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    for a, b in zip(jcol.colorize_cloud(_cam(jcol), img, pts),
                    tcol.colorize_cloud(_cam(tcol), img, pts)):
        np.testing.assert_array_equal(a, b)
    boxes = np.array([[0, 0, 30, 30], [20, 10, 60, 40], [5, 5, 6, 6]])
    probs = np.array([0.9, 0.7, 0.5])
    np.testing.assert_array_equal(
        jcol.points_in_boxes(_cam(jcol), pts, boxes, probs),
        tcol.points_in_boxes(_cam(tcol), pts, boxes, probs))
    rgb = rng.integers(0, 256, (50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(jcol.pack_rgb_float(rgb).view(np.uint32),
                                  tcol.pack_rgb_float(rgb).view(np.uint32))
    np.testing.assert_array_equal(jcol.test_pattern_image(64, 48),
                                  tcol.test_pattern_image(64, 48))
    block = {"camera_internal": list(np.arange(12.0)),
             "camera_external": list(np.eye(4).reshape(-1))}
    cj = jcol.CameraModel.from_config(block, 64, 48)
    ct = tcol.CameraModel.from_config(block, 64, 48)
    np.testing.assert_array_equal(cj.intrinsics, ct.intrinsics)
    np.testing.assert_array_equal(cj.extrinsics, ct.extrinsics)
    np.save(tmp_path / "img.npy", img)
    np.testing.assert_array_equal(
        jcol.load_image_bgr(str(tmp_path / "img.npy")),
        tcol.load_image_bgr(str(tmp_path / "img.npy")))

    # the world-frame colored keyframes, file for file
    yaw = 0.7
    pose = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2), 3.0, -1.0, 0.5])
    kfs = [KF(pts[:200].astype(np.float32), pose),
           KF(pts[200:].astype(np.float32), np.array([1.0, 0, 0, 0, 0, 0, 0]))]
    nj = jcol.write_colored_keyframes(str(tmp_path / "j"), kfs, _cam(jcol))
    nt = tcol.write_colored_keyframes(str(tmp_path / "t"), kfs, _cam(tcol))
    assert nj == nt == 2
    for k in range(2):
        fj, rj = read_pcd_fields(str(tmp_path / "j" / f"{k:06d}.pcd"))
        ft, rt = read_pcd_fields(str(tmp_path / "t" / f"{k:06d}.pcd"))
        assert fj == ft
        np.testing.assert_array_equal(rj.view(np.uint32), rt.view(np.uint32))


def test_evaluate_matches_jax():
    rng = np.random.default_rng(4)
    pred, gt = rng.random(1000) < 0.3, rng.random(1000) < 0.25
    assert jev.pr_rr_f1(pred, gt) == tev.pr_rr_f1(pred, gt)
    est = np.cumsum(rng.normal(size=(60, 3)), axis=0)
    ref = est + rng.normal(scale=0.1, size=est.shape)
    for align in (True, False):
        assert jev.ate_rmse(est, ref, align) == tev.ate_rmse(est, ref, align)
    q = rng.normal(size=(60, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e7 = np.concatenate([q, est], 1)
    g7 = np.concatenate([q + 0.01, ref], 1)
    assert jev.rpe(e7, g7, 5) == tev.rpe(e7, g7, 5)
    assert jev.rpe_rot(e7, g7, 5) == tev.rpe_rot(e7, g7, 5)
    t = np.arange(50) * 0.1
    for a, b in zip(jev.associate(t + 0.01, t), tev.associate(t + 0.01, t)):
        np.testing.assert_array_equal(a, b)


# ---- the colorize assertions of tests/test_features_colorize.py ----------

def test_colorize_and_boxes():
    K = np.array([[500.0, 0, 320, 0], [0, 500, 240, 0], [0, 0, 1, 0]])
    cam = tcol.CameraModel(intrinsics=K, extrinsics=np.eye(4), width=640,
                           height=480)
    img = np.zeros((480, 640, 3), np.uint8)
    img[:, :320] = (255, 0, 0)  # left half blue (BGR)
    img[:, 320:] = (0, 0, 255)  # right half red
    pts = np.array([[-1.0, 0.0, 5.0], [1.0, 0.0, 5.0], [0.0, 0.0, -5.0]])
    rgb, ok = tcol.colorize_cloud(cam, img, pts)
    assert ok[0] and ok[1] and not ok[2]
    assert tuple(rgb[0]) == (0, 0, 255)  # blue pixel -> RGB
    assert tuple(rgb[1]) == (255, 0, 0)
    boxes = np.array([[300, 200, 640, 480]])
    hit = tcol.points_in_boxes(cam, pts, boxes, probs=np.array([0.9]))
    assert not hit[0] and hit[1] and not hit[2]
    # a low-probability box is ignored (the reference's 0.6 gate)
    assert not tcol.points_in_boxes(cam, pts, boxes,
                                    probs=np.array([0.5])).any()


def test_pack_rgb_float_roundtrip():
    rgb = np.array([[255, 128, 1], [0, 0, 0], [10, 20, 30]], np.uint8)
    packed = tcol.pack_rgb_float(rgb).view(np.uint32)
    assert packed[0] == 0x00FF8001
    assert packed[1] == 0
    assert packed[2] == (10 << 16) | (20 << 8) | 30


def test_write_colored_keyframes_pixel_pickup(tmp_path):
    K = np.array([[100.0, 0, 32, 0], [0, 100, 24, 0], [0, 0, 1, 0]])
    cam = tcol.CameraModel(intrinsics=K, extrinsics=np.eye(4), width=64,
                           height=48)
    cloud = np.array([[0, 0, 2.0], [0.4, 0, 2.0], [50, 50, -1.0]],
                     np.float32)  # the third point is behind the camera
    pose = np.array([1, 0, 0, 0, 10.0, -5.0, 2.0])
    assert tcol.write_colored_keyframes(str(tmp_path), [KF(cloud, pose)],
                                        cam) == 1
    fields, rows = read_pcd_fields(str(tmp_path / "000000.pcd"))
    assert fields == ["x", "y", "z", "rgb"]
    np.testing.assert_allclose(rows[:, :3], cloud + pose[4:7], atol=1e-5)
    img = tcol.test_pattern_image(64, 48)
    packed = rows[:, 3].view(np.uint32)
    for i, col in ((0, 32), (1, 52)):
        exp = img[24, col]  # BGR
        assert packed[i] == ((int(exp[2]) << 16) | (int(exp[1]) << 8)
                             | int(exp[0]))
    assert packed[2] == 0  # an out-of-view point is black
