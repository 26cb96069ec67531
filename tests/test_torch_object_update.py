"""Port parity: apps/object_update.py against the JAX package, in f64 on
the CPU.

* ObjectUpdater on two single-keyframe sessions of the scene of
  tests/test_object_update.py (one object kept, one removed, one added),
  and on two-keyframe sessions seen from posed keyframes: the same object
  counts and the same fused, new and old clouds, point for point
  (Patchwork ground, curved-voxel clusters and PD recognition in f64);
  the written PCDs read back equal;
* the behavioural assertions of tests/test_object_update.py on the port.
"""

import os

import numpy as np
import pytest
import torch

from better_fastlio2_tpu.apps import object_update as japp
from better_fastlio2_tpu.io.session import SessionWriter
from better_fastlio2_tpu_torch.apps import object_update as tapp
from better_fastlio2_tpu_torch.io.pcd import read_pcd
from better_fastlio2_tpu_torch.utils import se3
from test_multisession import yaw_pose
from test_object_update import scene, write_one_kf_session
from torch_threads import one_torch_thread  # noqa: F401


def _write(root, clouds_poses):
    w = SessionWriter(root=root)
    for cloud, pose in clouds_poses:
        w.add_keyframe(cloud, np.zeros(len(cloud)), np.zeros((20, 60)), pose)
    w.save()


def _assert_same(rt, rj):
    for key in ("n_central_objects", "n_query_objects"):
        assert rt[key] == rj[key]
    for key in ("fused", "new", "old"):
        assert len(rt[key]) == len(rj[key])
        for a, b in zip(rt[key], rj[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("posed", [False, True])
def test_object_diff_matches_jax(tmp_path, posed):
    rng = np.random.default_rng(9)
    central = scene(rng, [(4, 3), (-5, 2)])
    query = scene(rng, [(4, 3), (6, -4)])
    cdir, qdir = str(tmp_path / "c"), str(tmp_path / "q")
    if posed:
        # each session two keyframes apart by a yawed pose: the clouds
        # meet in the shared frame through the keyframe poses
        p1 = yaw_pose(0.4, [1.0, -0.5, 0.0])
        ident = yaw_pose(0.0, [0, 0, 0])
        _write(cdir, [(central, ident), (_seen_from(p1, central), p1)])
        _write(qdir, [(query, ident), (_seen_from(p1, query), p1)])
    else:
        write_one_kf_session(cdir, central, yaw_pose(0.0, [0, 0, 0]))
        write_one_kf_session(qdir, query, yaw_pose(0.0, [0, 0, 0]))
    uj = japp.ObjectUpdater(cdir, qdir, japp.ObjectUpdateConfig(
        sensor_height=0.4, dtype="float64"))
    ut = tapp.ObjectUpdater(cdir, qdir, tapp.ObjectUpdateConfig(
        sensor_height=0.4, dtype="float64"), device="cpu")
    rj, rt = uj.run(), ut.run()
    _assert_same(rt, rj)
    assert rt["n_central_objects"] >= 2 and len(rt["new"]) >= 1
    oj, ot = str(tmp_path / "oj"), str(tmp_path / "ot")
    uj.write_outputs(rj, oj)
    ut.write_outputs(rt, ot)
    for name in ("fused", "new", "old"):
        a = read_pcd(os.path.join(oj, f"objects_{name}.pcd"))[0]
        b = read_pcd(os.path.join(ot, f"objects_{name}.pcd"))[0]
        np.testing.assert_array_equal(b, a)


def _seen_from(pose, cloud):
    """`cloud` (shared frame) in the body frame of a keyframe at `pose`."""
    inv = se3.inverse(torch.as_tensor(pose))
    return se3.apply(inv, torch.as_tensor(cloud, dtype=torch.float64)
                     ).numpy().astype(np.float32)


# ---- tests/test_object_update.py::test_object_diff ----------------------

def test_object_diff(rng, tmp_path):
    pose = yaw_pose(0.0, [0, 0, 0])
    central_cloud = scene(rng, [(4, 3), (-5, 2)])  # A persists, B goes
    query_cloud = scene(rng, [(4, 3), (6, -4)])  # C appears
    cdir, qdir = str(tmp_path / "c"), str(tmp_path / "q")
    write_one_kf_session(cdir, central_cloud, pose)
    write_one_kf_session(qdir, query_cloud, pose)
    upd = tapp.ObjectUpdater(cdir, qdir,
                             tapp.ObjectUpdateConfig(sensor_height=0.4),
                             device="cpu")
    res = upd.run()
    assert res["n_central_objects"] >= 2, res
    assert res["n_query_objects"] >= 2, res
    assert len(res["fused"]) >= 1, "persisting object not fused"
    assert len(res["new"]) >= 1, "appearing object not detected"
    assert len(res["old"]) >= 1, "disappearing object not detected"
    new_c = np.concatenate(res["new"]).mean(0)
    assert np.linalg.norm(new_c[:2] - [6, -4]) < 1.5
    old_c = np.concatenate(res["old"]).mean(0)
    assert np.linalg.norm(old_c[:2] - [-5, 2]) < 1.5
    out = str(tmp_path / "out")
    upd.write_outputs(res, out)
    assert os.path.exists(os.path.join(out, "objects_fused.pcd"))
