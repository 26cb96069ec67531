"""Port parity: pipeline/slam.py (the SLAM path) against the JAX package.

* A sync-mode SLAMPipeline beside the JAX package's, in f64 on the CPU,
  on a loop-closing circle (the fused single-association front end at
  small shapes; the loop-verification buffers cut to 2048 / 4096 points
  on both sides): the same keyframes and the same loop pairs, keyframe
  poses within 1e-6 m, ICP fitness within 1e-6.
* The session round trip: save_session's directory read back with the
  port's SessionReader (poses, odometry and loop edges, clouds, Scan
  Context descriptors, loop markers).
* SLAMPipeline on every shipped configuration that
  tests/test_torch_pipeline.py::test_shipped_configs runs, a few scans at
  its small shapes; configs/hap_livox.yaml sets dynamic_removal and
  raises the ROADMAP item 11 error.
* The behavioural assertions of tests/test_slam_backend.py and
  tests/test_gps_factor.py::test_gps_gating on the port: loop closure on
  a fabricated drifted revisit (and its loop markers), keyframe gating,
  dynamic removal refused (the JAX test runs it; the port raises
  NotImplementedError until item 11), the map rebuild after a material
  correction, the async correction applied at the snapshot count, the
  GPS gates.  The window-mode run and the GPS drift run are in
  tests/test_torch_slam_window.py.
"""

import os
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import better_fastlio2_tpu.config as jcfg
from better_fastlio2_tpu.io.synthetic import (SyntheticWorld, Trajectory,
                                              make_lio_sequence)
from better_fastlio2_tpu.pipeline.slam import SLAMPipeline as JaxSLAM
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.backend import posegraph as pg
from better_fastlio2_tpu_torch.io.session import SessionReader
from better_fastlio2_tpu_torch.map import voxel_hash
from better_fastlio2_tpu_torch.ops import scancontext as sc
from better_fastlio2_tpu_torch.parallel.distributed import AsyncBackend
from better_fastlio2_tpu_torch.pipeline.slam import Keyframe, SLAMPipeline
from better_fastlio2_tpu_torch.utils import se3, so3
from test_torch_pipeline import _args, slice_cfg
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
F32 = torch.float32


def _circle_cfg(mod):
    cfg = slice_cfg(mod)
    cfg.shapes.n_raw, cfg.shapes.n_ds, cfg.shapes.knn_chunk = 4096, 2048, 2048
    cfg.loop = mod.LoopConfig(enable=True, search_radius=4.0,
                              search_time_diff=1.5, search_num=2,
                              fitness_score=0.3)
    cfg.mapping.keyframe_adding_dist_threshold = 0.8
    cfg.mapping.keyframe_adding_angle_threshold = 0.5
    return cfg


def _circle_groups():
    """A 1 m circle at 2 m/s (a lap in ~3.1 s) in a 24 m room."""
    return make_lio_sequence(
        duration=3.5, scan_rate=10.0, imu_rate=100.0, n_points=1500, seed=5,
        noise=0.004, traj=Trajectory(t_still=0.3, speed=2.0, yaw_rate=2.0),
        world=SyntheticWorld(seed=0, half_x=12.0, half_y=12.0, height=5.0))


def _small_pads(pipe):
    pipe._CUR_PAD, pipe._OLD_PAD = 2048, 4096
    return pipe


def test_sync_slam_matches_jax():
    groups = _circle_groups()
    jp = _small_pads(JaxSLAM(_circle_cfg(jcfg), max_keyframes=64,
                             loop_every=3))
    tp = _small_pads(SLAMPipeline(_circle_cfg(tcfg), max_keyframes=64,
                                  loop_every=3, device="cpu"))
    for g in groups:
        oj, ot = jp.process_scan(*_args(g)), tp.process_scan(*_args(g))
        assert (oj is None) == (ot is None)
        if ot is not None:
            assert ot["n_keyframes"] == oj["n_keyframes"]
            np.testing.assert_allclose(ot["pos"], oj["pos"], atol=1e-6)
    jp.flush()
    tp.flush()
    assert len(tp.keyframes) == len(jp.keyframes) >= 8
    assert [p[:2] for p in tp.loop_pairs] == [p[:2] for p in jp.loop_pairs]
    assert len(tp.loop_pairs) >= 1
    np.testing.assert_allclose([p[2] for p in tp.loop_pairs],
                               [p[2] for p in jp.loop_pairs], atol=1e-6)
    for kt, kj in zip(tp.keyframes, jp.keyframes):
        assert kt.t == kj.t
        np.testing.assert_allclose(kt.pose, kj.pose, atol=1e-6)
        np.testing.assert_allclose(kt.odom_pose, kj.odom_pose, atol=1e-6)
        np.testing.assert_array_equal(kt.cloud, kj.cloud)
        np.testing.assert_array_equal(kt.desc, np.asarray(kj.desc))
    np.testing.assert_allclose(tp.graph.poses.numpy(),
                               np.asarray(jp.graph.poses), atol=1e-6)

    # the session round trip of the same run
    with tempfile.TemporaryDirectory() as td:
        tp.save_session(td)
        r = SessionReader(td)
        assert r.num_keyframes == len(tp.keyframes)
        want = np.stack([kf.pose for kf in tp.keyframes])
        np.testing.assert_allclose(r.poses, want, atol=2e-6)  # %.6f text
        assert len(r.edges) == len(tp.keyframes) - 1 + len(tp.loop_pairs)
        assert [(i, j) for i, j, _ in r.edges[-len(tp.loop_pairs):]] == [
            p[:2] for p in tp.loop_pairs]
        xyz, _ = r.cloud(3)
        np.testing.assert_allclose(xyz, tp.keyframes[3].cloud, atol=1e-6)
        np.testing.assert_allclose(r.scd(3), tp.keyframes[3].desc,
                                   atol=5e-4)  # %.3f text
        rows = open(os.path.join(td, "loop_markers.txt")).read().splitlines()
        assert len(rows) == 1 + len(tp.loop_pairs)


SHIPPED = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_configs_run_slam(name):
    """Each configs/*.yaml through SLAMPipeline at the small shapes of
    tests/test_torch_pipeline.py::test_shipped_configs (the file's own
    insert budgets and compaction kept): four scans, finite, keyframes
    made; hap_livox.yaml sets dynamic_removal, which raises."""
    cfg = tcfg.load_yaml(str(REPO / "configs" / name))
    if cfg.dynamic_removal:
        with pytest.raises(NotImplementedError, match="item 11"):
            SLAMPipeline(cfg, device="cpu")
        assert name == "hap_livox.yaml"
        return
    small = slice_cfg(tcfg).shapes
    for k in ("insert_claim_budget", "insert_dense_budget",
              "insert_mom_budget", "solve_compact"):
        setattr(small, k, getattr(cfg.shapes, k))
    cfg.shapes = small
    p = SLAMPipeline(cfg, max_keyframes=16, device="cpu")
    from test_torch_pipeline import _groups

    outs = [p.process_scan(*_args(g)) for g in _groups()[:4]]
    p.flush()
    assert outs[0] is None and outs[1] is None  # init, then the lag of 1
    assert all(np.all(np.isfinite(o["pos"])) for o in outs[2:])
    assert len(p.keyframes) >= 1


# ---- behavioural assertions of tests/test_slam_backend.py ----------------

def _cfg_small():
    cfg = tcfg.LIOConfig()
    cfg.shapes = tcfg.ShapesConfig(n_raw=4096, n_ds=2048, n_imu=32,
                                   map_capacity_log2=14, map_bucket=4,
                                   map_max_probe=8, knn_chunk=2048)
    cfg.mapping = tcfg.MappingConfig(keyframe_adding_dist_threshold=1.0,
                                     keyframe_adding_angle_threshold=0.2)
    cfg.loop = tcfg.LoopConfig(enable=True, search_radius=5.0,
                               search_time_diff=10.0, search_num=3,
                               fitness_score=0.3)
    cfg.ikdtree = tcfg.IkdtreeConfig(max_iteration=3)
    return cfg


def _room_cloud(rng, n=3000):
    k = n // 3
    floor = np.stack([rng.uniform(-10, 10, k), rng.uniform(-10, 10, k),
                      np.full(k, -1.5)], 1)
    w1 = np.stack([rng.uniform(-10, 10, k), np.full(k, 10.0),
                   rng.uniform(-1.5, 3, k)], 1)
    w2 = np.stack([np.full(k, -10.0), rng.uniform(-10, 10, k),
                   rng.uniform(-1.5, 3, k)], 1)
    return np.concatenate([floor, w1, w2]).astype(np.float32)


def _yaw_pose(yaw, t):
    q = so3.quat_exp(torch.tensor([0.0, 0.0, yaw], dtype=torch.float64))
    return np.concatenate([q.numpy(), np.asarray(t, float)])


def _make_kf(idx, t, pose7, world, rng):
    """A keyframe whose body cloud is `world` seen from pose7."""
    inv = se3.inverse(torch.as_tensor(pose7))
    body = se3.apply(inv, torch.as_tensor(world, dtype=torch.float64)).numpy()
    body = body + rng.normal(scale=0.004, size=body.shape)
    desc = sc.make_descriptor(torch.as_tensor(body, dtype=F32),
                              torch.ones(len(body), dtype=torch.bool)).numpy()
    return Keyframe(idx=idx, t=t, pose=pose7.copy(), odom_pose=pose7.copy(),
                    cloud=body.astype(np.float32), desc=desc)


def _add_graph_kf(pipe, k, pose, odom_prev=None):
    pt = torch.as_tensor(pose, dtype=F32)
    pipe.graph = pg.set_pose(pipe.graph, k, pt)
    if k == 0:
        pipe.graph = pg.add_prior(pipe.graph, 0, pt, 1e-6, 1e-6)
    else:
        rel = se3.between(torch.as_tensor(odom_prev),
                          torch.as_tensor(pose)).to(F32)
        pipe.graph = pg.add_between(pipe.graph, k - 1, k, rel, 1e-2, 1e-3)


def test_loop_closure_on_fabricated_revisit(rng):
    world = _room_cloud(rng)
    pipe = SLAMPipeline(_cfg_small(), max_keyframes=64, loop_every=1,
                        device="cpu")
    true_xs = list(np.linspace(0, 6, 7)) + list(np.linspace(5, 1, 5))
    drift = np.array([0.04, 0.03, 0.0])
    for k, x in enumerate(true_xs):
        true_pose = _yaw_pose(0.0, [x, 0, 0])
        est_pose = true_pose.copy()
        est_pose[4:7] += drift * k
        kf = _make_kf(k, float(k * 2.0), est_pose, world, rng)
        kf_true = _make_kf(k, float(k * 2.0), true_pose, world, rng)
        kf.cloud, kf.desc = kf_true.cloud, kf_true.desc
        pipe.keyframes.append(kf)
        _add_graph_kf(pipe, k, est_pose,
                      pipe.keyframes[k - 1].odom_pose if k else None)
    assert pipe._try_loop_closure(), "loop closure not detected/verified"
    i0, j0, fit0 = pipe.loop_pairs[0]
    assert 0 <= fit0 < 1.0
    with tempfile.TemporaryDirectory() as td:
        pipe.save_session(td)
        lines = open(os.path.join(td, "loop_markers.txt")).readlines()
        assert len(lines) == 1 + len(pipe.loop_pairs)
        row = lines[1].split()
        assert int(row[0]) == i0 and int(row[1]) == j0 and len(row) == 9
    pipe.lio.ls = None  # no front end here
    g = pg.optimize(pipe.graph, iters=6, cg_iters=50)
    poses = g.poses[:len(pipe.keyframes)].numpy()
    err_before = np.linalg.norm(pipe.keyframes[-1].pose[4:7] - [1.0, 0, 0])
    err_after = np.linalg.norm(poses[-1, 4:7] - [1.0, 0, 0])
    assert err_after < err_before * 0.5, (err_before, err_after)


def test_keyframe_gating():
    pipe = SLAMPipeline(_cfg_small(), max_keyframes=16, device="cpu")
    p0 = _yaw_pose(0.0, [0, 0, 0])
    assert pipe._is_keyframe(p0)
    pipe.keyframes.append(Keyframe(0, 0.0, p0, p0,
                                   np.zeros((1, 3), np.float32),
                                   np.zeros((20, 60))))
    assert not pipe._is_keyframe(_yaw_pose(0.05, [0.5, 0, 0]))
    assert pipe._is_keyframe(_yaw_pose(0.0, [1.5, 0, 0]))  # distance
    assert pipe._is_keyframe(_yaw_pose(0.3, [0.1, 0, 0]))  # angle


def test_dynamic_removal_flag_refused():
    """The JAX test runs the flag end to end; the port refuses it until
    the perception modules land (ROADMAP item 11)."""
    cfg = _cfg_small()
    cfg.dynamic_removal = True
    with pytest.raises(NotImplementedError, match="item 11"):
        SLAMPipeline(cfg, max_keyframes=32, device="cpu")


def test_map_rebuild_on_loop_correction():
    cfg = tcfg.LIOConfig()
    cfg.shapes = tcfg.ShapesConfig(n_raw=4096, n_ds=2048, n_imu=32,
                                   map_capacity_log2=15, map_bucket=4,
                                   map_max_probe=8, knn_chunk=2048)
    cfg.mapping = tcfg.MappingConfig(det_range=60., cube_len=400.,
                                     surf_leaf_size=0.4,
                                     extrinsic_est_en=False,
                                     keyframe_adding_dist_threshold=0.5)
    cfg.ikdtree = tcfg.IkdtreeConfig(max_iteration=3,
                                     filter_size_map_min=0.4)
    cfg.loop.enable = False
    pipe = SLAMPipeline(cfg, device="cpu")
    seq = dict(n_points=2500, seed=4, traj=Trajectory(t_still=1.0, speed=2.0))
    for g in make_lio_sequence(duration=3.0, **seq):
        pipe.process_scan(*_args(g))
    assert len(pipe.keyframes) >= 2
    vox_before = int(voxel_hash.num_voxels(pipe.lio.ls.map))
    poses = np.stack([kf.pose for kf in pipe.keyframes]).astype(np.float64)
    poses[:, 4] += 1.0
    pipe._apply_correction(poses, n=len(pipe.keyframes))
    assert abs(pipe.keyframes[0].pose[4] - poses[0, 4]) < 1e-9
    m = pipe.lio.ls.map
    assert int(voxel_hash.num_voxels(m)) > 0.3 * vox_before
    kf = pipe.keyframes[-1]
    R = so3.quat_to_matrix(torch.as_tensor(kf.pose[0:4])).numpy()
    world = (kf.cloud[:64] @ R.T + kf.pose[4:7]).astype(np.float32)
    _, d2, ok = voxel_hash.knn(m, torch.as_tensor(world), k=1, max_probe=8)
    hit = ok[:, 0].numpy() & (d2[:, 0].numpy() < 1e-6)
    assert hit.mean() > 0.9, hit.mean()
    errs = []
    for g in make_lio_sequence(duration=4.0, **seq)[30:]:
        out = pipe.process_scan(*_args(g))
        if out is not None:
            errs.append(out["pos"])
    assert np.all(np.isfinite(np.asarray(errs)))


def test_async_correction_applies_at_snapshot_count(rng):
    world = _room_cloud(rng)
    pipe = SLAMPipeline(_cfg_small(), max_keyframes=32, loop_every=1,
                        device="cpu")
    pipe._async = AsyncBackend("cpu")
    for k in range(4):
        pose = _yaw_pose(0.0, [float(k), 0, 0])
        pipe.keyframes.append(_make_kf(k, float(k), pose, world, rng))
        _add_graph_kf(pipe, k, pose, pipe.keyframes[k - 1].pose if k else None)
    n_snap = len(pipe.keyframes)
    assert pipe._async.submit(pipe.graph, tag=n_snap)
    assert not pipe._async.submit(pipe.graph)  # one job in flight
    late_pose = _yaw_pose(0.0, [4.0, 0, 0])
    pipe.keyframes.append(_make_kf(4, 4.0, late_pose, world, rng))
    res = None
    for _ in range(200):
        res = pipe._async.poll()
        if res is not None:
            break
        time.sleep(0.05)
    assert res is not None
    poses, tag = res
    assert tag == n_snap and not pipe._async.busy
    pipe._apply_correction(np.asarray(poses, np.float64), n=tag)
    assert np.linalg.norm(pipe.keyframes[4].pose[4:7] - late_pose[4:7]) < 0.5
    assert abs(pipe.keyframes[4].pose[4] - 4.0) < 0.5


def test_async_backend_hands_back_every_result():
    """AsyncBackend under a short thread switch interval: every submitted
    snapshot comes back once, with its own tag and its own poses (a lost
    or crossed result would break either), and a submit while busy is
    refused; a failing optimization is raised on the consumer's thread."""
    import sys

    ab = AsyncBackend("cpu", iters=2, cg_iters=5)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for k in range(12):
            g = pg.make_graph(4, 1, 4, dtype=torch.float64)
            pose = torch.tensor(_yaw_pose(0.1 * k, [k, 0.0, 0.0]))
            g = pg.add_prior(pg.set_pose(g, 0, pose), 0, pose, 1e-3, 1e-3)
            assert ab.submit(g, tag=k)
            assert not ab.submit(g, tag=-1)
            t0 = time.perf_counter()
            res = None
            while res is None and time.perf_counter() - t0 < 30.0:
                res = ab.poll()
            assert res is not None and res[1] == k
            np.testing.assert_allclose(res[0][0], pose.numpy(), atol=1e-9)
            assert not ab.busy and ab.poll() is None
    finally:
        sys.setswitchinterval(old)
    bad = pg.make_graph(4, 1, 4, dtype=torch.float64)
    assert ab.submit(bad._replace(bw_i=bad.bw_i[:1]), tag=0)
    with pytest.raises(RuntimeError):
        ab.wait()
    assert not ab.busy


# ---- tests/test_gps_factor.py::test_gps_gating -----------------------------

def test_gps_gating():
    cfg = slice_cfg(tcfg, "float32")
    cfg.gps.enable = True
    cfg.gps.min_dist = 5.0
    cfg.gps.cov_threshold = 1.0
    pipe = SLAMPipeline(cfg, device="cpu")

    def kf(i, t):
        k = Keyframe(idx=i, t=t, pose=np.zeros(7), odom_pose=np.zeros(7),
                     cloud=np.zeros((1, 3), np.float32),
                     desc=np.zeros((20, 60)))
        pipe.keyframes.append(k)
        return k

    k0 = kf(0, 10.0)
    pipe.feed_gps(10.0, [1.0, 0.0, 0.0], cov=9.0)  # covariance too high
    pipe._maybe_add_gps(k0)
    assert pipe._gps_added == 0
    pipe.feed_gps(10.01, [1.0, 0.0, 0.0], cov=0.25)
    pipe._maybe_add_gps(k0)
    assert pipe._gps_added == 1
    k1 = kf(1, 11.0)
    pipe.feed_gps(11.0, [2.0, 0.0, 0.0], cov=0.25)  # within min_dist
    pipe._maybe_add_gps(k1)
    assert pipe._gps_added == 1
    k2 = kf(2, 12.0)
    pipe.feed_gps(12.0, [7.0, 0.0, 0.0], cov=0.25)
    pipe._maybe_add_gps(k2)
    assert pipe._gps_added == 2
    assert int(pipe.graph.n_gps) == 2
