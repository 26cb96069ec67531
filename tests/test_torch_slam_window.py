"""The SLAM path in window mode, and its long behavioural runs, on the CPU.

* SLAMPipeline over the bench configuration's window driver (W = 4,
  quantized, pipelined; tests/test_torch_window.py's small room) beside
  the JAX package's, in f64, with a +1 m x correction forced through
  _apply_correction mid-run (the pose feedback, then the jump-gated map
  reset with its dense moment table, both through LIOPipeline.ls's
  setter, while a scan waits in the open window): the trajectories
  within 1e-6 m on every scan, the keyframe poses within 1e-6 m, and the
  state after the correction follows the shifted frame.  The same
  replacement on CUDA, where a captured graph holds the state, is
  tests/test_torch_cuda.py::test_cuda_graph_takes_replaced_state.
* tests/test_slam_backend.py::test_windowed_slam_pipeline_tracks_and_loops
  on the port (async back end on the host, W = 2 quantized windows, a
  loop-closing circle): keyframing survives the window lag, flush()
  drains, the corrected keyframes are no worse than odometry.
* tests/test_gps_factor.py::test_gps_bounds_drift on the port: GPS fixes
  bound the drift of an un-modelled accelerometer bias in an open
  corridor.
"""

import numpy as np

import better_fastlio2_tpu.config as jcfg
from better_fastlio2_tpu.io import native as jnative
from better_fastlio2_tpu.io.synthetic import (SyntheticWorld, Trajectory,
                                              make_lio_sequence)
from better_fastlio2_tpu.pipeline.slam import SLAMPipeline as JaxSLAM
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.io import native as tnative
from better_fastlio2_tpu_torch.pipeline.slam import SLAMPipeline
from test_torch_pipeline import _args
from test_torch_pipeline_bench import bench_cfg
from torch_threads import one_torch_thread  # noqa: F401

SHIFT_AT = 15  # scans fed before the forced correction (3 windows run)


def _window_cfg(mod):
    cfg = bench_cfg(mod)
    cfg.loop.enable = False
    cfg.mapping.keyframe_adding_dist_threshold = 0.5
    return cfg


def _bench_groups():
    return make_lio_sequence(
        duration=2.2, scan_rate=10.0, imu_rate=100.0, n_points=4000, seed=3,
        noise=0.004, traj=Trajectory(t_still=0.5, speed=2.0),
        world=SyntheticWorld(seed=0, half_x=12.0, half_y=12.0, height=5.0))


def _shift(pipe):
    poses = np.stack([kf.pose for kf in pipe.keyframes]).astype(np.float64)
    poses[:, 4] += 1.0
    pipe._apply_correction(poses, n=len(pipe.keyframes))


def test_window_slam_forced_correction_matches_jax(monkeypatch):
    monkeypatch.setattr(jnative, "pack_quant_bulk", lambda *a: None)
    monkeypatch.setattr(tnative, "pack_quant_bulk", lambda *a: None)
    groups = _bench_groups()
    kw = dict(max_keyframes=32, lio_kwargs=dict(window=4, quantized=True))
    jp = JaxSLAM(_window_cfg(jcfg), **kw)
    tp = SLAMPipeline(_window_cfg(tcfg), device="cpu", **kw)
    for k, g in enumerate(groups):
        if k == SHIFT_AT:
            assert tp.lio.ls.map.dmom is not None  # the steady program runs
            assert len(tp.lio._wbuf) == 2  # scans wait in the open window
            pos0 = tp.lio.ls.x.pos.clone()
            for p in (jp, tp):
                _shift(p)
            # the pose feedback and the reset reached the state
            assert abs(float(tp.lio.ls.x.pos[0] - pos0[0]) - 1.0) < 1e-9
            np.testing.assert_allclose(tp.lio.ls.x.pos.numpy(),
                                       np.asarray(jp.lio.ls.x.pos), atol=1e-9)
            np.testing.assert_allclose(tp.lio.ls.cube_lo.numpy(),
                                       np.asarray(jp.lio.ls.cube_lo),
                                       atol=1e-9)
        jp.process_scan(*_args(g))
        tp.process_scan(*_args(g))
    jp.flush()
    tp.flush()
    tj, tt = np.array(jp.lio.trajectory), np.array(tp.lio.trajectory)
    assert tj.shape == tt.shape == (len(groups) - 1, 7)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-6)
    assert len(tp.keyframes) == len(jp.keyframes) >= 3
    for kt, kj in zip(tp.keyframes, jp.keyframes):
        np.testing.assert_allclose(kt.pose, kj.pose, atol=1e-6)
    # the scans after the correction track the shifted frame
    gt = np.array([g["gt_pos"] for g in groups[1:]]) - [0, 0, 1.5]
    err = np.linalg.norm(tt[-3:, :3] - (gt[-3:] + [1.0, 0, 0]), axis=1)
    assert err.max() < 0.1, err


def _cfg_small():
    cfg = tcfg.LIOConfig()
    cfg.shapes = tcfg.ShapesConfig(n_raw=4096, n_ds=2048, n_imu=32,
                                   map_capacity_log2=14, map_bucket=4,
                                   map_max_probe=8, knn_chunk=2048)
    cfg.mapping = tcfg.MappingConfig(keyframe_adding_dist_threshold=0.8,
                                     keyframe_adding_angle_threshold=0.2)
    cfg.loop = tcfg.LoopConfig(enable=True, search_radius=8.0,
                               search_time_diff=6.0, search_num=3,
                               fitness_score=0.3)
    cfg.ikdtree = tcfg.IkdtreeConfig(max_iteration=3)
    return cfg


def test_windowed_slam_pipeline_tracks_and_loops():
    groups = list(make_lio_sequence(
        duration=14.0, scan_rate=10.0, imu_rate=100.0, n_points=3000,
        seed=5, noise=0.004,
        traj=Trajectory(t_still=0.8, speed=1.6, yaw_rate=0.7)))
    pipe = SLAMPipeline(_cfg_small(), max_keyframes=128, loop_every=2,
                        async_backend=True, backend_on_host=True,
                        lio_kwargs=dict(window=2, quantized=True),
                        device="cpu")
    outs = []
    for g in groups:
        out = pipe.process_scan(*_args(g))
        if out is not None:
            outs.append(out)
    pipe.flush()
    pipe.close()
    assert len(pipe.keyframes) >= 8
    assert len(outs) > 50
    t2gt = {round(g["scan_beg_abs"] + g["scan_end_t"], 6): g["gt_pos"]
            for g in groups}
    gt, odo, corr = [], [], []
    for kf in pipe.keyframes:
        g = t2gt.get(round(kf.t, 6))
        if g is not None:
            gt.append(g)
            odo.append(kf.odom_pose[4:7])
            corr.append(kf.pose[4:7])
    gt = np.asarray(gt) - gt[0]
    odo = np.asarray(odo) - odo[0]
    corr = np.asarray(corr) - corr[0]
    ate_odo = float(np.sqrt(np.mean(np.sum((odo - gt) ** 2, 1))))
    ate_corr = float(np.sqrt(np.mean(np.sum((corr - gt) ** 2, 1))))
    assert np.isfinite(ate_corr)
    assert ate_corr < max(0.3, ate_odo * 1.05), (ate_corr, ate_odo)
    if pipe.loop_pairs:
        assert ate_corr <= ate_odo * 1.01


ACC_BIAS = np.array([0.1, 0.0, 0.0])  # m/s^2, un-modelled, along-track


def _gps_run(with_gps: bool):
    """tests/test_gps_factor.py:_run on the port."""
    w = SyntheticWorld(seed=11, half_x=30.0, half_y=4.0, height=5.0)
    w.points = w.points[np.abs(w.points[:, 0]) < 29.0]  # open ends
    traj = Trajectory(t_still=1.0, speed=2.0, yaw_amp=0.0)
    groups = make_lio_sequence(duration=6.0, scan_rate=10.0, imu_rate=100.0,
                               n_points=4000, seed=11, noise=0.004,
                               traj=traj, world=w)
    from test_torch_window import small_cfg

    cfg = small_cfg(tcfg)
    cfg.loop.enable = False
    cfg.mapping.keyframe_adding_dist_threshold = 0.3
    cfg.mapping.keyframe_adding_angle_threshold = 0.15
    cfg.gps.enable = with_gps
    cfg.gps.sigma, cfg.gps.min_dist, cfg.gps.max_age = 0.05, 0.5, 0.30
    pipe = SLAMPipeline(cfg, loop_every=4, device="cpu")
    rng = np.random.default_rng(99)
    origin = np.array([0.0, 0.0, 1.5])
    t_gps = 1.2
    for g in groups:
        acc = np.asarray(g["imu_acc"], float).copy()
        if g["scan_beg_abs"] > 1.0:
            acc = acc + ACC_BIAS
        if with_gps and g["scan_beg_abs"] + g["scan_end_t"] >= t_gps:
            fix = traj.pos(t_gps) - origin + rng.normal(scale=0.05, size=3)
            pipe.feed_gps(t_gps, fix, cov=0.0025)
            t_gps += 1.0
        pipe.process_scan(g["pts"], g["pt_t"], acc, g["imu_gyr"], g["imu_t"],
                          g["scan_beg_abs"], g["scan_end_t"])
    assert pipe.keyframes
    gt_end = groups[-1]["gt_pos"] - origin
    return float(np.linalg.norm(pipe.keyframes[-1].pose[4:7] - gt_end)), pipe


def test_gps_bounds_drift():
    err_no, _ = _gps_run(with_gps=False)
    err_gps, pipe = _gps_run(with_gps=True)
    assert pipe._gps_added >= 3
    assert int(pipe.graph.n_gps) == pipe._gps_added
    assert err_no > 0.5, err_no
    assert err_gps < err_no * 0.6, (err_gps, err_no)
    assert err_gps < 1.0, err_gps
