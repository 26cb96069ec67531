"""The JAX package's pipeline tests of the plane cache, on the port.

In f32 on the CPU at their own lengths and bounds:
tests/test_plane_cache.py:117 (slot moments after the 12-scan warmup),
tests/test_mom_dense.py:154 (the dense moment table) and :228 (a column
far taller than the torus z span, with map_dense_z_clip), and
tests/test_transient_reassoc.py (the plane cache engaging before the
motion onset; the lazy re-association absorbs the transient).
"""

import numpy as np
import torch

import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.io.synthetic import (SyntheticWorld,
                                                    Trajectory,
                                                    make_lio_sequence)
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from torch_threads import one_torch_thread  # noqa: F401

ORIGIN = np.array([0.0, 0.0, 1.5])  # the filter's origin: the IMU at init


def _room_groups(duration=4.0):
    return make_lio_sequence(duration=duration, scan_rate=10.0,
                             imu_rate=100.0, n_points=4000, seed=3,
                             noise=0.004,
                             traj=Trajectory(t_still=1.0, speed=2.0))


def small_cfg():
    """tests/test_lio_pipeline.py:small_cfg on the port (f32)."""
    cfg = tcfg.LIOConfig()
    cfg.shapes = tcfg.ShapesConfig(n_raw=8192, n_ds=4096, n_imu=32,
                                   map_capacity_log2=16, map_bucket=4,
                                   map_max_probe=8, knn_chunk=4096)
    cfg.mapping = tcfg.MappingConfig(
        gyr_cov=0.1, acc_cov=0.1, b_gyr_cov=1e-4, b_acc_cov=1e-4,
        det_range=60.0, cube_len=400.0, surf_leaf_size=0.4,
        extrinsic_est_en=False)
    cfg.ikdtree = tcfg.IkdtreeConfig(max_iteration=3,
                                     filter_size_map_min=0.4)
    return cfg


def _track(cfg, groups, extra=None):
    pipe = LIOPipeline(cfg, device="cpu")
    errs = []
    for i, g in enumerate(groups):
        pts, pt_t = g["pts"], g["pt_t"]
        if extra is not None:
            col = extra(i)
            pts = np.concatenate([pts, col])
            pt_t = np.concatenate([pt_t, np.zeros(len(col), np.float32)])
        out = pipe.process_scan(pts, pt_t, g["imu_acc"], g["imu_gyr"],
                                g["imu_t"], g["scan_beg_abs"],
                                g["scan_end_t"])
        if out is not None:
            errs.append(np.linalg.norm(out["pos"] - (g["gt_pos"] - ORIGIN)))
    return pipe, float(np.sqrt(np.mean(np.square(errs)))), errs


def test_lio_plane_cache_tracks_trajectory():
    """tests/test_plane_cache.py:117: the plane cache (slot moments) after
    the default 12-scan warmup tracks the room."""
    cfg = small_cfg()
    cfg.ikdtree.plane_cache = True
    pipe, ate, errs = _track(cfg, _room_groups())
    assert pipe.ls.map.mom is not None and pipe.ls.map.dmom is None
    assert ate < 0.10, f"plane-cache ATE RMSE {ate:.3f} m"
    assert errs[-1] < 0.15


def _mom_dense_cfg():
    cfg = small_cfg()
    kd = cfg.ikdtree
    kd.plane_cache, kd.plane_cache_warmup = True, 12
    kd.mom_dense = kd.single_association = True
    cfg.mapping.det_range = 20.0  # 2*det_range must fit the x/y span
    cfg.shapes.map_dense_log2 = (8, 8, 5)
    cfg.shapes.map_dense_z_clip = True
    cfg.shapes.insert_mom_budget = 1024
    return cfg


def test_lio_mom_dense_tracks_trajectory():
    """tests/test_mom_dense.py:154 at its full length (40 scans)."""
    pipe, ate, errs = _track(_mom_dense_cfg(), _room_groups())
    assert pipe.ls.map.dmom is not None  # the steady program ran
    assert ate < 0.10, f"mom_dense ATE RMSE {ate:.3f} m"
    assert errs[-1] < 0.15


def test_z_clip_tall_geometry_stays_consistent():
    """tests/test_mom_dense.py:228 at its full length: a column 0..30 m
    tall in every scan, far past a 6.4 m z span with map_dense_z_clip;
    the sensor-centred insert window keeps the table consistent."""
    cfg = _mom_dense_cfg()
    cfg.shapes.map_dense_log2 = (8, 8, 4)  # z span 6.4 m
    rng = np.random.default_rng(7)
    k = 160

    def column(_):
        return np.stack([np.full(k, 3.0) + 0.02 * rng.standard_normal(k),
                         0.02 * rng.standard_normal(k),
                         np.linspace(-1.0, 30.0, k)], axis=1).astype(
                             np.float32)

    pipe, ate, _ = _track(cfg, _room_groups(), extra=column)
    dm = pipe.ls.map.dmom
    assert dm is not None
    assert bool(torch.isfinite(dm).all()), "corrupted moment rows"
    assert float(dm[:, 1].min()) >= 0.0, "negative count = alias corruption"
    assert ate < 0.15, f"tall-geometry z-clip ATE {ate:.3f} m"


def test_plane_cache_single_assoc_survives_motion_onset():
    """tests/test_transient_reassoc.py: a corridor with partitions, the
    plane cache engaging (warmup 6) before motion starts at scan 10; the
    lazy re-association must absorb the velocity transient."""
    world = SyntheticWorld(seed=3, half_x=40.0, half_y=10.0, height=6.0,
                           density=25.0)
    rng = np.random.default_rng(5)
    extra = []
    for i, wx in enumerate(range(-36, 42, 12)):
        side = 1 if i % 2 == 0 else -1
        n = 1500
        y = rng.uniform(0 if side > 0 else -10, 10 if side > 0 else 0, n)
        z = rng.uniform(0, 6.0, n)
        extra.append(np.stack([np.full(n, float(wx)), y, z], 1))
    world.points = np.concatenate([world.points] + extra)
    groups = make_lio_sequence(
        duration=5.0, n_points=2500, seed=11, noise=0.004,
        traj=Trajectory(t_still=1.0, speed=3.0, yaw_amp=0.12), world=world)
    cfg = tcfg.LIOConfig()
    cfg.shapes = tcfg.ShapesConfig(n_raw=4096, n_ds=4096, n_imu=32,
                                   map_capacity_log2=16, map_bucket=4,
                                   map_max_probe=8, knn_chunk=4096)
    cfg.mapping = tcfg.MappingConfig(det_range=60., cube_len=500.,
                                     surf_leaf_size=0.4,
                                     extrinsic_est_en=False)
    cfg.ikdtree = tcfg.IkdtreeConfig(max_iteration=3,
                                     filter_size_map_min=0.4,
                                     plane_cache=True, plane_cache_warmup=6,
                                     single_association=True)
    _, _, errs = _track(cfg, groups)
    final = float(np.mean(errs[-5:]))
    assert final < 0.3, f"motion-onset transient not absorbed: {final:.3f} m"
