"""The bench configuration through the whole pipeline (slice 3).

* Side by side in f64: the bench configuration of bench.py:249-309 at
  small shapes (the plane cache after an 8-scan warmup, mom_dense, the
  insert budgets, solve_compact, early_converge) through the JAX
  LIOPipeline and the port, on a 24 x 24 x 5 m room that the torus
  window spans.  Positions
  agree within 1e-6 m on every scan (the runs drift apart from ~1e-15 m,
  doubling per scan: ~1e-11 m at the end); the final moment tables
  within 1e-9 (absolute, plus 1e-9 relative: a row sums up to 24 points);
  the steady program ran (the dense table was built, K1 ran on the
  compacted (16, 3000) buffer as well as at full width).  The steady
  insert of the slot moments (moments_only, the budgets) is held against
  the JAX package in tests/test_torch_plane_cache.py, and runs in the
  pipeline in tests/test_torch_pipeline.py::test_former_refusals_run.

The JAX package's pipeline tests of the plane cache run on the port in
tests/test_torch_plane_cache_tracking.py.
"""

import numpy as np

import better_fastlio2_tpu.config as jcfg
import better_fastlio2_tpu.io.synthetic as jsyn
from better_fastlio2_tpu.pipeline.lio import LIOPipeline as JaxPipeline
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.core import measurement as tm
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from torch_threads import one_torch_thread  # noqa: F401

ORIGIN = np.array([0.0, 0.0, 1.5])  # the filter's origin: the IMU at init
WARMUP = 8
COMPACT = 3000


def bench_cfg(mod, dtype="float64"):
    cfg = mod.LIOConfig()
    cfg.dtype = dtype
    cfg.shapes = mod.ShapesConfig(
        n_raw=8192, n_ds=4096, n_imu=32, map_capacity_log2=16, map_bucket=4,
        map_max_probe=8, knn_chunk=4096, map_dense_log2=(7, 7, 5),
        map_dense_z_clip=True, knn_max_live=12, insert_claim_budget=256,
        insert_dense_budget=256, insert_mom_budget=1024,
        solve_compact=COMPACT)
    cfg.mapping = mod.MappingConfig(
        gyr_cov=0.1, acc_cov=0.1, b_gyr_cov=1e-4, b_acc_cov=1e-4,
        det_range=15.0, cube_len=400.0, surf_leaf_size=0.4,
        extrinsic_est_en=False)
    cfg.ikdtree = mod.IkdtreeConfig(
        max_iteration=3, filter_size_map_min=0.4, single_association=True,
        plane_cache=True, plane_cache_warmup=WARMUP, mom_dense=True,
        early_converge=True)
    return cfg


def _args(g):
    return (g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"], g["imu_t"],
            g["scan_beg_abs"], g["scan_end_t"])


def _ate(pos, gts):
    err = [np.linalg.norm(p - (g - ORIGIN)) for p, g in zip(pos, gts)]
    return float(np.sqrt(np.mean(np.square(err)))), err


def test_bench_pipeline_side_by_side_f64():
    groups = jsyn.make_lio_sequence(
        duration=1.6, scan_rate=10.0, imu_rate=100.0, n_points=4000, seed=3,
        noise=0.004, traj=jsyn.Trajectory(t_still=0.5, speed=2.0),
        world=jsyn.SyntheticWorld(seed=0, half_x=12.0, half_y=12.0,
                                  height=5.0))
    jp = JaxPipeline(bench_cfg(jcfg))
    pos_j = []
    for g in groups:
        if jp.process_scan(*_args(g)) is not None:
            pos_j.append(np.array(jp.ls.x.pos))

    widths = []
    real = tm.fused_normal_eqs

    def spy(soa, params):
        widths.append(soa.shape[1])
        return real(soa, params)

    tp = LIOPipeline(bench_cfg(tcfg), device="cpu")
    pos_t = []
    tm.fused_normal_eqs = spy
    try:
        for g in groups:
            if tp.process_scan(*_args(g)) is not None:
                pos_t.append(tp.ls.x.pos.numpy().copy())
    finally:
        tm.fused_normal_eqs = real
    assert len(pos_t) == len(pos_j) == len(groups) - 1 > WARMUP + 5
    worst = max(np.abs(a - b).max() for a, b in zip(pos_t, pos_j))
    assert worst <= 1e-6, f"port diverged from the reference by {worst} m"
    assert _ate(pos_t, [g["gt_pos"] for g in groups[1:]])[0] < 0.10
    # the steady program ran, and K1 both compacted and at full width
    assert {COMPACT, 4096} <= set(widths)
    mj, mt = jp.ls.map, tp.ls.map
    assert mt.dmom is not None and mj.dmom is not None
    np.testing.assert_allclose(mt.dmom.numpy(), np.asarray(mj.dmom),
                               rtol=1e-9, atol=1e-9)
    # the hash tables froze at the end of the warmup, identically
    for f in ("key", "count", "dense"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(mj, f)))
