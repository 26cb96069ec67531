"""Port parity for the whole per-scan pipeline on the ESIKF row path.

The configuration is tests/test_lio_pipeline.py:small_cfg as is (the
default single_association=False: the full 5-NN association reruns on
every converged pass, and the row path solves through
ops/kernels.fused_hth), in three variants:

* ``row``: extrinsic estimation off, 6 gain columns;
* ``ext``: extrinsic estimation on, 12 gain columns, starting from the
  sequence's identity extrinsic, which the filter then estimates;
* ``grouped``: scan leaf 0.2 m against the 0.4 m map voxel, so the insert
  groups its rows by voxel (the sorting insert).

Side by side in f64 on make_lio_sequence (2 s, seed 3): the port's
positions agree with the JAX pipeline's to 1e-6 m on every scan (a
discrete flip — a top-k tie, a voxel boundary, the robust gate — would
break that, and the bound never exceeds 1 mm; none is seen, the worst
reading is ~2e-13 m), and both track ground truth with ATE below 0.10 m
(the JAX package reads 0.0225, 0.0226 and 0.0450 m here, over 19 tracked
scans).  One step from a mid-run JAX state of the ``ext`` run, carried
over with convert.lio_state_from_numpy, reproduces the next state and map.
An f32 run of ``ext`` tracks ground truth.

tests/test_lio_pipeline.py:125 (stationary) on the port, in f32 on the
CPU, for the fused single-association solve (K1's path) and the row path
(K2's): over the same seeded sequence that never moves (seed 5, 2.5 s),
the last position stays within 0.05 m of where it started (the port
reads 0.015 m on both paths).
"""

import numpy as np
import pytest

import better_fastlio2_tpu.config as jcfg
import better_fastlio2_tpu.io.synthetic as jsyn
from better_fastlio2_tpu.pipeline.lio import LIOPipeline as JaxPipeline
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch import convert
from better_fastlio2_tpu_torch.ops import kernels as tk
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from torch_threads import one_torch_thread  # noqa: F401

ORIGIN = np.array([0.0, 0.0, 1.5])  # the filter's origin: the IMU at init
SNAP = 10  # scan index whose post-state seeds the one-step test
VARIANTS = ("row", "ext", "grouped")


def small_cfg(mod, variant, dtype="float64"):
    """tests/test_lio_pipeline.py:small_cfg, in one of the VARIANTS."""
    cfg = mod.LIOConfig()
    cfg.dtype = dtype
    cfg.shapes = mod.ShapesConfig(
        n_raw=8192, n_ds=4096, n_imu=32, map_capacity_log2=16, map_bucket=4,
        map_max_probe=8, knn_chunk=4096)
    cfg.mapping = mod.MappingConfig(
        gyr_cov=0.1, acc_cov=0.1, b_gyr_cov=1e-4, b_acc_cov=1e-4,
        det_range=60.0, cube_len=400.0,
        surf_leaf_size=0.2 if variant == "grouped" else 0.4,
        extrinsic_est_en=variant == "ext")
    cfg.ikdtree = mod.IkdtreeConfig(max_iteration=3, filter_size_map_min=0.4)
    return cfg


def _groups():
    return jsyn.make_lio_sequence(
        duration=2.0, scan_rate=10.0, imu_rate=100.0, n_points=3000, seed=3,
        noise=0.004, traj=jsyn.Trajectory(t_still=0.5, speed=2.0))


def _args(g):
    return (g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"], g["imu_t"],
            g["scan_beg_abs"], g["scan_end_t"])


def _jax_state_arrays(ls):
    """A JAX LIOState as the numpy arrays convert.lio_state_from_numpy
    reads (copies: the JAX step donates its input buffers)."""
    out = {k: np.array(v) for k, v in zip(ls.x._fields, ls.x)}
    m = ls.map
    out.update(P=np.array(ls.P), map_key=np.array(m.key),
               map_count=np.array(m.count), map_points=np.array(m.points),
               map_dense=None if m.dense is None else np.array(m.dense),
               map_voxel_size=np.array(m.voxel_size),
               cube_lo=np.array(ls.cube_lo), cube_hi=np.array(ls.cube_hi),
               cube_init=np.array(ls.cube_init),
               last_acc_w=np.array(ls.last_acc_w),
               last_gyr_b=np.array(ls.last_gyr_b),
               ekf_inited=np.array(ls.ekf_inited))
    return out


@pytest.fixture(scope="module")
def groups():
    return _groups()


@pytest.fixture(scope="module")
def jax_runs(groups):
    """The JAX pipeline over the sequence in each variant: per-scan f64
    positions, and for ``ext`` the full state before and after scan
    SNAP+1."""
    runs = {}
    for variant in VARIANTS:
        jp = JaxPipeline(small_cfg(jcfg, variant))
        pos, snap = {}, {}
        for k, g in enumerate(groups):
            if variant == "ext" and k == SNAP + 1:
                snap["before"] = _jax_state_arrays(jp.ls)
                snap["clock"] = (jp.acc_norm, jp.last_scan_end_abs)
            if jp.process_scan(*_args(g)) is not None:
                pos[k] = np.array(jp.ls.x.pos)
            if variant == "ext" and k == SNAP + 1:
                snap["after"] = _jax_state_arrays(jp.ls)
        runs[variant] = (pos, snap)
    return runs


def _ate(pos, groups):
    err = [np.linalg.norm(p - (groups[k]["gt_pos"] - ORIGIN))
           for k, p in pos.items()]
    return float(np.sqrt(np.mean(np.square(err))))


@pytest.mark.parametrize("variant", VARIANTS)
def test_row_pipeline_side_by_side_f64(variant, groups, jax_runs):
    pos_j = jax_runs[variant][0]
    tp = LIOPipeline(small_cfg(tcfg, variant), device="cpu")
    pos_t = {}
    for k, g in enumerate(groups):
        if tp.process_scan(*_args(g)) is not None:
            pos_t[k] = tp.ls.x.pos.numpy().copy()
    assert sorted(pos_t) == sorted(pos_j) and len(pos_t) >= 18
    worst = max(np.abs(pos_t[k] - pos_j[k]).max() for k in pos_j)
    assert worst <= 1e-6, f"port diverged from the reference by {worst} m"
    assert _ate(pos_j, groups) < 0.10
    assert _ate(pos_t, groups) < 0.10
    if variant == "ext":  # the extrinsic was estimated, and stayed close
        assert np.abs(tp.ls.x.off_t.numpy()).max() < 0.05


def test_one_step_from_carried_state_extrinsic(groups, jax_runs):
    snap = jax_runs["ext"][1]
    tp = LIOPipeline(small_cfg(tcfg, "ext"), device="cpu")
    tp.ls = convert.lio_state_from_numpy(snap["before"], device="cpu")
    tp.acc_norm, tp.last_scan_end_abs = snap["clock"]
    tp.inited = True
    out = tp.process_scan(*_args(groups[SNAP + 1]))
    assert out is not None and out["n_eff"] > 0
    got = convert.lio_state_to_numpy(tp.ls)
    want = snap["after"]
    assert got["map_dense"] is None and want["map_dense"] is None
    for k in ("map_key", "map_count", "cube_init", "ekf_inited"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in (*convert.STATE_FIELDS, "P", "map_points", "cube_lo", "cube_hi",
              "last_acc_w", "last_gyr_b"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9,
                                   err_msg=k)
    # the extrinsic moved off its carried value: the 12-column gain ran
    assert np.abs(got["off_t"] - snap["before"]["off_t"]).max() > 0


def test_row_pipeline_f32_tracks_ground_truth(groups):
    tp = LIOPipeline(small_cfg(tcfg, "ext", "float32"), device="cpu")
    before = tk.fused_hth.launches
    pos = {}
    for k, g in enumerate(groups):
        out = tp.process_scan(*_args(g))
        if out is not None:
            pos[k] = out["pos"]
            assert out["n_ds"] > 2000
    assert tk.fused_hth.launches == before  # CPU: the plain version
    assert len(pos) >= 18
    assert np.all(np.isfinite(np.array(list(pos.values()))))
    assert _ate(pos, groups) < 0.10


@pytest.mark.parametrize("path", ["fused", "row"])
def test_stationary_stays_put(path):
    groups = jsyn.make_lio_sequence(
        duration=2.5, scan_rate=10.0, imu_rate=100.0, n_points=3000, seed=5,
        noise=0.003, traj=jsyn.Trajectory(t_still=1e9))  # never moves
    cfg = small_cfg(tcfg, "row", "float32")
    cfg.ikdtree.single_association = path == "fused"
    tp = LIOPipeline(cfg, device="cpu")
    outs = [tp.process_scan(*_args(g)) for g in groups]
    outs = [o for o in outs if o is not None]
    assert len(outs) == len(groups) - 1 and outs[-1]["n_eff"] > 1000
    last = outs[-1]
    drift = np.linalg.norm(last["pos"] - (groups[-1]["gt_pos"] - ORIGIN))
    assert drift < 0.05, f"stationary drift {drift:.3f} m"
