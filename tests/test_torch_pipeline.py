"""Port parity for the whole per-scan pipeline, plus the port's guards.

The configuration is tests/test_lio_pipeline.py:small_cfg with the fused
single-association solve this slice ports: single_association=True,
map_dense_log2=(8, 8, 7), knn_max_live=12.

* Side by side in f64 on make_lio_sequence (2 s): the port's positions
  agree with the JAX pipeline's to 1e-6 m on every scan (a discrete flip —
  a top-k tie, a voxel boundary, a refresh threshold — would break that,
  and the bound never exceeds 1 mm), and both track ground truth with ATE
  below 0.10 m.
* One step from a mid-run JAX state carried over with
  convert.lio_state_from_numpy: the next scan's state and map agree.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import better_fastlio2_tpu.config as jcfg
import better_fastlio2_tpu.io.synthetic as jsyn
from better_fastlio2_tpu.pipeline.lio import LIOPipeline as JaxPipeline
import better_fastlio2_tpu_torch.config as tcfg
import better_fastlio2_tpu_torch.io.synthetic as tsyn
from better_fastlio2_tpu_torch import convert
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ORIGIN = np.array([0.0, 0.0, 1.5])  # the filter's origin: the IMU at init
SNAP = 10  # scan index whose post-state seeds the one-step test


def slice_cfg(mod, dtype="float64"):
    cfg = mod.LIOConfig()
    cfg.dtype = dtype
    cfg.shapes = mod.ShapesConfig(
        n_raw=8192, n_ds=4096, n_imu=32, map_capacity_log2=16, map_bucket=4,
        map_max_probe=8, knn_chunk=4096, map_dense_log2=(8, 8, 7),
        knn_max_live=12)
    cfg.mapping = mod.MappingConfig(
        gyr_cov=0.1, acc_cov=0.1, b_gyr_cov=1e-4, b_acc_cov=1e-4,
        det_range=60.0, cube_len=400.0, surf_leaf_size=0.4,
        extrinsic_est_en=False)
    cfg.ikdtree = mod.IkdtreeConfig(max_iteration=3, filter_size_map_min=0.4,
                                    single_association=True)
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
               map_dense=np.array(m.dense),
               map_voxel_size=np.array(m.voxel_size),
               cube_lo=np.array(ls.cube_lo), cube_hi=np.array(ls.cube_hi),
               cube_init=np.array(ls.cube_init),
               last_acc_w=np.array(ls.last_acc_w),
               last_gyr_b=np.array(ls.last_gyr_b),
               ekf_inited=np.array(ls.ekf_inited))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX pipeline over the sequence: per-scan f64 positions, and the
    full state before and after scan SNAP+1."""
    groups = _groups()
    jp = JaxPipeline(slice_cfg(jcfg))
    pos, snap = {}, {}
    for k, g in enumerate(groups):
        if k == SNAP + 1:
            snap["before"] = _jax_state_arrays(jp.ls)
            snap["clock"] = (jp.acc_norm, jp.last_scan_end_abs)
        out = jp.process_scan(*_args(g))
        if out is not None:
            pos[k] = np.array(jp.ls.x.pos)
        if k == SNAP + 1:
            snap["after"] = _jax_state_arrays(jp.ls)
    return groups, pos, snap


def _ate(pos, groups):
    err = [np.linalg.norm(p - (groups[k]["gt_pos"] - ORIGIN))
           for k, p in pos.items()]
    return float(np.sqrt(np.mean(np.square(err))))


def test_pipeline_side_by_side_f64(jax_run):
    groups, pos_j, _ = jax_run
    tp = LIOPipeline(slice_cfg(tcfg), device="cpu")
    pos_t = {}
    for k, g in enumerate(groups):
        if tp.process_scan(*_args(g)) is not None:
            pos_t[k] = tp.ls.x.pos.numpy().copy()
    assert sorted(pos_t) == sorted(pos_j) and len(pos_t) >= 18
    worst = max(np.abs(pos_t[k] - pos_j[k]).max() for k in pos_j)
    assert worst <= 1e-6, f"port diverged from the reference by {worst} m"
    assert _ate(pos_j, groups) < 0.10
    assert _ate(pos_t, groups) < 0.10


def test_one_step_from_carried_state(jax_run):
    groups, _, snap = jax_run
    tp = LIOPipeline(slice_cfg(tcfg), device="cpu")
    tp.ls = convert.lio_state_from_numpy(snap["before"], device="cpu")
    tp.acc_norm, tp.last_scan_end_abs = snap["clock"]
    tp.inited = True
    out = tp.process_scan(*_args(groups[SNAP + 1]))
    assert out is not None and out["n_eff"] > 0
    got = convert.lio_state_to_numpy(tp.ls)
    want = snap["after"]
    for k in ("map_key", "map_count", "map_dense", "cube_init",
              "ekf_inited"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in (*convert.STATE_FIELDS, "P", "map_points", "cube_lo", "cube_hi",
              "last_acc_w", "last_gyr_b"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9,
                                   err_msg=k)


def test_convert_round_trip(jax_run):
    _, _, snap = jax_run
    ls = convert.lio_state_from_numpy(snap["before"], device="cpu")
    back = convert.lio_state_to_numpy(ls)
    assert set(back) == set(snap["before"])
    for k, v in snap["before"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_pipeline_f32_tracks_ground_truth():
    groups = _groups()
    tp = LIOPipeline(slice_cfg(tcfg, "float32"), device="cpu")
    pos = {}
    for k, g in enumerate(groups):
        out = tp.process_scan(*_args(g))
        if out is not None:
            pos[k] = out["pos"]
            assert out["n_ds"] > 2000
    assert np.all(np.isfinite(np.array(list(pos.values()))))
    assert _ate(pos, groups) < 0.10


def test_pipeline_device_rules():
    cfg = slice_cfg(tcfg)
    if torch.cuda.is_available():
        assert LIOPipeline(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LIOPipeline(cfg)
    assert LIOPipeline(cfg, device="cpu").device.type == "cpu"


UNSUPPORTED = {
    "rebuild": lambda c: setattr(c.ikdtree, "recontruct_kdtree", True),
    "features": lambda c: setattr(c.preprocess, "feature_extract_enable",
                                  True),
}
# refused by slice 1, ported by slice 2 (the row path, the grouped insert)
PORTED_IN_SLICE_2 = {
    "extrinsic_est": lambda c: setattr(c.mapping, "extrinsic_est_en", True),
    "row_path": lambda c: setattr(c.ikdtree, "fused_solve", False),
    "grouped_insert": lambda c: setattr(c.mapping, "surf_leaf_size", 0.5),
}


def _plane_cache(c):
    """The plane cache, its steady program from the sixth scan on."""
    c.ikdtree.plane_cache = True
    c.ikdtree.plane_cache_warmup = 5


def _mom_dense(c):
    _plane_cache(c)
    c.ikdtree.mom_dense = True
    # the (8, 8, 7) torus at 0.4 m spans 102.4 m: 2 * det_range must fit
    c.mapping.det_range = 50.0


def _insert_budget(c):
    _plane_cache(c)  # the budgets bind in the steady program only
    c.shapes.insert_claim_budget = c.shapes.insert_dense_budget = 64
    c.shapes.insert_mom_budget = 256


# refused by slices 1 and 2, ported by slice 3 (the bench configuration)
PORTED_IN_SLICE_3 = {
    "plane_cache": _plane_cache,
    "mom_dense": _mom_dense,
    "solve_compact": lambda c: setattr(c.shapes, "solve_compact", 1024),
    "insert_budget": _insert_budget,
}


# refused by slices 1-3, ported by slice 4 (window mode): the
# pipeline options they set
PORTED_IN_SLICE_4 = {
    "window": dict(window=2),
    "pipelined": dict(pipelined=True),
    "quantized": dict(quantized=True),
}


@pytest.mark.parametrize("what", sorted(UNSUPPORTED) + ["mesh"])
def test_unsupported_options_raise(what):
    cfg = slice_cfg(tcfg)
    kw = {}
    if what == "mesh":
        kw["mesh"] = object()
    else:
        UNSUPPORTED[what](cfg)
    with pytest.raises(NotImplementedError,
                       match="item 14" if what == "mesh" else None):
        LIOPipeline(cfg, device="cpu", **kw)


def test_config_matches_jax():
    import yaml

    paths = sorted((REPO / "configs").glob("*.yaml"))
    assert len(paths) >= 8
    for p in paths:
        d = yaml.safe_load(p.read_text())
        assert (tcfg.LIOConfig.from_dict(d).__dict__.__repr__()
                == jcfg.LIOConfig.from_dict(d).__dict__.__repr__()), p.name
    for det, vox in ((60.0, 0.5), (100.0, 0.4), (30.0, 0.2)):
        assert (tcfg.derive_map_dense_log2(det, vox)
                == jcfg.derive_map_dense_log2(det, vox))


def test_synthetic_copy_matches_jax_package():
    a = tsyn.make_bench_sequence("room", 3, n_points=2000)
    b = jsyn.make_bench_sequence("room", 3, n_points=2000)
    assert len(a) == len(b) == 3
    for ga, gb in zip(a, b):
        assert ga.keys() == gb.keys()
        for k in ga:
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)


def test_port_imports_no_jax():
    """Every module of the port imports without jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import better_fastlio2_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'better_fastlio2_tpu'"
        " or k.startswith('better_fastlio2_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout


@pytest.mark.parametrize("what", sorted(PORTED_IN_SLICE_2)
                         + sorted(PORTED_IN_SLICE_3)
                         + sorted(PORTED_IN_SLICE_4))
def test_former_refusals_run(what):
    """The options earlier slices refused now construct and run on the CPU:
    IMU init, the map-building scan, then updates whose associations grow
    as the young map fills in (43 valid rows by the fifth scan).  Slice 3's
    run ten scans, so that the plane-cache ones pass their five warmup
    scans and associate by the moment plane (23-145 valid rows; with the
    claim budget the map grows by at most 64 voxels a scan).  Slice 4's
    pipeline options run five scans and drain the pending results with
    flush()."""
    cfg = slice_cfg(tcfg)
    n_scans, kw = 5, PORTED_IN_SLICE_4.get(what, {})
    if what in PORTED_IN_SLICE_2:
        PORTED_IN_SLICE_2[what](cfg)
    elif what in PORTED_IN_SLICE_3:
        PORTED_IN_SLICE_3[what](cfg)
        n_scans = 10
    tp = LIOPipeline(cfg, device="cpu", **kw)
    recs, record = [], tp._record
    tp._record = lambda v: recs.append(record(v)) or recs[-1]
    outs = [tp.process_scan(*_args(g)) for g in _groups()[:n_scans]]
    if kw:  # the results come late: every record, in scan order
        tp.flush()
        outs = [None] + recs
        assert len(outs) == n_scans
    assert outs[0] is None and outs[1]["n_eff"] == 0
    assert outs[-1]["n_eff"] > 20 and outs[-1]["map_voxels"] > 8000
    assert np.all(np.isfinite(outs[-1]["pos"]))
    assert (tp.ls.map.dmom is not None) == (what == "mom_dense")
    if what == "insert_budget":
        grown = np.diff([o["map_voxels"] for o in outs[6:]])
        assert 0 < grown.max() <= 64


# the shipped configurations the port refuses, with the option at fault
SHIPPED_REFUSED: dict[str, str] = {}


@pytest.mark.parametrize("name", sorted(
    p.name for p in (REPO / "configs").glob("*.yaml")))
def test_shipped_configs(name):
    """Each configs/*.yaml through the port: the ones it carries construct
    and run ten scans on the CPU with their own mapping, ikdtree and
    preprocess options (shapes cut to this file's small ones), finite, with
    associated rows in the update once the young map has filled in (at the
    0.2 m map voxels of most of them that takes some scans on this sparse
    sequence); the rest raise NotImplementedError naming the option.  The
    sequence's identity extrinsic is not theirs, so tracking is not held
    here."""
    cfg = tcfg.load_yaml(str(REPO / "configs" / name))
    if name in SHIPPED_REFUSED:
        with pytest.raises(NotImplementedError,
                           match=SHIPPED_REFUSED[name]):
            LIOPipeline(cfg, device="cpu")
        return
    small = slice_cfg(tcfg).shapes
    for k in ("insert_claim_budget", "insert_dense_budget",
              "insert_mom_budget", "solve_compact"):
        setattr(small, k, getattr(cfg.shapes, k))  # the file's own options
    cfg.shapes = small
    tp = LIOPipeline(cfg, device="cpu")
    outs = [tp.process_scan(*_args(g)) for g in _groups()[:10]]
    assert outs[0] is None and max(o["n_eff"] for o in outs[1:]) > 0
    assert np.all(np.isfinite(np.array([o["pos"] for o in outs[1:]])))
