"""Port parity: the map rebuild (ROADMAP item 9) against the JAX package.

* `rebuild` (with and without a centre, with moments, a dense index and a
  dense moment table) and the insert's `claim_only` pass: the port's
  tables equal the JAX package's bit for bit, in f64 and f32, on crops
  that leave tombstones.  `knn_sortjoin`: the same neighbours bit for
  bit, their squared distances (f64 sums in another order) to 1e-12.
* The behavioural assertions of the JAX tests, on the port alone:
  tests/test_voxel_map.py:63 (crop then rebuild keeps the live set),
  :120 and :135 (knn_sortjoin equals the probing kNN, respects a crop),
  :181 (a rebuilt dense-index map keeps its index and its results), :322
  (moments_only voxels survive crop and rebuild with their moments),
  the rebuild half of tests/test_plane_cache.py:94 (rebuild carries the
  full moment accumulation) and tests/test_mom_dense.py:336 (rebuild
  carries the dense moment table).
* One `recontruct_kdtree` pipeline (a small FoV cube, kd_step 2, so the
  crops leave tombstones and the rebuild fires) beside the JAX pipeline
  in f64: positions within 1e-6 m on every scan, the same rebuild scans.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import better_fastlio2_tpu.config as jcfg
import better_fastlio2_tpu.map.voxel_hash as jvh
import better_fastlio2_tpu.pipeline.lio as jlio
from better_fastlio2_tpu.ops.downsample import voxel_downsample as j_ds
import better_fastlio2_tpu_torch.config as tcfg
import better_fastlio2_tpu_torch.map.voxel_hash as tvh
from better_fastlio2_tpu_torch.ops.downsample import voxel_downsample as t_ds
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from test_torch_pipeline import _args, _groups, slice_cfg
from torch_threads import one_torch_thread  # noqa: F401

DT = {"f64": (jnp.float64, torch.float64, np.float64),
      "f32": (jnp.float32, torch.float32, np.float32)}


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_tables_equal(mt, mj):
    for f in ("key", "count", "points", "dense", "mom", "dmom"):
        a, b = getattr(mt, f), getattr(mj, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)


def _copy_j(m):
    return jax.tree_util.tree_map(jnp.copy, m)


def _to_port(mj):
    """The port's map holding a JAX map's tables (copies)."""
    return tvh.VoxelHashMap(**{f: None if getattr(mj, f) is None
                               else _t(getattr(mj, f))
                               for f in tvh.VoxelHashMap._fields})


def _cropped_pair(dt, dense_log2=(5, 5, 4), moments=True, seed=0):
    """One cropped map in both packages: raw inserts (several points a
    voxel, full buckets) and a box crop that leaves tombstones, made by
    the JAX package (the port's inserts are held to it in
    tests/test_torch_map.py) and copied into the port."""
    jd, _, nd = DT[dt]
    rng = np.random.default_rng(seed)
    mj = jvh.make_map(capacity_log2=13, bucket=4, voxel_size=1.0, dtype=jd,
                      dense_log2=dense_log2, moments=moments)
    for _ in range(2):
        pts = rng.uniform(-12, 12, size=(1500, 3)).astype(nd)
        ok = rng.uniform(size=1500) > 0.1
        mj = jvh.insert(mj, jnp.asarray(pts), jnp.asarray(ok))
    lo, hi = np.array([-5.0, -6.0, -7.0], nd), np.array([6.0, 5.0, 4.0], nd)
    mj = jvh.crop_outside_box(mj, jnp.asarray(lo), jnp.asarray(hi))
    mt = _to_port(mj)
    assert float(tvh.tombstone_fraction(mt)) > 0.05
    np.testing.assert_array_equal(tvh.tombstone_fraction(mt).numpy(),
                                  np.asarray(jvh.tombstone_fraction(mj)))
    return mj, mt


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("center", [None, (0.5, -0.5, 0.25)])
@pytest.mark.parametrize("dense_log2", [None, (5, 5, 4)])
def test_rebuild_bit_exact(dt, center, dense_log2):
    mj, mt = _cropped_pair(dt, dense_log2)
    if dense_log2 is not None:
        dm = np.random.default_rng(5).normal(size=(32 * 32 * 16, tvh.DMOM_CH))
        mj = mj._replace(dmom=jnp.asarray(dm.astype(DT[dt][2])))
        mt = mt._replace(dmom=_t(dm.astype(DT[dt][2])))
    cj = None if center is None else jnp.asarray(center)
    ct = None if center is None else torch.as_tensor(center)
    rj = jvh.rebuild(_copy_j(mj), max_probe=8, center=cj)
    rt = tvh.rebuild(mt, max_probe=8, center=ct)
    _assert_tables_equal(rt, rj)
    assert float(tvh.tombstone_fraction(rt)) == 0.0
    assert int(tvh.num_voxels(rt)) == int(tvh.num_voxels(mt))
    if dense_log2 is not None:
        assert rt.dmom is mt.dmom  # carried as it is


def test_claim_only_insert_bit_exact():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-8, 8, size=(2000, 3))
    ds, ok = j_ds(jnp.asarray(pts), jnp.ones(2000, bool), 0.5, out_size=2048)
    kw = dict(capacity_log2=13, bucket=4, voxel_size=0.5,
              dense_log2=(5, 5, 4), moments=True)
    mj = jvh.make_map(dtype=jnp.float64, **kw)
    mt = tvh.make_map(dtype=torch.float64, **kw)
    mj = jvh.insert(mj, ds, ok, max_probe=8, pre_grouped=True,
                    claim_only=True)
    mt = tvh.insert(mt, _t(ds), _t(ok), max_probe=8, pre_grouped=True,
                    claim_only=True)
    _assert_tables_equal(mt, mj)
    # only keys and dense rows: no points, no counts, no moments
    assert int(tvh.num_voxels(mt)) == int(np.asarray(ok).sum())
    assert int(mt.count.sum()) == 0 and float(mt.mom.abs().sum()) == 0.0
    assert bool((mt.points == 1e9).all())


@pytest.mark.parametrize("chunk", [32768, 128])
def test_knn_sortjoin_matches_jax(chunk):
    mj, mt = _cropped_pair("f64", dense_log2=None, moments=False, seed=3)
    q = np.random.default_rng(4).uniform(-10, 10, size=(300, 3))
    pj, dj, oj = jvh.knn_sortjoin(mj, jnp.asarray(q), k=5, chunk=chunk)
    pt, d_t, ot = tvh.knn_sortjoin(mt, _t(q), k=5, chunk=chunk)
    # the same neighbours (slots found by the join, bit for bit); their
    # squared distances are f64 sums in another order (1e-12)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(dj), rtol=0,
                               atol=1e-12)


# ---- behavioural assertions of the JAX tests, on the port ----------------

def test_crop_and_rebuild(rng):
    """tests/test_voxel_map.py:63."""
    pts = rng.uniform(-10, 10, size=(1000, 3))
    m = tvh.make_map(capacity_log2=13, bucket=4, voxel_size=1.0,
                     dtype=torch.float64)
    m = tvh.insert(m, _t(pts), torch.ones(1000, dtype=torch.bool))
    m2 = tvh.crop_outside_box(m, _t([-5.0, -5, -5]), _t([5.0, 5, 5]))
    inside = pts[np.all((pts >= -4) & (pts < 4), axis=1)][:32]
    _, d2, ok = tvh.knn(m2, _t(inside), k=1)
    assert ok.all()
    np.testing.assert_allclose(d2[:, 0].numpy(), 0.0, atol=1e-12)
    m3 = tvh.rebuild(m2)
    assert float(tvh.tombstone_fraction(m3)) == 0.0
    _, d2r, okr = tvh.knn(m3, _t(inside), k=1)
    assert okr.all()
    np.testing.assert_allclose(d2r[:, 0].numpy(), 0.0, atol=1e-12)


def test_knn_sortjoin_matches_probe_knn(rng):
    """tests/test_voxel_map.py:120."""
    pts = rng.uniform(-10, 10, size=(3000, 3))
    m = tvh.make_map(capacity_log2=14, bucket=8, voxel_size=1.0,
                     dtype=torch.float64)
    m = tvh.insert(m, _t(pts), torch.ones(3000, dtype=torch.bool))
    q = _t(rng.uniform(-8, 8, size=(500, 3)))
    _, d1, ok1 = tvh.knn(m, q, k=5)
    _, d2, ok2 = tvh.knn_sortjoin(m, q, k=5)
    np.testing.assert_array_equal(ok1.numpy(), ok2.numpy())
    np.testing.assert_allclose(np.sort(d1.numpy(), 1), np.sort(d2.numpy(), 1),
                               atol=1e-12)


def test_knn_sortjoin_respects_crop(rng):
    """tests/test_voxel_map.py:135."""
    pts = rng.uniform(-10, 10, size=(2000, 3))
    m = tvh.make_map(capacity_log2=13, bucket=4, voxel_size=1.0,
                     dtype=torch.float64)
    m = tvh.insert(m, _t(pts), torch.ones(2000, dtype=torch.bool))
    m = tvh.crop_outside_box(m, _t([-5.0, -5, -5]), _t([5.0, 5, 5]))
    outside = pts[np.any((pts < -7) | (pts > 7), axis=1)][:64]
    _, d2, _ = tvh.knn_sortjoin(m, _t(outside), k=1)
    assert not np.any(d2[:, 0].numpy() < 1e-9)


def test_rebuild_keeps_dense_index(rng):
    """The rebuild step of tests/test_voxel_map.py:181: a rebuilt
    dense-index map keeps its index, and kNN through it equals the
    probing kNN of the same live set."""
    pts = rng.uniform(-10, 10, size=(3000, 3))
    kw = dict(capacity_log2=13, bucket=4, voxel_size=1.0,
              dtype=torch.float64)
    md = tvh.make_map(dense_log2=(5, 5, 5), **kw)
    mp = tvh.make_map(**kw)
    ones = torch.ones(3000, dtype=torch.bool)
    md, mp = tvh.insert(md, _t(pts), ones), tvh.insert(mp, _t(pts), ones)
    lo, hi = _t([-5.0, -5, -5]), _t([5.0, 5, 5])
    md, mp = tvh.crop_outside_box(md, lo, hi), tvh.crop_outside_box(mp, lo, hi)
    q = _t(rng.uniform(-8, 8, size=(300, 3)))
    _, d1, ok1 = tvh.knn(mp, q, k=5)
    md = tvh.rebuild(md)
    assert md.dense is not None
    _, d3, ok3 = tvh.knn(md, q, k=5)
    np.testing.assert_array_equal(ok1.numpy(), ok3.numpy())
    np.testing.assert_allclose(np.sort(d1.numpy(), 1), np.sort(d3.numpy(), 1),
                               atol=1e-12)


def test_crop_and_rebuild_preserve_moments_only_voxels(rng):
    """tests/test_voxel_map.py:322."""
    kw = dict(capacity_log2=14, bucket=4, voxel_size=0.5,
              dtype=torch.float32, dense_log2=(7, 7, 6), moments=True)
    seed = rng.uniform(-5, 5, size=(800, 3)).astype(np.float32)
    ones = torch.ones(800, dtype=torch.bool)
    sd, sdv = t_ds(_t(seed), ones, 0.5, out_size=1024)
    m = tvh.insert(tvh.make_map(**kw), sd, sdv, pre_grouped=True)
    n_seed = int(tvh.num_voxels(m))
    mo = rng.uniform(6, 12, size=(800, 3)).astype(np.float32)
    md, mdv = t_ds(_t(mo), ones, 0.5, out_size=1024)
    n_mo = int(mdv.sum())
    m = tvh.insert(m, md, mdv, pre_grouped=True, moments_only=True)
    assert int(tvh.num_voxels(m)) == n_seed + n_mo
    mc = tvh.crop_outside_box(m, _t([-20.0] * 3), _t([20.0] * 3))
    assert int(tvh.num_voxels(mc)) == n_seed + n_mo
    mc2 = tvh.crop_outside_box(m, _t([5.75] * 3), _t([20.0] * 3))
    assert int(tvh.num_voxels(mc2)) == n_mo
    mr = tvh.rebuild(m, center=torch.zeros(3))
    assert int(tvh.num_voxels(mr)) == n_seed + n_mo
    assert float(mr.mom[:, 0].sum()) == float(m.mom[:, 0].sum())


def test_rebuild_carries_full_moments(rng):
    """The rebuild half of tests/test_plane_cache.py:94: bucket 2 stores
    fewer points than were accumulated, and the rebuild carries the
    whole accumulation."""
    pts = rng.uniform(-4, 4, size=(2000, 3)).astype(np.float32)
    m = tvh.make_map(capacity_log2=12, bucket=2, voxel_size=0.5,
                     dtype=torch.float32, moments=True)
    m = tvh.insert(m, _t(pts), torch.ones(2000, dtype=torch.bool))
    assert float(m.mom[:, 0].sum()) == len(pts)
    mc = tvh.crop_outside_box(m, _t([-1.0] * 3), _t([1.0] * 3))
    live = (mc.key & (1 << 30)) != 0
    assert bool((mc.mom[~live] == 0).all())
    mr = tvh.rebuild(mc)
    np.testing.assert_allclose(float(mr.mom[:, 0].sum()),
                               float(mc.mom[:, 0].sum()))


def test_rebuild_carries_dense_moment_table(rng):
    """tests/test_mom_dense.py:336."""
    m = tvh.make_map(capacity_log2=14, bucket=4, voxel_size=0.5,
                     dtype=torch.float32, dense_log2=(5, 5, 5), moments=True)
    pts = rng.uniform(-20, 20, size=(800, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-10, 10, size=800)
    m = tvh.insert(m, _t(pts), torch.ones(800, dtype=torch.bool))
    dmom = tvh.build_dense_moments(m, center=np.zeros(3))
    m = m._replace(dmom=dmom)
    mr = tvh.rebuild(m, center=np.zeros(3))
    assert mr.dmom is not None
    np.testing.assert_array_equal(mr.dmom.numpy(), dmom.numpy())


# ---- the recontruct_kdtree pipeline ---------------------------------------

def _rebuild_cfg(mod):
    cfg = slice_cfg(mod)
    cfg.shapes.map_capacity_log2 = 15
    cfg.mapping.det_range, cfg.mapping.cube_len = 6.0, 20.0
    cfg.ikdtree.recontruct_kdtree, cfg.ikdtree.kd_step = True, 2
    return cfg


def test_rebuild_pipeline_matches_jax(monkeypatch):
    calls = {"jax": [], "port": []}
    j_rebuild, t_rebuild = jvh.rebuild, tvh.rebuild

    def spy(which, fn):
        def f(m, *a, **kw):
            out = fn(m, *a, **kw)
            calls[which].append(float(np.asarray(out.key == -2 ** 31).mean()))
            return out
        return f

    monkeypatch.setattr(jvh, "rebuild", spy("jax", j_rebuild))
    monkeypatch.setattr(tvh, "rebuild", spy("port", t_rebuild))
    groups = _groups()[:14]
    jp = jlio.LIOPipeline(_rebuild_cfg(jcfg))
    tp = LIOPipeline(_rebuild_cfg(tcfg), device="cpu")
    for k, g in enumerate(groups):
        oj, ot = jp.process_scan(*_args(g)), tp.process_scan(*_args(g))
        assert (oj is None) == (ot is None)
        if ot is not None:
            np.testing.assert_allclose(ot["pos"], oj["pos"], rtol=0,
                                       atol=1e-6, err_msg=f"scan {k}")
        assert len(calls["jax"]) == len(calls["port"]), k
    # the rebuild fired and left no tombstone
    assert len(calls["port"]) >= 1 and max(calls["port"]) == 0.0
