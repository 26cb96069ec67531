"""Port parity: voxel downsample and the voxel-hash map.

Seeded numpy inputs through the JAX reference and the PyTorch port on the
CPU.  Exact where the reference is exact: the downsample's surviving set
and order (including truncation past out_size and drop_high_z), the hash,
and the map tables after inserts, pre-grouped and grouped (key/count/
points/dense bit for bit, negative coordinates, same-voxel duplicates and
full buckets included).  kNN distances
in f64 to 1e-9; a neighbour-set mismatch would come from a distance tie,
which these continuous inputs do not produce.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.map import voxel_hash as jvh
from better_fastlio2_tpu.ops.downsample import voxel_downsample as j_ds
from better_fastlio2_tpu.utils import so3 as jso3
from better_fastlio2_tpu_torch.map import voxel_hash as tvh
from better_fastlio2_tpu_torch.ops.downsample import voxel_downsample as t_ds
from torch_threads import one_torch_thread  # noqa: F401


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a, dtype=dtype))


def _scan(rng, n, spread=25.0):
    pts = rng.normal(size=(n, 3)) * spread
    pts[:, 2] *= 0.3
    return pts


@pytest.mark.parametrize("packed_key,drop_high_z,out_size", [
    (False, False, None),
    (True, False, None),
    (True, True, None),
    (True, False, 700),   # truncation: occupied voxels exceed out_size
    (True, True, 700),
    (False, False, 700),
])
def test_voxel_downsample_matches_jax(packed_key, drop_high_z, out_size):
    rng = np.random.default_rng(0)
    pts = _scan(rng, 3000, spread=6.0)
    valid = rng.uniform(size=3000) > 0.1
    oj, vj = j_ds(jnp.asarray(pts), jnp.asarray(valid), 0.5,
                  out_size=out_size, packed_key=packed_key,
                  drop_high_z=drop_high_z)
    ot, vt = t_ds(_t(pts), _t(valid), 0.5, out_size=out_size,
                  packed_key=packed_key, drop_high_z=drop_high_z)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    if out_size is not None:
        assert vt.all()  # truncated: every output row is occupied
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=1e-12)


def test_hash_and_pack_bit_exact():
    rng = np.random.default_rng(1)
    ijk = rng.integers(-2 ** 20, 2 ** 20, size=(4096, 3)).astype(np.int32)
    ijk[:16] = [2147483647, 2147483647, 2147483647]  # invalid-row fill
    ijk[16:32] = -rng.integers(0, 5, size=(16, 3))
    for mask in (2 ** 16 - 1, 2 ** 20 - 1):
        np.testing.assert_array_equal(
            tvh._hash(_t(ijk), mask).numpy(),
            np.asarray(jvh._hash(jnp.asarray(ijk), mask)))
    np.testing.assert_array_equal(tvh._pack(_t(ijk)).numpy(),
                                  np.asarray(jvh._pack(jnp.asarray(ijk))))


def _maps(dense_log2, capacity_log2=12, bucket=4, vs=0.5):
    mj = jvh.make_map(capacity_log2=capacity_log2, bucket=bucket,
                      voxel_size=vs, dtype=jnp.float64,
                      dense_log2=dense_log2)
    mt = tvh.make_map(capacity_log2=capacity_log2, bucket=bucket,
                      voxel_size=vs, dtype=torch.float64,
                      dense_log2=dense_log2)
    return mj, mt


def _assert_maps_equal(mt, mj):
    np.testing.assert_array_equal(mt.key.numpy(), np.asarray(mj.key))
    np.testing.assert_array_equal(mt.count.numpy(), np.asarray(mj.count))
    np.testing.assert_array_equal(mt.points.numpy(), np.asarray(mj.points))
    if mj.dense is None:
        assert mt.dense is None
    else:
        np.testing.assert_array_equal(mt.dense.numpy(), np.asarray(mj.dense))


def _grouped_batches(rng, n_batches, n_pts=1500, vs=0.5):
    """Downsampled scans at the map leaf, rotated into the world: one row
    per body voxel, so some world voxels get two rows (the duplicates the
    reference's in-order scatter resolves last-wins)."""
    out = []
    for b in range(n_batches):
        body = _scan(rng, n_pts, spread=4.0)
        ds, ok = j_ds(jnp.asarray(body), jnp.ones(n_pts, bool), vs,
                      out_size=1024, packed_key=True)
        q = jso3.quat_normalize(jnp.asarray(rng.normal(size=4)))
        world = jso3.quat_rotate(q, ds) + jnp.asarray(
            rng.normal(size=3) * 2 - [1.0, 1.0, 1.0])
        out.append((np.asarray(world), np.asarray(ok)))
    return out


@pytest.mark.parametrize("dense_log2", [None, (5, 5, 4)])
def test_insert_bit_exact(dense_log2):
    rng = np.random.default_rng(2)
    mj, mt = _maps(dense_log2)
    batches = _grouped_batches(rng, 4)
    n_dup = 0
    for world, ok in batches:
        ijk = np.floor(world[ok] / 0.5)
        n_dup += len(ijk) - len(np.unique(ijk, axis=0))
        mj = jvh.insert(mj, jnp.asarray(world), jnp.asarray(ok),
                        max_probe=8, pre_grouped=True)
        mt = tvh.insert(mt, _t(world), _t(ok), max_probe=8, pre_grouped=True)
        _assert_maps_equal(mt, mj)
    assert n_dup > 0  # the duplicate-row case was exercised
    assert (np.asarray(mj.count) == 4).any()  # full buckets were hit
    assert int(tvh.num_voxels(mt)) == int(jvh.num_voxels(mj))


@pytest.mark.parametrize("dense_log2", [None, (5, 5, 4)])
def test_grouped_insert_bit_exact(dense_log2):
    """The sorting insert (pre_grouped=False) on raw points: many rows per
    voxel in every batch, invalid rows among them, buckets filling up and
    overflowing; the tables stay bit-exact with JAX's."""
    rng = np.random.default_rng(4)
    mj, mt = _maps(dense_log2)
    n_rep = 0
    for _ in range(4):
        pts = _scan(rng, 1500, spread=2.5)
        ok = rng.uniform(size=1500) > 0.1
        ijk = np.floor(pts[ok] / 0.5)
        n_rep += len(ijk) - len(np.unique(ijk, axis=0))
        mj = jvh.insert(mj, jnp.asarray(pts), jnp.asarray(ok), max_probe=8)
        mt = tvh.insert(mt, _t(pts), _t(ok), max_probe=8)
        _assert_maps_equal(mt, mj)
    assert n_rep > 1000  # most rows share a voxel with another row
    assert (np.asarray(mj.count) == 4).any()  # full buckets were hit
    assert int(tvh.num_voxels(mt)) == int(jvh.num_voxels(mj))


def test_lexsort_matches_numpy():
    """The grouped insert's sort: last key primary, ties in input order."""
    rng = np.random.default_rng(5)
    keys = [rng.integers(0, 4, size=500).astype(np.int64) for _ in range(3)]
    keys.append(np.where(rng.uniform(size=500) > 0.2,
                         rng.integers(0, 6, size=500), 2147483647))
    np.testing.assert_array_equal(
        tvh._lexsort([torch.as_tensor(k) for k in keys]).numpy(),
        np.lexsort(keys))


def _filled_maps(dense_log2, seed=3):
    rng = np.random.default_rng(seed)
    mj, mt = _maps(dense_log2)
    for world, ok in _grouped_batches(rng, 5):
        mj = jvh.insert(mj, jnp.asarray(world), jnp.asarray(ok),
                        max_probe=8, pre_grouped=True)
        mt = tvh.insert(mt, _t(world), _t(ok), max_probe=8, pre_grouped=True)
    return mj, mt, rng


@pytest.mark.parametrize("dense_log2,max_live", [
    (None, 0), (None, 12), ((5, 5, 4), 0), ((5, 5, 4), 12)])
def test_knn_matches_jax(dense_log2, max_live):
    mj, mt, rng = _filled_maps(dense_log2)
    q = _scan(rng, 600, spread=4.0)
    nj, dj, okj = jvh.knn(mj, jnp.asarray(q), k=5, max_probe=8,
                          max_live=max_live, chunk=256)
    nt, dt, okt = tvh.knn(mt, _t(q), k=5, max_probe=8, max_live=max_live,
                          chunk=256)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    assert ok.all(axis=1).mean() > 0.3  # most queries found 5 neighbours
    np.testing.assert_allclose(dt.numpy()[ok], np.asarray(dj)[ok],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(nt.numpy()[ok], np.asarray(nj)[ok],
                               rtol=1e-9, atol=1e-9)


def test_lookup_slots_matches_jax():
    mj, mt, rng = _filled_maps(None)
    ijk = np.floor(_scan(rng, 2000, spread=4.0) / 0.5).astype(np.int32)
    np.testing.assert_array_equal(
        tvh._lookup_slots(mt.key, _t(ijk), 8).numpy(),
        np.asarray(jvh._lookup_slots(mj.key, jnp.asarray(ijk), 8)))


@pytest.mark.parametrize("enabled", [True, False])
def test_crop_outside_box_matches_jax(enabled):
    mj, mt, _ = _filled_maps((5, 5, 4))
    lo, hi = np.array([-3.0, -2.5, -1.0]), np.array([2.0, 3.5, 1.5])
    cj = jvh.crop_outside_box(mj, jnp.asarray(lo), jnp.asarray(hi),
                              enabled=jnp.asarray(enabled))
    ct = tvh.crop_outside_box(mt, _t(lo), _t(hi), enabled=_t(enabled))
    _assert_maps_equal(ct, cj)
    if enabled:
        assert int(tvh.num_voxels(ct)) < int(tvh.num_voxels(mt))
    # a crop followed by an insert: tombstones keep chains, stale dense rows
    # re-verify liveness
    rng = np.random.default_rng(9)
    world, ok = _grouped_batches(rng, 1)[0]
    cj = jvh.insert(cj, jnp.asarray(world), jnp.asarray(ok), max_probe=8,
                    pre_grouped=True)
    ct = tvh.insert(ct, _t(world), _t(ok), max_probe=8, pre_grouped=True)
    _assert_maps_equal(ct, cj)


def test_make_map_matches_jax():
    mj, mt = _maps((4, 4, 3), capacity_log2=8, bucket=3, vs=0.4)
    _assert_maps_equal(mt, mj)
    assert float(mt.voxel_size) == float(mj.voxel_size)
