"""Port parity: ops/scancontext.py against the JAX package, f64 on the CPU.

* Descriptors exactly equal to the JAX package's (the same bins, the same
  maxima), on random scans with points past max_radius, on the axes and
  masked out; ring and sector keys (means) to 1e-12.
* All-shift distances to 1e-12 and the same argmin shift; the batched
  distance, the database appends (past capacity too) and the loop
  retrieval give the JAX package's candidate, distance and shift.
* The behavioural assertions of tests/test_scancontext.py on the port:
  the numpy transcription of makeScancontext, distDirectSC at every shift,
  rotation equivariance, retrieval of a revisit, exclusion of recent
  entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.ops import scancontext as jsc
from better_fastlio2_tpu_torch import convert
from better_fastlio2_tpu_torch.ops import scancontext as tsc
from test_scancontext import np_dist_direct, np_make_descriptor, rand_scan
from torch_threads import one_torch_thread  # noqa: F401

P = tsc.SCParams()


def _desc_pair(pts, valid=None):
    valid = np.ones(len(pts), bool) if valid is None else valid
    dj = jsc.make_descriptor(jnp.asarray(pts), jnp.asarray(valid))
    dt = tsc.make_descriptor(torch.as_tensor(pts), torch.as_tensor(valid))
    return dt, dj


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_descriptor_exact(seed):
    rng = np.random.default_rng(seed)
    pts = rand_scan(rng, 3000)
    pts[:100, :2] *= 1.3  # past max_radius
    pts[100:110, 1] = 0.0  # on the sector boundary at 0 degrees
    pts[110:120, 0] = 0.0
    valid = rng.uniform(size=len(pts)) > 0.05
    dt, dj = _desc_pair(pts, valid)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # the keys are means: f64 sums in another order
    np.testing.assert_allclose(tsc.ring_key(dt).numpy(),
                               np.asarray(jsc.ring_key(dj)), atol=1e-12)
    np.testing.assert_allclose(tsc.sector_key(dt).numpy(),
                               np.asarray(jsc.sector_key(dj)), atol=1e-12)


def test_distances_match_jax():
    rng = np.random.default_rng(3)
    (t1, j1), (t2, j2) = (_desc_pair(rand_scan(rng)) for _ in range(2))
    np.testing.assert_allclose(tsc._all_shift_cosine(t1, t2).numpy(),
                               np.asarray(jsc._all_shift_cosine(j1, j2)),
                               rtol=0, atol=1e-12)
    dt, st = tsc.sc_distance(t1, t2)
    dj, sj = jsc.sc_distance(j1, j2)
    np.testing.assert_allclose(float(dt), float(dj), atol=1e-12)
    assert int(st) == int(sj)
    cands = [_desc_pair(rand_scan(rng)) for _ in range(4)]
    bt = tsc.sc_distance_batch(t1, torch.stack([c[0] for c in cands]))
    bj = jsc.sc_distance_batch(j1, jnp.stack([c[1] for c in cands]))
    np.testing.assert_allclose(bt[0].numpy(), np.asarray(bj[0]), atol=1e-12)
    np.testing.assert_array_equal(bt[1].numpy(), np.asarray(bj[1]))


def test_database_and_detect_loop_match_jax():
    rng = np.random.default_rng(4)
    scans = [rand_scan(rng, 1500) for _ in range(40)]
    dbt = tsc.make_database(36, P, dtype=torch.float64)  # fills up
    dbj = jsc.make_database(36, P, dtype=jnp.float64)
    for s in scans:
        dt, dj = _desc_pair(s)
        dbt, dbj = tsc.add_descriptor(dbt, dt), jsc.add_descriptor(dbj, dj)
    got = convert.tuple_to_numpy(dbt)
    np.testing.assert_array_equal(got["descs"], np.asarray(dbj.descs))
    np.testing.assert_allclose(got["rkeys"], np.asarray(dbj.rkeys),
                               atol=1e-12)
    assert int(dbt.count) == 36
    # a JAX database carried over gives the same retrieval
    dbc = convert.sc_database_from_numpy(
        {k: np.asarray(v) for k, v in zip(dbj._fields, dbj)})
    for k in (3, 20):
        noisy = scans[k] + rng.normal(scale=0.02, size=scans[k].shape)
        qt, qj = _desc_pair(noisy)
        it, d_t, st = tsc.detect_loop(dbc, qt, P)
        ij, d_j, sj = jsc.detect_loop(dbj, qj, P)
        assert int(it) == int(ij) and int(st) == int(sj)
        np.testing.assert_allclose(float(d_t), float(d_j), atol=1e-12)


# ---- behavioural assertions of tests/test_scancontext.py -----------------

def _desc(pts):
    return tsc.make_descriptor(torch.as_tensor(pts),
                               torch.ones(len(pts), dtype=torch.bool))


def test_descriptor_matches_reference_transcription(rng):
    pts = rand_scan(rng)
    np.testing.assert_allclose(_desc(pts).numpy(), np_make_descriptor(pts),
                               atol=1e-9)


def test_distance_matches_reference_at_every_shift(rng):
    d1 = np_make_descriptor(rand_scan(rng))
    d2 = np_make_descriptor(rand_scan(rng))
    got = tsc._all_shift_cosine(torch.as_tensor(d1), torch.as_tensor(d2))
    for s in range(P.num_sector):
        np.testing.assert_allclose(float(got[s]),
                                   np_dist_direct(d1, np.roll(d2, s, axis=1)),
                                   atol=1e-9)


def test_rotation_equivariance(rng):
    pts = rand_scan(rng)
    k = 17
    ang = k * 2 * np.pi / P.num_sector
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    d1, d2 = _desc(pts), _desc(pts @ R.T)
    np.testing.assert_allclose(tsc.ring_key(d1).numpy(),
                               tsc.ring_key(d2).numpy(), atol=1e-9)
    dist, shift = tsc.sc_distance(d1, d2)
    assert float(dist) < 1e-6
    assert int(shift) == (P.num_sector - k) % P.num_sector


def test_detect_loop_on_revisit(rng):
    db = tsc.make_database(128, P, dtype=torch.float64)
    scans = [rand_scan(rng) for _ in range(40)]
    for s2 in scans:
        db = tsc.add_descriptor(db, _desc(s2))
    noisy = scans[3] + rng.normal(scale=0.02, size=scans[3].shape)
    idx, dist, _ = tsc.detect_loop(db, _desc(noisy), P)
    assert int(idx) == 3
    assert float(dist) < P.dist_thresh


def test_detect_loop_excludes_recent(rng):
    db = tsc.make_database(64, P, dtype=torch.float64)
    scans = [rand_scan(rng) for _ in range(10)]  # < num_exclude_recent
    for s2 in scans:
        db = tsc.add_descriptor(db, _desc(s2))
    idx, _, _ = tsc.detect_loop(db, _desc(scans[0]), P)
    assert int(idx) == -1
