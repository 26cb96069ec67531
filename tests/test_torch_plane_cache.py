"""Port parity for the plane cache and the dense moment table (slice 3).

Seeded numpy inputs through the JAX reference and the PyTorch port on the
CPU, in f64 unless stated:

* `voxel_hash.insert` with moments — the full scatter with the mom_cap
  rescale and the freeze-at-cap compacted scatter, duplicate world voxels
  in the batches — and with the claim and dense budgets (overflowing):
  key, count, points and dense bit-exact, mom within 1e-12.
* `_alias_tag` on negative coordinates: exact.
* `build_dense_moments` and five batches of `insert_dense_moments` (a
  budget that overflows, an alias overwrite, duplicate replace rows):
  tables within 1e-12, n_new exact.
* `_accumulate_rebased` (the port's `_rebase` plus the running sum),
  `neighborhood_moment_sums` (face7 on the dense-table path and on the
  slot path through the dense index and through the probe; tangent5 and
  octant4 on the dense table) within 1e-12; `plane_from_moments` on planar
  data: the same plane_ok, normals and offsets within 1e-9.
* The fused measure with solve_compact at a budget that compacts and at
  one that falls back (tests/test_fused_solve.py:189,216): the same n_eff
  and G within 1e-12 of the full-width result, and, compacted, the JAX
  package's state within 1e-9.

Then the JAX package's behavioural tests of these modules, on the port
(tests/test_plane_cache.py:31-114 in f32 at their tolerances, without
the rebuild half of :94, which waits for the map rebuild;
tests/test_mom_dense.py:42, 68, 100, 139, 202, 214 and 320).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import better_fastlio2_tpu.config as jcfg
from better_fastlio2_tpu.core import esikf as jesikf
from better_fastlio2_tpu.core import measurement as jm
from better_fastlio2_tpu.core.state import identity_state as j_identity
from better_fastlio2_tpu.map import voxel_hash as jvh
from better_fastlio2_tpu.ops.downsample import voxel_downsample as j_ds
from better_fastlio2_tpu.utils import so3 as jso3
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.core import esikf as tesikf
from better_fastlio2_tpu_torch.core import measurement as tm
from better_fastlio2_tpu_torch.core.state import State
from better_fastlio2_tpu_torch.map import voxel_hash as tvh
from better_fastlio2_tpu_torch.ops import kernels as tk
from better_fastlio2_tpu_torch.pipeline.lio import make_step_fn
from better_fastlio2_tpu_torch.utils.device import nonzero_static
from torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a, dtype=dtype))


def _maps(dense_log2=(5, 5, 4), capacity_log2=12, bucket=4, vs=0.5):
    mj = jvh.make_map(capacity_log2=capacity_log2, bucket=bucket,
                      voxel_size=vs, dtype=jnp.float64,
                      dense_log2=dense_log2, moments=True)
    mt = tvh.make_map(capacity_log2=capacity_log2, bucket=bucket,
                      voxel_size=vs, dtype=F64, dense_log2=dense_log2,
                      moments=True)
    return mj, mt


def _assert_maps_equal(mt, mj, mom_tol=1e-12):
    for f in ("key", "count", "points", "dense"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(mj, f)), err_msg=f)
    np.testing.assert_allclose(mt.mom.numpy(), np.asarray(mj.mom), rtol=0,
                               atol=mom_tol)


def _grouped_batches(rng, n_batches, n_pts=1500, vs=0.5, spread=4.0):
    """Downsampled scans at the map leaf, rotated into the world: one row
    per body voxel, so some world voxels get two rows."""
    out = []
    for _ in range(n_batches):
        body = rng.normal(size=(n_pts, 3)) * spread
        body[:, 2] *= 0.3
        ds, ok = j_ds(jnp.asarray(body), jnp.ones(n_pts, bool), vs,
                      out_size=1024, packed_key=True)
        q = jso3.quat_normalize(jnp.asarray(rng.normal(size=4)))
        world = jso3.quat_rotate(q, ds) + jnp.asarray(
            rng.normal(size=3) * 2 - [1.0, 1.0, 1.0])
        out.append((np.asarray(world), np.asarray(ok)))
    return out


def _n_dup(world, ok, vs=0.5):
    ijk = np.floor(world[ok] / vs)
    return len(ijk) - len(np.unique(ijk, axis=0))


def test_nonzero_static_matches_jnp():
    rng = np.random.default_rng(0)
    for p in (0.0, 0.05, 0.5, 1.0):
        mask = rng.uniform(size=300) < p
        for size in (1, 17, 300, 400):
            np.testing.assert_array_equal(
                nonzero_static(_t(mask), size, 300).numpy(),
                np.asarray(jnp.nonzero(jnp.asarray(mask), size=size,
                                       fill_value=300)[0]))


@pytest.mark.parametrize("path", ["rescale", "freeze"])
def test_insert_moments_match_jax(path):
    """The warmup program's moment insert (grouped, full scatter, then
    the mom_cap rescale) and the steady one (pre-grouped, moments only,
    freeze-at-cap under a budget that overflows)."""
    rng = np.random.default_rng(1)
    mj, mt = _maps()
    n_dup = 0
    for k, (world, ok) in enumerate(_grouped_batches(rng, 5)):
        n_dup += _n_dup(world, ok)
        if path == "rescale":
            kw = dict(mom_cap=3)
        else:
            kw = dict(pre_grouped=True, mom_cap=3, mom_budget=300,
                      moments_only=k >= 2)
        mj = jvh.insert(mj, jnp.asarray(world), jnp.asarray(ok),
                        max_probe=8, **kw)
        mt = tvh.insert(mt, _t(world), _t(ok), max_probe=8, **kw)
        _assert_maps_equal(mt, mj)
    assert n_dup > 0  # duplicate world voxels were in the batches
    n = mt.mom[:, 0]
    if path == "rescale":
        assert float(n.max()) <= 3.0 + 1e-12 and float(n.max()) > 2.0
    else:
        assert int((n == 3).sum()) > 0  # rows froze at the cap
    assert int(tvh.num_voxels(mt)) == int(jvh.num_voxels(mj))


@pytest.mark.parametrize("budgets", [
    dict(claim_budget=48),
    dict(dense_budget=48),
    dict(claim_budget=48, dense_budget=48, moments_only=True, mom_cap=4,
         mom_budget=200),
])
def test_insert_budgets_match_jax(budgets):
    """Budgets below the dense misses of a batch: the overflow rows stay
    unclaimed (claim) or dense misses (dense) and retry next batch."""
    rng = np.random.default_rng(2)
    mj, mt = _maps()
    # a first batch through the uncapped insert, as the warmup does
    world, ok = _grouped_batches(rng, 1)[0]
    mj = jvh.insert(mj, jnp.asarray(world), jnp.asarray(ok), max_probe=8,
                    pre_grouped=True)
    mt = tvh.insert(mt, _t(world), _t(ok), max_probe=8, pre_grouped=True)
    for world, ok in _grouped_batches(rng, 4, spread=6.0):
        mj = jvh.insert(mj, jnp.asarray(world), jnp.asarray(ok),
                        max_probe=8, pre_grouped=True, **budgets)
        mt = tvh.insert(mt, _t(world), _t(ok), max_probe=8,
                        pre_grouped=True, **budgets)
        _assert_maps_equal(mt, mj)
    # the budget bound: some voxels of the last batch are still missing
    ijk = np.floor(world[ok] / 0.5).astype(np.int32)
    slots = tvh._lookup_slots(mt.key, _t(ijk), 8).numpy()
    dense = tvh._dense_lookup(mt.dense, _t(ijk)).numpy()
    assert (slots < 0).any() or (dense < 0).any()


def test_alias_tag_negative_coords():
    rng = np.random.default_rng(3)
    ijk = rng.integers(-3000, 3000, size=(4096, 3)).astype(np.int32)
    ijk[:64] = -rng.integers(1, 9, size=(64, 3))
    for shape in ((32, 32, 32), (256, 256, 128), (128, 64, 16)):
        np.testing.assert_array_equal(
            tvh._alias_tag(shape, _t(ijk)).numpy(),
            np.asarray(jvh._alias_tag(shape, jnp.asarray(ijk))))


def _filled(rng, dense_log2=(5, 5, 4), n_batches=4):
    mj, mt = _maps(dense_log2)
    for world, ok in _grouped_batches(rng, n_batches):
        mj = jvh.insert(mj, jnp.asarray(world), jnp.asarray(ok),
                        max_probe=8, pre_grouped=True, mom_cap=6)
        mt = tvh.insert(mt, _t(world), _t(ok), max_probe=8,
                        pre_grouped=True, mom_cap=6)
    return mj, mt


def test_build_dense_moments_matches_jax():
    rng = np.random.default_rng(4)
    mj, mt = _filled(rng, dense_log2=(4, 4, 3))  # window cuts voxels off
    center = np.array([1.3, -0.7, 0.2])
    dj = jvh.build_dense_moments(mj, center)
    dt = tvh.build_dense_moments(mt, _t(center))
    # the rows are copies: as close as the slot moments (1e-12)
    np.testing.assert_array_equal(dt.numpy() != 0, np.asarray(dj) != 0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=1e-12)
    n_live = int(tvh.num_voxels(mt))
    assert 0 < int((dt[:, 1] > 0).sum()) < n_live  # windowed


def test_insert_dense_moments_matches_jax():
    """Five steady batches into the dense table: a budget that overflows,
    a voxel one torus period from a stored one (alias overwrite), and two
    rows of one world voxel in a stale or new cell (duplicate replace
    rows)."""
    rng = np.random.default_rng(5)
    mj, mt = _filled(rng)
    dshape = mj.dense.shape
    dj = jvh.build_dense_moments(mj, np.zeros(3))
    dt = tvh.build_dense_moments(mt, torch.zeros(3, dtype=F64))
    period = np.array([32, 32, 16]) * 0.5
    stored = np.asarray(jvh._unpack_rel(
        mj.key[(mj.key & (1 << 30)) != 0], jnp.zeros(3, jnp.int32)))
    seen = dict(overflow=0, alias=0, dup_replace=0)
    for k in range(5):
        world, ok = _grouped_batches(rng, 1, spread=6.0)[0]
        world, ok = world.copy(), ok.copy()
        # voxels one torus period (x) away from stored ones
        alias_src = stored[rng.choice(len(stored), 20, replace=False)]
        world[-60:-40] = (alias_src + 0.5) * 0.5 + [period[0], 0, 0]
        ok[-60:-40] = True
        # two rows in one new world voxel (both replace rows)
        far = (rng.integers(100, 120, size=(20, 3)) + 0.25) * 0.5
        world[-40:-20], world[-20:] = far, far + 0.2
        ok[-40:] = True
        hdr = np.asarray(dj)[np.asarray(jvh._dense_linear(
            dshape, jnp.floor(jnp.asarray(world) / 0.5).astype(jnp.int32)))]
        tag = np.asarray(jvh._alias_tag(dshape, jnp.floor(
            jnp.asarray(world) / 0.5).astype(jnp.int32)))
        need = ok & ~((hdr[:, 0] == tag) & (hdr[:, 1] >= 3))
        seen["overflow"] += int(need.sum() > 256)
        seen["alias"] += int(((hdr[-60:-40, 1] > 0)
                              & (hdr[-60:-40, 0] != tag[-60:-40])).sum())
        seen["dup_replace"] += 20
        dj, nj = jvh.insert_dense_moments(dj, dshape, mj.voxel_size,
                                          jnp.asarray(world),
                                          jnp.asarray(ok), 3, 256)
        dt, nt = tvh.insert_dense_moments(dt, dshape, mt.voxel_size,
                                          _t(world), _t(ok), 3, 256)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                                   atol=1e-12)
        assert int(nt) == int(nj)
    assert all(seen.values()), seen
    assert float(dt[:, 1].min()) >= 0.0  # no cell driven negative


def test_rebase_matches_accumulate_rebased():
    rng = np.random.default_rng(6)
    mom = rng.normal(size=(50, 10))
    dj = rng.normal(size=(50, 3))
    sums = rng.normal(size=(50, 10))
    want = jm._accumulate_rebased(jnp.asarray(sums), jnp.asarray(mom),
                                  [jnp.asarray(dj[:, a]) for a in range(3)],
                                  jm._REBASE_IU)
    got = _t(sums) + tm._rebase(_t(mom), _t(dj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def _walls(rng, n=6000, center=(0.0, 0.0, 0.0)):
    """Points on three noisy walls, far from the origin in x."""
    parts = []
    for ax in range(3):
        g = rng.uniform(-3, 3, size=(n // 3, 3))
        g[:, ax] = rng.normal(scale=0.01, size=n // 3) + (1.0 + ax)
        parts.append(g)
    return np.concatenate(parts) + np.asarray(center)


@pytest.mark.parametrize("table,cells", [
    ("dense", "face7"), ("slot_dense_index", "face7"), ("slot_probe", "face7"),
    ("dense", "tangent5"), ("dense", "octant4")])
def test_neighborhood_moment_sums_match_jax(table, cells):
    rng = np.random.default_rng(7)
    pts = _walls(rng, center=(-2.0, 1.0, -1.5))  # negative coordinates too
    mj, mt = _maps(None if table == "slot_probe" else (5, 5, 4))
    mj = jvh.insert(mj, jnp.asarray(pts), jnp.ones(len(pts), bool),
                    max_probe=8)
    mt = tvh.insert(mt, _t(pts), torch.ones(len(pts), dtype=torch.bool),
                    max_probe=8)
    if table == "dense":
        mj = mj._replace(dmom=jvh.build_dense_moments(mj, np.zeros(3)))
        mt = mt._replace(dmom=tvh.build_dense_moments(
            mt, torch.zeros(3, dtype=F64)))
    q = pts[::23] + rng.normal(scale=0.05, size=(len(pts[::23]), 3))
    sj, ij = jm.neighborhood_moment_sums(mj, jnp.asarray(q), max_probe=8,
                                         cells=cells)
    st, it = tm.neighborhood_moment_sums(mt, _t(q), max_probe=8,
                                         cells=cells)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-12,
                               atol=1e-12)
    assert float(st[:, 0].min()) >= 0 and float(st[:, 0].mean()) > 5

    nj, dj, okj = jm.plane_from_moments(mj, jnp.asarray(q),
                                        jnp.ones(len(q), bool), max_probe=8,
                                        cells=cells)
    nt, dt, okt = tm.plane_from_moments(
        mt, _t(q), torch.ones(len(q), dtype=torch.bool), max_probe=8,
        cells=cells)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj.mean() > 0.5
    np.testing.assert_allclose(nt.numpy()[okj], np.asarray(nj)[okj],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(dt.numpy()[okj], np.asarray(dj)[okj],
                               rtol=0, atol=1e-9)


def _toy_problem(seed=0, n=1024):
    """tests/test_fused_solve.py:_toy_problem: points on three walls (for
    a moment map without a dense index) and a scan of them."""
    rng = np.random.default_rng(seed)
    wall = []
    for ax in range(3):
        g = rng.uniform(-4, 4, size=(4000, 3))
        g[:, ax] = rng.normal(scale=0.01, size=4000) + (2.0 + ax)
        wall.append(g)
    map_pts = np.concatenate(wall)
    scan = map_pts[rng.choice(len(map_pts), n)] + rng.normal(
        scale=0.005, size=(n, 3))
    return map_pts, scan


def _jax_update(map_pts, scan, solve_compact):
    m = jvh.make_map(capacity_log2=15, bucket=8, voxel_size=0.5,
                     dtype=jnp.float64, moments=True)
    m = jvh.insert(m, jnp.asarray(map_pts), jnp.ones(len(map_pts), bool))
    x0 = j_identity(jnp.float64)._replace(
        pos=jnp.asarray([0.05, -0.03, 0.02]),
        rot=jso3.quat_normalize(jnp.asarray([1.0, 0.01, -0.01, 0.005])))
    P0 = jnp.eye(jesikf.ERR_DIM) * 1e-2
    measure, aux0 = jm.make_measure_fn(
        m, jnp.asarray(scan), jnp.ones(len(scan), bool),
        single_association=True, plane_cache=True, fused_solve=True,
        solve_compact=solve_compact)
    return jesikf.update_iterated(x0, P0, measure, aux0, max_iter=4,
                                  n_cols=6)


def _torch_update(map_pts, scan, solve_compact):
    m = tvh.make_map(capacity_log2=15, bucket=8, voxel_size=0.5, dtype=F64,
                     moments=True)
    m = tvh.insert(m, _t(map_pts), torch.ones(len(map_pts), dtype=bool))
    x0 = State(*(torch.as_tensor(np.array(a)) for a in j_identity(
        jnp.float64)._replace(
            pos=jnp.asarray([0.05, -0.03, 0.02]),
            rot=jso3.quat_normalize(jnp.asarray([1.0, 0.01, -0.01,
                                                 0.005])))))
    P0 = torch.eye(tesikf.ERR_DIM, dtype=F64) * 1e-2
    widths = []
    real = tm.fused_normal_eqs

    def spy(soa, params):
        widths.append(soa.shape[1])
        return real(soa, params)

    tm.fused_normal_eqs = spy
    try:
        measure, aux0 = tm.make_measure_fn(
            m, _t(scan), torch.ones(len(scan), dtype=bool),
            single_association=True, plane_cache=True, fused_solve=True,
            solve_compact=solve_compact)
        out = tesikf.update_iterated(x0, P0, measure, aux0, max_iter=4,
                                     n_cols=6)
    finally:
        tm.fused_normal_eqs = real
    return out, widths


@pytest.mark.parametrize("budget,expect_compact", [
    (1000, True),   # every live set fits: the compacted buffer
    (64, False),    # live lanes overflow: the full-width fallback
])
def test_solve_compact_update_parity(budget, expect_compact):
    map_pts, scan = _toy_problem()
    (x_f, P_f, _, i_f), w_f = _torch_update(map_pts, scan, 0)
    (x_c, P_c, aux_c, i_c), w_c = _torch_update(map_pts, scan, budget)
    assert aux_c.use_c == expect_compact
    assert set(w_c) == {budget if expect_compact else len(scan)}
    assert set(w_f) == {len(scan)}
    assert int(i_c["n_eff"]) == int(i_f["n_eff"]) > 500
    for a, b in ((x_c.pos, x_f.pos), (x_c.rot, x_f.rot), (P_c, P_f)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    assert float(torch.linalg.vector_norm(x_c.pos)) < 0.02
    if not expect_compact:
        return  # the fallback is the full-width path, held above
    # the JAX package's update at the same budget
    x_j, P_j, _, i_j = _jax_update(map_pts, scan, budget)
    np.testing.assert_allclose(x_c.pos.numpy(), np.asarray(x_j.pos),
                               atol=1e-9)
    np.testing.assert_allclose(x_c.rot.numpy(), np.asarray(x_j.rot),
                               atol=1e-9)
    np.testing.assert_allclose(P_c.numpy(), np.asarray(P_j), rtol=1e-7,
                               atol=1e-12)
    assert int(i_c["n_eff"]) == int(i_j["n_eff"])


def test_solve_compact_gram_equivalence_direct():
    """tests/test_fused_solve.py:216 on the port: the live lanes gathered
    into a (16, B) buffer give the full buffer's Gram (plain version, f64:
    within 1e-12)."""
    rng = np.random.default_rng(9)
    n, B = 2048, 1800
    p_imu = rng.normal(size=(n, 3)) * 5.0
    normal = rng.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    invb = 0.9 / np.sqrt(np.linalg.norm(p_imu, axis=-1))
    valid = rng.uniform(size=n) > 0.1
    ok = (rng.uniform(size=n) > 0.3) & valid
    ijk = np.floor(p_imu / 0.5).astype(np.int32)
    soa = tk.pack_soa(_t(p_imu), _t(normal), _t(rng.normal(size=n)),
                      _t(invb), _t(ok), _t(ijk), _t(valid))
    live = (soa[tk._OK] > 0) & (soa[tk._VAL] > 0)
    assert int(live.sum()) <= B
    idx = nonzero_static(live, B, n)
    soa_c = torch.where((idx < n)[None, :],
                        soa[:, torch.clamp(idx, max=n - 1)], 0.0)
    params = torch.cat([torch.eye(3, dtype=F64).reshape(-1),
                        _t([0.1, -0.2, 0.05]), _t([0.5]),
                        torch.zeros(3, dtype=F64)]).float()
    G_full, _ = tk.fused_normal_eqs_reference(soa, params)
    G_c, _ = tk.fused_normal_eqs_reference(soa_c, params)
    np.testing.assert_allclose(G_c.numpy(), G_full.numpy(), rtol=1e-12,
                               atol=1e-12)


# ---- tests/test_plane_cache.py on the port (f32, its tolerances) ------

def _mom_numpy(pts, voxel):
    ijk = np.floor(pts / voxel).astype(np.int64)
    out = {}
    for p, v in zip(pts, ijk):
        q = p - v * voxel
        row = out.setdefault(tuple(v), np.zeros(10))
        row[0] += 1
        row[1:4] += q
        row[4:10] += [q[0] * q[0], q[0] * q[1], q[0] * q[2],
                      q[1] * q[1], q[1] * q[2], q[2] * q[2]]
    return out


def _f32_map(pts, capacity_log2, bucket, dense_log2=None):
    m = tvh.make_map(capacity_log2=capacity_log2, bucket=bucket,
                     voxel_size=0.5, dense_log2=dense_log2, moments=True)
    return tvh.insert(m, torch.as_tensor(pts),
                      torch.ones(len(pts), dtype=torch.bool))


def test_moments_match_numpy_groupby():
    rng = np.random.default_rng(42)
    pts = rng.uniform(-6, 6, size=(3000, 3)).astype(np.float32)
    m = _f32_map(pts, 13, 2)  # most voxels overflow their 2-point buckets
    ref = _mom_numpy(pts, 0.5)
    live = ((m.key & (1 << 30)) != 0).numpy()
    coords = tvh._voxel_of(m.points[:, 0, :], m.voxel_size).numpy()
    mom = m.mom.numpy()
    for s in np.flatnonzero(live):
        np.testing.assert_allclose(mom[s], ref[tuple(coords[s])], rtol=1e-4,
                                   atol=1e-4)
    assert live.sum() == len(ref)


def test_plane_from_moments_recovers_analytic_plane():
    rng = np.random.default_rng(42)
    n_true = np.array([-0.3, -0.1, 1.0])
    n_true = n_true / np.linalg.norm(n_true)
    xy = rng.uniform(0, 10, size=(8000, 2)) + np.array([200.0, -50.0])
    z = 0.3 * xy[:, 0] + 0.1 * xy[:, 1] + 5.0
    pts = np.column_stack([xy, z]).astype(np.float32)
    pts += 0.01 * rng.standard_normal(pts.shape).astype(np.float32)
    m = _f32_map(pts, 14, 4)
    q = pts[::40] + np.array([0, 0, 0.02], np.float32)
    nvec, d, ok = (t.numpy() for t in tm.plane_from_moments(
        m, torch.as_tensor(q), torch.ones(len(q), dtype=torch.bool)))
    assert ok.mean() > 0.9
    assert (np.abs(nvec[ok] @ n_true) > 0.995).mean() > 0.95
    resid = np.abs(np.einsum("ni,ni->n", nvec[ok], q[ok]) + d[ok])
    assert np.median(resid) < 0.05


def test_plane_cache_rejects_nonplanar_and_sparse():
    rng = np.random.default_rng(42)
    pts = rng.uniform(-3, 3, size=(5000, 3)).astype(np.float32)
    m = _f32_map(pts, 13, 4)
    ones = torch.ones(64, dtype=torch.bool)
    _, _, ok_in = tm.plane_from_moments(m, torch.as_tensor(pts[:64]), ones)
    _, _, ok_out = tm.plane_from_moments(
        m, torch.as_tensor(pts[:64] + 100.0), ones)
    assert ok_in.float().mean() < 0.5  # volumetric -> mostly rejected
    assert not ok_out.any()  # empty space -> no planes


def test_crop_clears_moments():
    rng = np.random.default_rng(42)
    pts = rng.uniform(-4, 4, size=(2000, 3)).astype(np.float32)
    m = _f32_map(pts, 12, 2)
    assert float(m.mom[:, 0].sum()) == len(pts)
    lo, hi = torch.full((3,), -1.0), torch.full((3,), 1.0)
    for skip_points in (False, True):
        mc = tvh.crop_outside_box(m, lo, hi, skip_points=skip_points)
        live = (mc.key & (1 << 30)) != 0
        assert bool((mc.mom[~live] == 0.0).all())
        assert 0 < int(live.sum()) < int(tvh.num_voxels(m))
        assert (mc.points is m.points) == skip_points


# ---- tests/test_mom_dense.py on the port (f32) -------------------------

def _mk(voxel=1.0, cap_log2=14, dense=(7, 7, 5)):
    return tvh.make_map(capacity_log2=cap_log2, bucket=4, voxel_size=voxel,
                        dense_log2=dense, moments=True)


def _unique_voxel_batch(rng, n, voxel, lo=-40.0, hi=40.0):
    span = int((hi - lo) / voxel)
    cells = rng.choice(span * span * 8, size=n, replace=False)
    ijk = np.stack([cells % span, (cells // span) % span,
                    cells // (span * span)], -1).astype(np.float64)
    ijk[:, :2] += lo / voxel
    return ((ijk + rng.uniform(0.05, 0.95, size=(n, 3))) * voxel).astype(
        np.float32)


def test_build_dense_moments_association_parity():
    rng = np.random.default_rng(42)
    pts = rng.uniform(-30, 30, size=(4000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-12, 12, size=4000).astype(np.float32)
    m = tvh.insert(_mk(), torch.as_tensor(pts),
                   torch.ones(len(pts), dtype=torch.bool))
    md = m._replace(dmom=tvh.build_dense_moments(m, torch.zeros(3)))
    q = torch.as_tensor(pts[::7])
    s_slot, ijk_s = tm.neighborhood_moment_sums(m, q)
    s_dense, ijk_d = tm.neighborhood_moment_sums(md, q)
    assert torch.equal(ijk_s, ijk_d) and torch.equal(s_slot, s_dense)
    ones = torch.ones(len(q), dtype=torch.bool)
    for a, b in zip(tm.plane_from_moments(m, q, ones),
                    tm.plane_from_moments(md, q, ones)):
        assert torch.equal(a, b)


def test_insert_dense_moments_matches_slot_path():
    rng = np.random.default_rng(42)
    voxel, mom_cap, mom_budget = 1.0, 3, 192
    m = _mk(voxel=voxel)
    dshape = m.dense.shape
    warm = _unique_voxel_batch(rng, 256, voxel)
    m = tvh.insert(m, torch.as_tensor(warm), torch.ones(256, dtype=bool),
                   pre_grouped=True)
    dmom = tvh.build_dense_moments(m, torch.zeros(3))
    for _ in range(5):
        batch = torch.as_tensor(_unique_voxel_batch(rng, 256, voxel))
        valid = torch.as_tensor(rng.random(256) > 0.1)
        m = tvh.insert(m, batch, valid, pre_grouped=True, moments_only=True,
                       mom_cap=mom_cap, mom_budget=mom_budget)
        dmom, _ = tvh.insert_dense_moments(dmom, dshape, m.voxel_size, batch,
                                           valid, mom_cap, mom_budget)
    md = m._replace(dmom=dmom)
    q = torch.as_tensor(np.concatenate(
        [warm, _unique_voxel_batch(rng, 128, voxel)]))
    assert torch.equal(tm.neighborhood_moment_sums(m, q)[0],
                       tm.neighborhood_moment_sums(md, q)[0])


def _point_table():
    m = _mk(voxel=1.0, dense=(5, 5, 5))  # 32-cell period per axis
    return m, m.dense.shape, torch.zeros((32 ** 3, tvh.DMOM_CH))


def test_torus_alias_overwrite():
    m, dshape, dmom = _point_table()
    p0 = torch.tensor([[35.25, 4.5, 2.5]])
    p1 = p0 + torch.tensor([[32.0, 0.0, 0.0]])  # the same torus cell
    v = torch.ones(1, dtype=torch.bool)
    dmom, n0 = tvh.insert_dense_moments(dmom, dshape, m.voxel_size, p0, v,
                                        24, 8)
    assert int(n0) == 1
    lin0 = tvh._dense_linear(dshape, torch.tensor([[35, 4, 2]]))
    assert float(dmom[lin0][0, 1]) == 1.0
    dmom, n1 = tvh.insert_dense_moments(dmom, dshape, m.voxel_size, p1, v,
                                        24, 8)
    assert int(n1) == 1  # a NEW cell: the stale row was replaced
    row1 = dmom[tvh._dense_linear(dshape, torch.tensor([[67, 4, 2]]))][0]
    assert float(row1[1]) == 1.0
    np.testing.assert_allclose(row1[2:5].numpy(),
                               (p1[0] - torch.tensor([67.0, 4, 2])).numpy(),
                               rtol=1e-6)
    md = m._replace(dmom=dmom)
    assert float(tm.neighborhood_moment_sums(md, p0)[0][0, 0]) == 0.0
    assert float(tm.neighborhood_moment_sums(md, p1)[0][0, 0]) == 1.0


@pytest.mark.parametrize("mom_cap,want", [(3, 3.0), (0, 6.0)])
def test_freeze_at_cap_and_unbounded(mom_cap, want):
    """mom_cap freezes a cell at the cap; mom_cap <= 0 keeps accumulating
    (tests/test_mom_dense.py:139 and :320)."""
    m, dshape, dmom = _point_table()
    p = torch.tensor([[2.5, 2.5, 2.5]])
    v = torch.ones(1, dtype=torch.bool)
    for _ in range(6):
        dmom, _ = tvh.insert_dense_moments(dmom, dshape, m.voxel_size, p, v,
                                           mom_cap=mom_cap, mom_budget=4)
    lin = tvh._dense_linear(dshape, torch.tensor([[2, 2, 2]]))
    assert float(dmom[lin][0, 1]) == want


def _z_cfg(mod, dense=(8, 8, 4), z_clip=False):
    cfg = mod.LIOConfig()
    cfg.shapes = mod.ShapesConfig(n_raw=8192, n_ds=4096, n_imu=32,
                                  map_capacity_log2=16, map_bucket=4,
                                  map_max_probe=8, knn_chunk=4096,
                                  map_dense_log2=dense,
                                  map_dense_z_clip=z_clip)
    cfg.mapping = mod.MappingConfig(det_range=20.0, surf_leaf_size=0.4,
                                    extrinsic_est_en=False)
    cfg.ikdtree = mod.IkdtreeConfig(
        max_iteration=3, filter_size_map_min=0.4, plane_cache=True,
        plane_cache_warmup=12, mom_dense=True, single_association=True)
    return cfg


def test_short_z_span_is_hard_error():
    with pytest.raises(ValueError, match="z axis"):
        make_step_fn(_z_cfg(tcfg), torch.device("cpu"))
    make_step_fn(_z_cfg(tcfg, z_clip=True), torch.device("cpu"))
    # the horizontal span is checked too, and the leaf must be the voxel
    with pytest.raises(ValueError, match="axis 0"):
        make_step_fn(_z_cfg(tcfg, dense=(6, 8, 6)), torch.device("cpu"))
    cfg = _z_cfg(tcfg, z_clip=True)
    cfg.mapping.surf_leaf_size = 0.5
    with pytest.raises(ValueError, match="surf_leaf_size"):
        make_step_fn(cfg, torch.device("cpu"))


def test_map_dense_log2_autoderive():
    cfg = _z_cfg(tcfg, dense=None)
    make_step_fn(cfg, torch.device("cpu"))
    assert cfg.shapes.map_dense_log2 == (7, 7, 6)
    assert (tcfg.derive_map_dense_log2(20.0, 0.4)
            == jcfg.derive_map_dense_log2(20.0, 0.4) == (7, 7, 6))
