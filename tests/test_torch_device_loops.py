"""The per-scan programs without host reads (the reference's device-side
loops and gates), on the CPU.

* The hash probe (`_lookup_slots`) and the insert's claim loop
  (`_claim_slots`) run a fixed `max_probe` rounds, predicated, where the
  reference runs early-exit lax.while_loops: on tables with long probe
  chains, tombstones and full buckets they equal the early-exit forms
  (written out below as the port had them, one host read a round) and
  the JAX package's lookup and insert, bit for bit.
* The row path's passes (esikf._update_rows, a fixed max_iter + 1
  predicated passes) against the JAX package's update_iterated row path
  pass by pass in f64 (lax.while_loop and lax.cond run eagerly under
  jax.disable_jit, so each executed pass's normal equations are visible):
  single association on and off, 6 and 12 columns, a prior 0.3 m off so
  that the passes re-associate (and, under single association, the lazy
  refresh fires).  The port's first `iters` passes agree within 1e-9, the
  results within 1e-9, `iters` and `t` are equal.
* Every program of the pipeline (`main`, `row`, `row_ext`, the bench
  configuration's 5-NN warmup program and its steady program) is marked
  `sync_free`, and its step makes no port read in a scan
  (utils.device.host_syncs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.core import esikf as jesikf
from better_fastlio2_tpu.core import measurement as jmeas
from better_fastlio2_tpu.map import voxel_hash as jvh
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.core import esikf as tesikf
from better_fastlio2_tpu_torch.core import measurement as tmeas
from better_fastlio2_tpu_torch.io.synthetic import (SyntheticWorld,
                                                    Trajectory,
                                                    make_lio_sequence)
from better_fastlio2_tpu_torch.map import voxel_hash as tvh
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from better_fastlio2_tpu_torch.utils import device as tdev
from test_torch_esikf_row import _ext_problem
from test_torch_math import _close, _close_state, _t, _toy_problem_f64
from test_torch_pipeline import slice_cfg
from test_torch_pipeline_bench import bench_cfg
from test_torch_pipeline_row import small_cfg
from torch_threads import one_torch_thread  # noqa: F401

TABLES = ("chains", "tombstones", "full_buckets")


def _lookup_early_exit(key_arr, ijk, max_probe):
    """The probe loop with its early exit: one host read a round."""
    mask = key_arr.shape[0] - 1
    h0 = tvh._hash(ijk, mask)
    target = tvh._pack(ijk)
    slot = torch.full(h0.shape, -1, dtype=torch.int64)
    open_ = torch.ones(h0.shape, dtype=torch.bool)
    for j in range(max_probe):
        cand = (h0 + j) & mask
        k = key_arr[cand]
        hit = k == target
        slot = torch.where(open_ & hit, cand, slot)
        open_ = open_ & ~hit & (k != tvh._KEY_EMPTY)
        if not bool(torch.any(open_)):
            break
    return slot


def _claim_early_exit(key_arr, h, key, idx, slot, unresolved, max_probe):
    """The claim loop with its early exit: one host read a round."""
    C = key_arr.shape[0]
    probe = torch.zeros_like(idx)
    while bool(torch.any(unresolved)):
        cand = (h + probe) & (C - 1)
        kcand = key_arr[cand]
        found = unresolved & (kcand == key)
        slot = torch.where(found, cand, slot)
        unresolved = unresolved & ~found
        tryc = unresolved & (kcand == tvh._KEY_EMPTY)
        claim = torch.full((C,), tvh._INT_MAX, dtype=torch.int64)
        claim.scatter_reduce_(0, torch.where(tryc, cand, 0),
                              torch.where(tryc, idx, tvh._INT_MAX), "amin",
                              include_self=True)
        won = tryc & (claim[cand] == idx)
        key_arr.index_add_(0, torch.where(won, cand, 0),
                           torch.where(won, key, 0))
        slot = torch.where(won, cand, slot)
        unresolved = unresolved & ~won
        probe = torch.where(unresolved, probe + 1, probe)
        unresolved = unresolved & (probe < max_probe)
    return slot


def _voxels(rng, n, lo=-12, hi=12):
    """n distinct voxel coords in a box."""
    cells = rng.choice((hi - lo) ** 3, size=n, replace=False)
    span = hi - lo
    return np.stack([cells % span, (cells // span) % span,
                     cells // span ** 2], -1) + lo


def _port_map(mj):
    return tvh.VoxelHashMap(
        key=torch.as_tensor(np.array(mj.key)),
        count=torch.as_tensor(np.array(mj.count)),
        points=torch.as_tensor(np.array(mj.points)), dense=None,
        voxel_size=torch.as_tensor(np.array(mj.voxel_size)))


def _table(kind, seed=0):
    """A JAX map of 2^10 slots, bucket 4, 0.5 m voxels, and the voxel
    coords in it: "chains" holds ~800 voxels (78 % load: long probe
    chains), "tombstones" the same with a crop that tombstones the voxels
    of x >= 0 (about half), "full_buckets" ~300 voxels with 6 points each
    (every bucket full, the excess dropped)."""
    rng = np.random.default_rng(seed)
    n_vox = 300 if kind == "full_buckets" else 800
    ijk = _voxels(rng, n_vox)
    reps = 6 if kind == "full_buckets" else 1
    pts = (np.repeat(ijk, reps, axis=0)
           + rng.uniform(0.05, 0.95, size=(n_vox * reps, 3))) * 0.5
    mj = jvh.make_map(capacity_log2=10, bucket=4, voxel_size=0.5,
                      dtype=jnp.float64)
    mj = jvh.insert(mj, jnp.asarray(pts), jnp.ones(len(pts), bool),
                    max_probe=64)
    if kind == "tombstones":
        mj = jvh.crop_outside_box(mj, jnp.asarray([0.0, -20.0, -20.0]),
                                  jnp.asarray([20.0, 20.0, 20.0]))
    return mj, ijk


@pytest.mark.parametrize("max_probe", [6, 64])
@pytest.mark.parametrize("kind", TABLES)
def test_lookup_fixed_rounds_match_early_exit_and_jax(kind, max_probe):
    mj, ijk = _table(kind)
    rng = np.random.default_rng(1)
    # the table's voxels (live and tombstoned) and voxels never inserted
    q = np.concatenate([ijk, _voxels(rng, 400, 14, 22)]).astype(np.int32)
    key = torch.as_tensor(np.array(mj.key))
    got = tvh._lookup_slots(key, torch.as_tensor(q), max_probe)
    early = _lookup_early_exit(key, torch.as_tensor(q), max_probe)
    ref = np.asarray(jvh._lookup_slots(mj.key, jnp.asarray(q), max_probe))
    np.testing.assert_array_equal(got.numpy(), early.numpy())
    np.testing.assert_array_equal(got.numpy(), ref)
    # the tables are what they claim: misses, chains longer than 6
    # probes (voxels past the budget of 6), tombstones, full buckets
    keys = np.array(mj.key)
    assert (got.numpy() < 0).sum() >= 400
    if kind != "full_buckets":
        h0 = tvh._hash(torch.as_tensor(q), 1023).numpy()
        far = np.asarray(jvh._lookup_slots(mj.key, jnp.asarray(q), 64))
        assert ((far - h0) % 1024)[far >= 0].max() >= 6
    if kind == "tombstones":
        assert (keys == tvh._KEY_TOMB).sum() > 300
    if kind == "full_buckets":
        assert (np.array(mj.count) == 4).sum() >= 290


@pytest.mark.parametrize("max_probe", [6, 64])
@pytest.mark.parametrize("kind", TABLES)
def test_claim_fixed_rounds_match_early_exit(kind, max_probe):
    """_claim_slots against the early-exit loop on the same table and
    lanes (new voxels, voxels already in the table, duplicates of one
    voxel, inactive lanes): the same slots and the same key table."""
    mj, ijk = _table(kind)
    rng = np.random.default_rng(2)
    new = _voxels(rng, 500, 14, 22)
    lanes = np.concatenate([new, ijk[:200], new[:40]]).astype(np.int32)
    lanes = torch.as_tensor(lanes[rng.permutation(len(lanes))])
    h = tvh._hash(lanes, 1023)
    key = tvh._pack(lanes)
    idx = torch.arange(len(lanes), dtype=torch.int64)
    slot0 = torch.full((len(lanes),), -1, dtype=torch.int64)
    act = torch.as_tensor(rng.uniform(size=len(lanes)) > 0.1)
    k_fixed = torch.as_tensor(np.array(mj.key))
    k_early = k_fixed.clone()
    s_fixed = tvh._claim_slots(k_fixed, h, key, idx, slot0, act, max_probe)
    s_early = _claim_early_exit(k_early, h, key, idx, slot0, act, max_probe)
    assert torch.equal(s_fixed, s_early) and torch.equal(k_fixed, k_early)
    # some lanes claimed or found their voxel; on the crowded tables some
    # ran out of probes at 6
    assert int((s_fixed >= 0).sum()) > 200
    if max_probe == 6 and kind != "full_buckets":
        assert int(((s_fixed < 0) & act).sum()) > 0


@pytest.mark.parametrize("pre_grouped", [False, True])
@pytest.mark.parametrize("kind", TABLES)
def test_insert_into_crowded_tables_matches_jax(kind, pre_grouped):
    """The whole insert (the fixed-round claim loop inside) on the crowded
    tables against the JAX insert, max_probe 6: key, count and points bit
    for bit."""
    mj, ijk = _table(kind)
    mt = _port_map(mj)
    rng = np.random.default_rng(3)
    vox = np.concatenate([_voxels(rng, 500, 14, 22), ijk[:300]])
    if not pre_grouped:  # several rows a voxel: the grouped insert
        vox = np.repeat(vox, 3, axis=0)
    pts = (vox + rng.uniform(0.05, 0.95, size=vox.shape)) * 0.5
    valid = rng.uniform(size=len(pts)) > 0.05
    mj = jvh.insert(mj, jnp.asarray(pts), jnp.asarray(valid), max_probe=6,
                    pre_grouped=pre_grouped)
    mt = tvh.insert(mt, torch.as_tensor(pts), torch.as_tensor(valid),
                    max_probe=6, pre_grouped=pre_grouped)
    for a, b in zip(mt[:3], mj[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _pass_neqs(measure, log, jax_side):
    """measure, logging each concrete pass's (HTH, HTh, refreshed); the
    JAX package's shape-only trace of the measure is not a pass."""
    def spy(x, conv, aux):
        m = measure(x, conv, aux)
        if jax_side:
            if isinstance(m.h, jax.core.Tracer):
                return m
            w = np.asarray(m.mask, np.float64)
            hx = np.asarray(m.h_x) * w[:, None]
            log.append((hx.T @ hx, hx.T @ (np.asarray(m.h) * w),
                        bool(np.asarray(m.aux.refreshed))))
        else:
            HTH, HTh, _ = m.neq
            log.append((HTH.numpy(), HTh.numpy(), bool(m.aux.refreshed)))
        return m
    return spy


@pytest.mark.parametrize("n_cols", [6, 12])
@pytest.mark.parametrize("single", [False, True])
def test_row_passes_match_jax_pass_by_pass(single, n_cols):
    if n_cols == 12:
        mj, mt, scan, xj, xt, P0 = _ext_problem()
    else:
        mj, mt, scan, xj, xt, P0 = _toy_problem_f64()
    # a prior 0.3 m off: the passes move rows across voxels
    off = [0.3, -0.2, 0.1]
    xj = xj._replace(pos=xj.pos + jnp.asarray(off))
    xt = xt._replace(pos=xt.pos + _t(off))
    ext = n_cols == 12
    valid = np.ones(len(scan), bool)
    kw = dict(extrinsic_est=ext, single_association=single)
    fj, aj = jmeas.make_measure_fn(mj, jnp.asarray(scan), jnp.asarray(valid),
                                   **kw)
    log_j, log_t = [], []
    with jax.disable_jit():
        xpj, Ppj, _, ij = jesikf.update_iterated(
            xj, jnp.asarray(P0), _pass_neqs(fj, log_j, True), aj,
            max_iter=4, n_cols=n_cols)
    ft, at = tmeas.make_measure_fn(mt, _t(scan), torch.as_tensor(valid),
                                   **kw)
    tdev.host_syncs.reset()
    xpt, Ppt, _, it = tesikf.update_iterated(
        xt, _t(P0), _pass_neqs(ft, log_t, False), at, max_iter=4,
        n_cols=n_cols)
    assert tdev.host_syncs.count == 0  # no port read in the passes
    n = int(ij["iters"])
    assert int(it["iters"]) == n and int(it["t"]) == int(ij["t"])
    assert len(log_j) == n and len(log_t) == 5 and n >= 3
    for (Hj, hj, rj), (Ht, ht, rt) in zip(log_j, log_t[:n]):
        np.testing.assert_allclose(Ht, Hj, rtol=1e-9,
                                   atol=1e-9 * np.abs(Hj).max())
        np.testing.assert_allclose(ht, hj, rtol=1e-9,
                                   atol=1e-9 * np.abs(hj).max())
        assert rt == rj
    if single:
        assert any(r for _, _, r in log_j)  # the lazy refresh fired
    assert float(it["n_eff"]) == float(ij["n_eff"])
    _close_state(xpt, xpj, 1e-9)
    _close(Ppt, Ppj, 1e-9)


def _program_cfg(name):
    if name == "main":
        return slice_cfg(tcfg)
    if name in ("row", "row_ext"):
        return small_cfg(tcfg, "ext" if name == "row_ext" else "row")
    return bench_cfg(tcfg)


@pytest.mark.parametrize("name", ["main", "row", "row_ext", "bench"])
def test_programs_are_sync_free(name):
    """Each program's step is marked sync_free and makes no port read in
    a scan; the bench configuration runs its warmup program (8 scans)
    and then its steady program."""
    groups = make_lio_sequence(
        duration=1.6 if name == "bench" else 0.8, n_points=3000, seed=3,
        noise=0.004, traj=Trajectory(t_still=0.3, speed=2.0),
        world=SyntheticWorld(seed=0, half_x=12.0, half_y=12.0, height=5.0))
    p = LIOPipeline(_program_cfg(name), device="cpu")
    reads = {}

    def counted(prog, step):
        def run(*a, **kw):
            s0 = tdev.host_syncs.count
            out = step(*a, **kw)
            reads.setdefault(prog, []).append(tdev.host_syncs.count - s0)
            return out
        assert step.sync_free
        run.sync_free = step.sync_free
        return run

    p._step = counted("steady", p._step)
    if name == "bench":
        p._step_warm = counted("warmup", p._step_warm)
    for g in groups:
        p.process_scan(g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                       g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
    assert sorted(reads) == (["steady", "warmup"] if name == "bench"
                             else ["steady"])
    assert all(len(v) >= 4 for v in reads.values())
    assert all(n == 0 for v in reads.values() for n in v), reads
    if name == "bench":
        assert len(reads["warmup"]) == 8 and p.ls.map.dmom is not None
