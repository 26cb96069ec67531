"""The slab-owned sharded map and its ring migration (parallel/sharded.py:
slab_owner, sharded_slab_insert, sharded_slab_migrate) on 2 gloo ranks on
the CPU, and the communication-volume accounting (mirrors
tests/test_slab_migration.py, which runs 8 devices).

* Insert under slab ownership at shift 0, then migrate to shift 1 with a
  capped buffer until nothing is left: the global map content is exactly
  preserved (same voxels, counts and moment weights, no voxel held
  twice), every voxel sits with its new owner, no row was lost, and
  bytes moved; the ranks' tables before and after equal the JAX 2-device
  run's [r] (keys, counts and points exactly, moments within f32 order).
* comm_volume_per_scan and spmd_comm_volume_per_scan equal the JAX
  functions' dictionaries for D in {1, 2, 4, 8} (host arithmetic), and
  the steady / warmup totals hold the mirror's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import better_fastlio2_tpu.config as jcfg
from better_fastlio2_tpu.parallel import sharded as jsh

import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.parallel import sharded as tsh
from torch_ranks import run_ranks, w_slab
from torch_threads import one_torch_thread  # noqa: F401

D = 2
SLAB_LOG2 = 3
MAX_ROWS = 256
CAP = 13  # 2^13 slots a rank: the mirror's load (8 x 2^11 for 8 devices)


def _cloud(rng, n):
    # spans several x-slabs (slab_log2=3 at 0.5 m voxels: 4 m slabs)
    return np.stack([rng.uniform(-30, 30, n), rng.uniform(-6, 6, n),
                     rng.uniform(-2, 2, n)], 1).astype(np.float32)


def _global_voxels(tables_by_rank, vs=0.5):
    """{coord: (count, mom_n, rank)} over the ranks' tables."""
    out = {}
    for d, t in enumerate(tables_by_rank):
        live = (t["key"] & (1 << 30)) != 0
        for s in np.nonzero(live)[0]:
            c = tuple(np.floor(t["points"][s, 0] / vs).astype(int))
            assert c not in out, f"voxel {c} held twice"
            out[c] = (int(t["count"][s]), float(t["mom"][s, 0]), d)
    return out


@pytest.fixture(scope="module")
def runs():
    pts = _cloud(np.random.default_rng(5), 4000)
    port = run_ranks(w_slab, D, pts, SLAB_LOG2, MAX_ROWS, CAP)
    mesh = jsh.make_mesh(jax.devices("cpu")[:D])
    ms = jsh.make_sharded_map(mesh, capacity_log2_per_dev=CAP, bucket=4,
                              voxel_size=0.5, moments=True)
    # jitted: the reference's shard_map programs run op by op otherwise
    ms = jax.jit(jsh.sharded_slab_insert(mesh, slab_log2=SLAB_LOG2))(
        ms, jnp.asarray(0, jnp.int32), jnp.asarray(pts),
        jnp.ones(len(pts), bool))
    before = jax.tree_util.tree_map(np.asarray, ms)
    mig = jax.jit(jsh.sharded_slab_migrate(mesh, slab_log2=SLAB_LOG2,
                                           max_rows=MAX_ROWS))
    steps = []
    for _ in range(40):
        ms, n_left, bts, n_lost = mig(ms, jnp.asarray(1, jnp.int32))
        steps.append((int(n_left), int(bts), int(n_lost)))
        if int(n_left) == 0:
            break
    return port, (before, jax.tree_util.tree_map(np.asarray, ms), steps)


def test_slab_migrate_preserves_map(runs):
    port, _ = runs
    before = _global_voxels([r["before"] for r in port])
    after = _global_voxels([r["after"] for r in port])
    assert len(before) > 200
    for c, (_, _, d) in before.items():  # ownership at shift 0
        assert (c[0] >> SLAB_LOG2) % D == d
    steps = port[0]["steps"]
    assert all(s == t for s, t in zip(steps, port[1]["steps"]))
    assert steps[-1][0] == 0 and all(s[2] == 0 for s in steps)
    assert sum(s[1] for s in steps) > 0
    assert set(after) == set(before)
    for c in before:
        assert after[c][0] == before[c][0], c
        np.testing.assert_allclose(after[c][1], before[c][1])
    for c, (_, _, d) in after.items():  # re-partitioned to the new owners
        assert ((c[0] >> SLAB_LOG2) - 1) % D == d


def test_slab_migrate_matches_jax(runs):
    port, (jb, ja, jsteps) = runs
    assert port[0]["steps"] == jsteps
    for d, r in enumerate(port):
        for when, jm in (("before", jb), ("after", ja)):
            for f in ("key", "count", "points"):
                np.testing.assert_array_equal(r[when][f],
                                              getattr(jm, f)[d], err_msg=f)
            np.testing.assert_allclose(r[when]["mom"], jm.mom[d], rtol=1e-6,
                                       atol=1e-5)


def test_slab_owner_matches_jax():
    rng = np.random.default_rng(3)
    ijk = rng.integers(-5000, 5000, size=(4096, 3)).astype(np.int32)
    for n_dev, shift in ((2, 0), (3, 1), (8, -5)):
        np.testing.assert_array_equal(
            tsh.slab_owner(torch.as_tensor(ijk), n_dev, shift).numpy(),
            np.asarray(jsh.slab_owner(jnp.asarray(ijk), n_dev, shift)))
        np.testing.assert_array_equal(
            tsh._owner_of(torch.as_tensor(ijk), n_dev).numpy(),
            np.asarray(jsh._owner_of(jnp.asarray(ijk), n_dev)))


def _cfg(mod):
    cfg = mod.LIOConfig()
    cfg.shapes = mod.ShapesConfig(n_raw=1 << 15, n_ds=1 << 14, n_imu=16,
                                  map_capacity_log2=20, map_bucket=4,
                                  map_max_probe=6, knn_chunk=1 << 14,
                                  insert_mom_budget=4096)
    return cfg


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("fn", ["comm_volume_per_scan",
                                "spmd_comm_volume_per_scan"])
def test_comm_volume_accounting(fn, n_dev):
    got = getattr(tsh, fn)(_cfg(tcfg), n_dev)
    assert got == getattr(jsh, fn)(_cfg(jcfg), n_dev)
    assert got["n_devices"] == n_dev
    if fn == "comm_volume_per_scan" and n_dev == 8:
        assert 0 < got["steady_total_bytes_per_scan"] < 3e6
        assert (got["warmup_total_bytes_per_scan"]
                > got["steady_total_bytes_per_scan"])
    if n_dev == 1:  # one rank moves nothing
        assert got["steady_total_bytes_per_scan"] == 0
