"""The ownership-sharded map and the sharded scan tick of the port
(parallel/sharded.py) on 2 gloo ranks on the CPU, against the port's
one-table map and the JAX package's 2-device CPU mesh (mirrors
tests/test_sharded.py, which runs 8 devices).

* Sharded kNN is exact: the merged 5-NN equal the one-table search bit
  for bit (the stable re-top-k keeps lax.top_k's tie order), and the
  JAX 2-device sharded search's within 1e-6 m^2 (its jitted program
  fuses the squared distance).
* Ownership partitions the map: the ranks' live voxels add up to the
  one-table count, every rank holds some, and rank r's table is the JAX
  2-device map's [r] exactly (same hash, same claims).
* A second insert adds only the new voxels.
* sharded_hth_reduce and sharded_update_step (the row shards' normal
  equations psum'd, the replicated solve) equal the JAX 2-device
  functions in f64.
* The sharded tick (make_sharded_step_fn: int16 all_gather of the
  downsampled shards, 5-NN merge for 12 scans, then psum'd moment
  planes, K2's 6-column rows on each rank's n_ds / 2 rows with HTH /
  HTh / n_valid psum'd, owner-masked insert) through
  parallel/launch.py: in f64 within 1e-6 m of the JAX 2-device step
  (measured ~2e-11 m), both ranks bit-identical, the rank tables' keys
  and counts equal to the JAX map's, and it tracks the trajectory (ATE
  < 0.15 m, as the mirror).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import better_fastlio2_tpu.config as jcfg
import better_fastlio2_tpu.io.synthetic as jsyn
from better_fastlio2_tpu.core import imu as jimu
from better_fastlio2_tpu.core.state import State as JState
from better_fastlio2_tpu.map import voxel_hash as jvh
from better_fastlio2_tpu.parallel import sharded as jsh
from better_fastlio2_tpu.utils import so3 as jso3

from better_fastlio2_tpu_torch.map import voxel_hash as tvh
from better_fastlio2_tpu_torch.parallel import launch as tlaunch
from torch_ranks import launch, run_ranks, w_row_reduce, w_sharded_map
from torch_threads import one_torch_thread  # noqa: F401

D = 2
CAP = 13  # slots per rank: the one-table map's 2^14 split in two
ORIGIN = np.array([0.0, 0.0, 1.5])


# the reference's shard_map programs are jitted here (op by op otherwise)


def _cloud(rng, n):
    return np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                     rng.uniform(-2, 2, n)], 1).astype(np.float32)


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh(jax.devices("cpu")[:D])


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(42)
    pts, q, pts_b = _cloud(rng, 4096), _cloud(rng, 512), _cloud(rng, 1024)
    return (pts, q, pts_b), run_ranks(w_sharded_map, D, pts, q, pts_b, CAP)


def test_sharded_map_knn_matches_single_chip(maps, jmesh):
    (pts, q, _), ranks = maps
    m1 = tvh.make_map(capacity_log2=14, bucket=4, voxel_size=0.5)
    m1 = tvh.insert(m1, torch.as_tensor(pts), torch.ones(len(pts),
                                                         dtype=torch.bool))
    nb1, d21, ok1 = (t.numpy() for t in tvh.knn(m1, torch.as_tensor(q), k=5))
    ms = jsh.make_sharded_map(jmesh, capacity_log2_per_dev=CAP, bucket=4,
                              voxel_size=0.5)
    ms = jax.jit(jsh.sharded_map_insert(jmesh))(ms, jnp.asarray(pts),
                                       jnp.ones(len(pts), bool))
    nbj, d2j, okj = jax.jit(jsh.sharded_map_knn(jmesh, k=5))(ms, jnp.asarray(q))
    for r in ranks:
        nbs, d2s, oks = r["knn"]
        np.testing.assert_array_equal(oks, ok1)
        np.testing.assert_array_equal(d2s, d21)
        np.testing.assert_array_equal(nbs, nb1)
        # the jitted reference fuses the squared distance (last-bit
        # differences in f32; the mirror holds d2 to 1e-5)
        np.testing.assert_array_equal(oks, np.asarray(okj))
        np.testing.assert_allclose(d2s, np.asarray(d2j), rtol=0, atol=1e-6)


def _live(key):
    return (key & (1 << 30)) != 0


def test_sharded_map_ownership_partitions(maps, jmesh):
    (pts, _, _), ranks = maps
    m1 = tvh.make_map(capacity_log2=14, bucket=4, voxel_size=0.5)
    m1 = tvh.insert(m1, torch.as_tensor(pts), torch.ones(len(pts),
                                                         dtype=torch.bool))
    per_rank = [int(_live(r["tables"]["key"]).sum()) for r in ranks]
    assert sum(per_rank) == int(tvh.num_voxels(m1))
    assert all(n > 0 for n in per_rank)
    ms = jsh.make_sharded_map(jmesh, capacity_log2_per_dev=CAP, bucket=4,
                              voxel_size=0.5)
    ms = jax.jit(jsh.sharded_map_insert(jmesh))(ms, jnp.asarray(pts),
                                       jnp.ones(len(pts), bool))
    for d, r in enumerate(ranks):
        for f in ("key", "count", "points"):
            np.testing.assert_array_equal(r["tables"][f],
                                          np.asarray(getattr(ms, f))[d])


def test_sharded_map_insert_is_incremental(maps):
    (pts, _, pts_b), ranks = maps
    n1 = sum(int(_live(r["tables"]["key"]).sum()) for r in ranks)
    n2 = sum(int(_live(r["tables2"]["key"]).sum()) for r in ranks)
    both = np.concatenate([pts, pts_b])
    m1 = tvh.make_map(capacity_log2=14, bucket=4, voxel_size=0.5)
    m1 = tvh.insert(m1, torch.as_tensor(both),
                    torch.ones(len(both), dtype=torch.bool))
    assert n2 == int(tvh.num_voxels(m1))
    assert n2 >= n1


def test_sharded_hth_reduce_and_update_step_match_jax(jmesh):
    rng = np.random.default_rng(7)
    n = 512
    h_x = rng.normal(size=(n, 12))
    h = rng.normal(size=n)
    mask = rng.uniform(size=n) > 0.3
    x = [np.array([0.1, -0.2, 0.05]), np.array([1.0, 0.0, 0.0, 0.0]),
         np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3), np.zeros(3),
         np.zeros(3), np.zeros(3), np.array([0.0, 0.0, -9.81])]
    P_ = np.eye(23) * 1e-2
    cloud = _cloud(rng, 4096).astype(np.float64)
    cloud[:, 2] = np.round(cloud[:, 2])  # planes for the 5-NN fit
    m = jvh.make_map(capacity_log2=13, bucket=4, voxel_size=0.5,
                     dtype=jnp.float64)
    m = jvh.insert(m, jnp.asarray(cloud), jnp.ones(len(cloud), bool))
    q = cloud[:n] + rng.normal(size=(n, 3)) * 0.01
    valid = rng.uniform(size=n) > 0.1
    m_np = {"key": np.asarray(m.key), "count": np.asarray(m.count),
            "points": np.asarray(m.points), "mom": None, "voxel": 0.5}
    ranks = run_ranks(w_row_reduce, D, h_x, h, mask, x, P_, m_np, q, valid)
    HtH_j, Hth_j = jax.jit(jsh.sharded_hth_reduce(jmesh))(
        jnp.asarray(h_x), jnp.asarray(h), jnp.asarray(mask))
    m_spec = m._replace(dense=None, mom=None)
    dx_j, n_j = jax.jit(jsh.sharded_update_step(jmesh))(
        JState(*(jnp.asarray(v) for v in x)), jnp.asarray(P_), m_spec,
        jnp.asarray(q), jnp.asarray(valid))
    for HtH, Hth, dx, _ in ranks:
        np.testing.assert_allclose(HtH, np.asarray(HtH_j), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(Hth, np.asarray(Hth_j), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(dx, np.asarray(dx_j), rtol=1e-9,
                                   atol=1e-12)
    # each rank's own count; the reference hands back device 0's
    assert ranks[0][3] == float(n_j) > 0 and ranks[1][3] > 0


def _jax_sharded_step(jmesh, n_scans):
    """The JAX 2-device sharded tick over launch.py's "small" sharded
    workload, in f64 (tests/test_sharded.py's loop)."""
    cfg = tlaunch.workload_config(jcfg, "small", False, "float64")
    groups = tlaunch.workload_sequence(jsyn, "small", n_scans, spmd=False)
    dt = jnp.float64
    step = jsh.make_sharded_step_fn(cfg, jmesh)
    ms = jsh.make_sharded_map(
        jmesh, capacity_log2_per_dev=cfg.shapes.map_capacity_log2, bucket=4,
        voxel_size=0.4, dtype=dt, moments=True)
    g0 = groups[0]
    x, Pm, acc_norm = jimu.imu_init(
        jnp.asarray(g0["imu_acc"], dt), jnp.asarray(g0["imu_gyr"], dt),
        jnp.ones(len(g0["imu_acc"]), bool), jso3.quat_identity(dt),
        jnp.zeros(3, dt), dt)
    shard = NamedSharding(jmesh, P("dp"))
    last_end = g0["scan_beg_abs"] + g0["scan_end_t"]
    lo, hi = jnp.full(3, -200.0, dt), jnp.full(3, 200.0, dt)
    tail = jnp.zeros((2, 3), dt)
    traj, gts = [], []
    n_raw, m_imu = cfg.shapes.n_raw, cfg.shapes.n_imu
    for gi, g in enumerate(groups[1:]):
        Pp, Tt, Vv = (np.zeros((n_raw, 3)), np.zeros(n_raw),
                      np.zeros(n_raw, bool))
        k = min(len(g["pts"]), n_raw)
        Pp[:k], Tt[:k], Vv[:k] = g["pts"][:k], g["pt_t"][:k], True
        A, G = np.zeros((m_imu, 3)), np.zeros((m_imu, 3))
        Ti, Mk = np.full(m_imu, np.inf), np.zeros(m_imu, bool)
        k = min(len(g["imu_acc"]), m_imu)
        A[:k], G[:k], Ti[:k], Mk[:k] = (g["imu_acc"][:k], g["imu_gyr"][:k],
                                        g["imu_t"][:k], True)
        batch = jimu.ImuBatch(acc=jnp.asarray(A), gyr=jnp.asarray(G),
                              t=jnp.asarray(Ti), mask=jnp.asarray(Mk))
        ler = last_end - g["scan_beg_abs"]
        last_end = g["scan_beg_abs"] + g["scan_end_t"]
        x, Pm, ms, tail = step(
            x, Pm, ms, *(jax.device_put(jnp.asarray(a), shard)
                         for a in (Pp, Tt, Vv)),
            batch, jnp.asarray(ler, dt), jnp.asarray(g["scan_end_t"], dt),
            acc_norm, lo, hi, tail[0], tail[1],
            jnp.asarray(gi < tlaunch.WARMUP_KNN_SCANS))
        traj.append(np.concatenate([np.asarray(x.pos), np.asarray(x.rot)]))
        gts.append(g["gt_pos"] - ORIGIN)
    return np.asarray(traj), np.asarray(gts), ms


def test_sharded_step_matches_jax_and_tracks(tmp_path, jmesh):
    n_scans = 30
    out = launch(["--nprocs", str(D), "--device", "cpu", "--n-scans",
                  str(n_scans), "--dtype", "float64", "--save",
                  str(tmp_path)], tmp_path / "out.json")
    tj, gt, ms = _jax_sharded_step(jmesh, n_scans)
    t0 = np.asarray(out["ranks"][0]["traj"])
    np.testing.assert_array_equal(t0, np.asarray(out["ranks"][1]["traj"]))
    np.testing.assert_allclose(t0, tj, rtol=0, atol=1e-6)
    for d in range(D):
        z = np.load(os.path.join(tmp_path, f"rank{d}.npz"))
        np.testing.assert_array_equal(z["key"], np.asarray(ms.key)[d])
        np.testing.assert_array_equal(z["count"], np.asarray(ms.count)[d])
    errs = np.linalg.norm(t0[:, :3] - gt, axis=1)
    assert np.sqrt(np.mean(errs ** 2)) < 0.15 and errs[-1] < 0.2
