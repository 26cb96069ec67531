"""The SPMD window step of the port (LIOPipeline(mesh=...),
parallel.sharded.make_spmd_window_step_fn) and the mesh mode of
insert_dense_moments, on gloo ranks on the CPU, against the JAX package
on a CPU mesh (mirrors tests/test_spmd_step.py).

* insert_dense_moments at 2 ranks is bit-exact against the JAX SPMD
  insert on 2 devices and, where the budget does not bind, against the
  one-device insert (`_bit_exact`); with a binding budget and
  front-compacted rows the strided split selects what the one-device
  ascending cap does (`_binding_budget`); duplicate replace rows from two
  ranks' pre-sliced batches apply once, accumulate rows twice
  (`_dedupe`).
* LIOPipeline(mesh=) at 2 ranks against JAX's LIOPipeline(mesh=2
  devices) on the shapes of tests/test_spmd_step.py:_spmd_cfg
  (parallel/launch.py's "small" workload), in f64: trajectories within
  1e-6 m (both add the two ranks' Grams in one order), both ranks
  bit-identical and their dense moment tables equal (the f32 run is
  tests/test_torch_spmd_f32.py).
* A one-rank mesh runs the production program plus identity
  collectives: bit-identical to the port's window pipeline without a
  mesh.
* parallel.sharded.make_spmd_window_step_fn (the reference's program,
  which its LIOPipeline(mesh=) runs) on a steady window equals the port
  pipeline's own window at 2 ranks bit for bit, so it holds the JAX
  agreement above; with override_ndev = 2 on one rank (the timing hook)
  it runs a finite, partial window.
* The 8-rank run (slow, as its mirror) within 2e-3 m of the one-device
  window pipeline, both tracking ground truth (in f64).
"""

import os

import numpy as np
import pytest

import better_fastlio2_tpu.config as jcfg
import better_fastlio2_tpu.io.synthetic as jsyn
import jax
import jax.numpy as jnp
from better_fastlio2_tpu.map import voxel_hash as jvh
from better_fastlio2_tpu.parallel import sharded as jsh
from better_fastlio2_tpu.pipeline.lio import LIOPipeline as JaxPipeline
from jax.sharding import PartitionSpec as P

import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.io import synthetic as tsyn
from better_fastlio2_tpu_torch.parallel import launch as tlaunch
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from test_mom_dense import _mk, _unique_voxel_batch
from torch_ranks import launch, run_ranks, w_insert_dense, w_spmd_wstep
from torch_threads import one_torch_thread  # noqa: F401

ORIGIN = np.array([0.0, 0.0, 1.5])
N_SCANS = 20  # 12 warmup scans, then steady windows of 4


def _jax_spmd_insert(dmom0, dshape, vs, batch, valid, cap, budget, D,
                     pre=False):
    mesh = jsh.make_mesh(jax.devices("cpu")[:D])

    def local(d, p, v):
        return jvh.insert_dense_moments(
            d, dshape, vs, p, v, mom_cap=cap, mom_budget=budget,
            spmd_axis="dp", spmd_ndev=D, spmd_pre_sliced=pre,
            spmd_dedupe=pre)

    spec = P("dp") if pre else P()
    f = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), spec, spec),
                              out_specs=(P(), P()), check_vma=False))
    return f(dmom0, jnp.asarray(batch), jnp.asarray(valid))


@pytest.fixture(scope="module")
def insert_cases():
    """{name: (port inputs, JAX one-device (dmom, n_new) or None, JAX
    2-device (dmom, n_new))}."""
    rng = np.random.default_rng(42)
    cases = {}
    # _bit_exact: a non-binding budget
    m = _mk(voxel=1.0, dense=(6, 6, 5))
    warm = _unique_voxel_batch(rng, 256, 1.0, lo=-25.0, hi=25.0)
    m = jvh.insert(m, jnp.asarray(warm), jnp.ones(len(warm), bool),
                   pre_grouped=True)
    dmom0 = jvh.build_dense_moments(m, center=np.zeros(3))
    batch = _unique_voxel_batch(rng, 256, 1.0, lo=-25.0, hi=25.0)
    valid = rng.random(256) > 0.15
    cases["bit_exact"] = (dmom0, m.dense.shape, batch, valid, 3, 256, False)
    # _binding_budget: front-compacted valid rows, budget 32 < 64 rows
    m = _mk(voxel=1.0)
    seed = _unique_voxel_batch(rng, 64, 1.0)
    m = jvh.insert(m, jnp.asarray(seed), jnp.ones(64, bool),
                   pre_grouped=True)
    dmom0 = jvh.build_dense_moments(m, center=np.zeros(3))
    batch = _unique_voxel_batch(rng, 256, 1.0, lo=-25.0, hi=25.0)
    valid = np.zeros(256, bool)
    valid[:64] = True
    cases["binding_budget"] = (dmom0, m.dense.shape, batch, valid, 3, 32,
                               False)
    # _dedupe: the two ranks' pre-sliced rows hit one voxel (x = 35)
    pts = np.zeros((8, 3), np.float32)
    valid = np.zeros(8, bool)
    pts[0] = [35.25, 4.5, 2.5]
    pts[4] = [35.75, 4.5, 2.5]
    valid[0] = valid[4] = True
    cases["dedupe"] = (jnp.zeros((32 ** 3, jvh.DMOM_CH), jnp.float32),
                       (32, 32, 32, 2), pts, valid, 24, 32, True)
    vs = jnp.asarray(1.0, jnp.float32)
    out = {}
    for name, (d0, dshape, b, v, cap, budget, pre) in cases.items():
        one = None
        if not pre:
            one = jvh.insert_dense_moments(d0 + 0, dshape, vs, jnp.asarray(b),
                                           jnp.asarray(v), mom_cap=cap,
                                           mom_budget=budget)
        two = _jax_spmd_insert(d0, dshape, vs, b, v, cap, budget, 2, pre)
        if pre:  # the same rows again: the owned cell accumulates
            two = _jax_spmd_insert(two[0], dshape, vs, b, v, cap, budget, 2,
                                   pre)
        out[name] = ((np.asarray(d0), dshape, 1.0, b, v, cap, budget, pre),
                     one, two)
    names = list(out)
    ranks = run_ranks(w_insert_dense, 2, [out[n][0] for n in names])
    return {n: (out[n], [r[i] for r in ranks]) for i, n in
            enumerate(names)}


@pytest.mark.parametrize("case", ["bit_exact", "binding_budget"])
def test_insert_dense_moments_spmd_bit_exact(insert_cases, case):
    (inputs, one, two), port = insert_cases[case]
    for dmom, n_new in port:
        np.testing.assert_array_equal(dmom, np.asarray(two[0]))
        np.testing.assert_array_equal(dmom, np.asarray(one[0]))
        assert n_new == int(two[1]) == int(one[1])
    if case == "binding_budget":
        # the full budget applied (32 cells), not budget / D
        touched = np.sum(np.any(port[0][0] != inputs[0], axis=1))
        assert touched == inputs[6] == 32


def test_insert_dense_moments_spmd_dedupe(insert_cases):
    (inputs, _, two), port = insert_cases["dedupe"]
    lin = int(np.asarray(jvh._dense_linear(inputs[1],
                                           jnp.asarray([[35, 4, 2]])))[0])
    for dmom, _ in port:
        np.testing.assert_array_equal(dmom, np.asarray(two[0]))
        # one replace row (count 1, then 3 after two accumulates)
        assert dmom[lin, 1] == 3.0
        q0 = inputs[3][0] - np.array([35, 4, 2])
        q1 = inputs[3][4] - np.array([35, 4, 2])
        np.testing.assert_allclose(dmom[lin, 2:5], 2 * q0 + q1, rtol=1e-6)


def _jax_run(dtype, D, window=4):
    cfg = tlaunch.workload_config(jcfg, "small", True, dtype)
    groups = tlaunch.workload_sequence(jsyn, "small", N_SCANS)
    pipe = JaxPipeline(cfg, window=window,
                       mesh=jsh.make_mesh(jax.devices("cpu")[:D]))
    for g in groups:
        pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                          g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
    pipe.flush()
    return np.asarray(pipe.trajectory), pipe


def _port_run(dtype, window=4):
    cfg = tlaunch.workload_config(tcfg, "small", True, dtype)
    groups = tlaunch.workload_sequence(tsyn, "small", N_SCANS)
    pipe = LIOPipeline(cfg, device="cpu", window=window)
    for g in groups:
        pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                          g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
    pipe.flush()
    return np.asarray(pipe.trajectory), pipe


def _ate(traj):
    groups = tlaunch.workload_sequence(tsyn, "small", N_SCANS)
    gt = np.stack([g["gt_pos"] for g in groups[-len(traj):]]) - ORIGIN
    return float(np.sqrt(np.mean(np.sum((traj[:, :3] - gt) ** 2, -1))))


def _spmd(tmp_path, n, dtype, window=4):
    return launch(["--nprocs", str(n), "--device", "cpu", "--spmd",
                   "--n-scans", str(N_SCANS), "--dtype", dtype, "--window",
                   str(window), "--save", str(tmp_path)],
                  tmp_path / "out.json")


@pytest.fixture(scope="module")
def two_f64(tmp_path_factory):
    return _spmd(tmp_path_factory.mktemp("spmd2"), 2, "float64")


def test_spmd_window_two_ranks_match_jax_f64(two_f64):
    tj, jp = _jax_run("float64", 2)
    r0, r1 = two_f64["ranks"]
    t0, t1 = np.asarray(r0["traj"]), np.asarray(r1["traj"])
    np.testing.assert_array_equal(t0, t1)
    assert r0["dmom_sha256"] == r1["dmom_sha256"]
    assert not r0["graphed"]  # a gloo mesh runs its ticks eagerly
    assert t0.shape == tj.shape == (N_SCANS - 1, 7)
    np.testing.assert_allclose(t0, tj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(r0["pos"], np.asarray(jp.ls.x.pos), rtol=0,
                               atol=1e-6)
    assert jp.ls.map.dmom is not None
    assert abs(r0["dmom_sum"] - float(np.asarray(jp.ls.map.dmom).sum())) \
        <= 1e-6 * abs(r0["dmom_sum"])
    assert _ate(t0) < 0.12


def test_spmd_window_single_device_mesh(tmp_path):
    """A one-rank mesh: the production program plus identity collectives,
    bit-identical to the window pipeline without a mesh."""
    out = _spmd(tmp_path, 1, "float64", window=2)
    ref, pipe = _port_run("float64", window=2)
    t = np.asarray(out["ranks"][0]["traj"])
    assert len(t) > 4 and np.all(np.isfinite(t))
    np.testing.assert_array_equal(t, ref)
    np.testing.assert_array_equal(out["ranks"][0]["pos"],
                                  pipe.ls.x.pos.numpy())
    z = np.load(os.path.join(tmp_path, "rank0.npz"))
    np.testing.assert_array_equal(z["dmom"], pipe.ls.map.dmom.numpy())


def test_make_spmd_window_step_fn_matches_pipeline():
    for out in run_ranks(w_spmd_wstep, 2, 21, 4, None):
        traj, infos, dmom_pipe, dmom_fn = out
        np.testing.assert_array_equal(infos[:, :7].astype(np.float64), traj)
        np.testing.assert_array_equal(dmom_fn, dmom_pipe)
    (traj, infos, _, _), = run_ranks(w_spmd_wstep, 1, 21, 4, 2)
    assert infos.shape == (4, 32) and np.all(np.isfinite(infos))
    # half the rows solve: the share is partial, the pose still near
    assert np.abs(infos[:, :3] - traj[:, :3]).max() < 0.05


@pytest.mark.slow
def test_spmd_window_matches_production_8dev(tmp_path):
    # f64: in f32 this sequence's motion onset grows the Gram's
    # reduction-order noise to ~1 cm (tests/test_torch_spmd_f32.py)
    out = _spmd(tmp_path, 8, "float64")
    ref, _ = _port_run("float64")
    ts = [np.asarray(r["traj"]) for r in out["ranks"]]
    for t in ts[1:]:
        np.testing.assert_array_equal(t, ts[0])
    assert np.abs(ts[0][:, :3] - ref[:, :3]).max() < 2e-3
    assert _ate(ts[0]) < 0.12 and _ate(ref) < 0.12
