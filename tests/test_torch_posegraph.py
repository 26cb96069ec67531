"""Port parity: backend/posegraph.py against the JAX package, f64 on the CPU.

* The factor adds (prior, between with and without the Cauchy kernel,
  GPS, set_pose, set_poses, writes past capacity dropped): the port's
  graph equals the JAX package's exactly.
* `optimize` (GN + Jacobi-PCG, Cauchy IRLS, GPS) from one graph carried
  over with convert.pose_graph_from_numpy: poses within 1e-9; the
  residuals and Jacobian blocks to 1e-12.
* `dense_marginals` and `selected_marginals` against the JAX package's:
  within 1e-9 of each block's own scale.
* The behavioural assertions of tests/test_posegraph.py on the port: a
  drifted square closes its loop, a prior pins a pose, the between
  residual is zero at the truth and its Jacobians match autodiff, GPS
  factors pin translation, the structured marginals equal the dense ones
  and scale to 2048 poses.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.backend import posegraph as jpg
from better_fastlio2_tpu.utils import se3 as jse3
from better_fastlio2_tpu_torch import convert
from better_fastlio2_tpu_torch.backend import posegraph as tpg
from better_fastlio2_tpu_torch.utils import se3 as tse3
from better_fastlio2_tpu_torch.utils import so3 as tso3
from test_posegraph import _random_chain_loops_graph, drifted_square, mk_pose
from torch_threads import one_torch_thread  # noqa: F401


def _to_port(gj) -> tpg.PoseGraph:
    return convert.pose_graph_from_numpy(
        {k: np.asarray(v) for k, v in zip(gj._fields, gj)})


def _assert_graphs_equal(gt, gj):
    got = convert.tuple_to_numpy(gt)
    for k, v in zip(gj._fields, gj):
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def _tp(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _square_graph(robust=False, gps=False):
    """tests/test_posegraph.py's drifted square with its loop factor (and,
    optionally, Cauchy between factors and GPS fixes), built in JAX."""
    gt = drifted_square()
    n = len(gt)
    g = jpg.make_graph(max_poses=64, max_priors=4, max_between=128,
                       max_gps=8 if gps else 0, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    est = [mk_pose(gt[0][0], gt[0][1])]
    g = jpg.set_pose(g, 0, est[0])
    g = jpg.add_prior(g, 0, est[0], 1e-6, 1e-6)
    for k in range(1, n):
        odom = jse3.between(mk_pose(*gt[k - 1]), mk_pose(*gt[k]))
        noise = jse3.exp(jnp.asarray(np.concatenate(
            [rng.normal(0, 0.01, 3) + [0.01, 0, 0], rng.normal(0, 0.002, 3)])))
        odom_noisy = jse3.compose(odom, noise)
        est.append(jse3.compose(est[-1], odom_noisy))
        g = jpg.set_pose(g, k, est[-1])
        g = jpg.add_between(g, k - 1, k, odom_noisy, 1e-2, 1e-3,
                            robust=robust and k % 3 == 0)
    loop = jse3.between(mk_pose(*gt[0]), mk_pose(*gt[-1]))
    g = jpg.add_between(g, 0, n - 1, loop, 1e-3, 1e-4, robust=robust)
    if gps:
        for k in range(0, n, 6):
            g = jpg.add_gps(g, k, jnp.asarray(gt[k][1]), 0.05)
    return g, gt


def test_factor_adds_match_jax():
    rng = np.random.default_rng(1)
    gj = jpg.make_graph(6, 2, 4, max_gps=2, dtype=jnp.float64)
    gt = tpg.make_graph(6, 2, 4, max_gps=2, dtype=torch.float64)
    _assert_graphs_equal(gt, gj)
    poses = []
    for k in range(7):  # the last set_pose is past capacity: dropped
        q = rng.normal(size=4)
        p = np.concatenate([q / np.linalg.norm(q), rng.normal(size=3)])
        poses.append(p)
        gj = jpg.set_pose(gj, k, jnp.asarray(p))
        gt = tpg.set_pose(gt, k, _tp(p))
    for k in range(3):  # the third prior is dropped
        gj = jpg.add_prior(gj, k, jnp.asarray(poses[k]), 1e-3, 2e-3)
        gt = tpg.add_prior(gt, k, _tp(poses[k]), 1e-3, 2e-3)
    for k in range(5):  # the fifth between is dropped
        rel = jse3.between(jnp.asarray(poses[k]), jnp.asarray(poses[k + 1]))
        gj = jpg.add_between(gj, k, k + 1, rel, 0.1, 0.01, robust=k == 2)
        gt = tpg.add_between(gt, k, k + 1, _tp(rel), 0.1, 0.01,
                             robust=k == 2)
    for k in range(3):
        gj = jpg.add_gps(gj, k, jnp.asarray(poses[k][4:]), 0.5)
        gt = tpg.add_gps(gt, k, _tp(poses[k][4:]), 0.5)
    _assert_graphs_equal(gt, gj)
    allp = np.stack(poses[:4])
    gj = jpg.set_poses(gj, jnp.asarray(allp), 4)
    gt = tpg.set_poses(gt, _tp(allp), 4)
    _assert_graphs_equal(gt, gj)


def test_residuals_and_jacobians_match_jax():
    gj, _ = _square_graph()
    g = _to_port(gj)
    for a, b in zip(tpg._between_residual_jac(g.poses, g.bw_i, g.bw_j,
                                              g.bw_meas),
                    jpg._between_residual_jac(gj.poses, gj.bw_i, gj.bw_j,
                                              gj.bw_meas)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)
    for a, b in zip(tpg._prior_residual_jac(g.poses, g.prior_idx,
                                            g.prior_pose),
                    jpg._prior_residual_jac(gj.poses, gj.prior_idx,
                                            gj.prior_pose)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)


@pytest.mark.parametrize("robust,gps", [(False, False), (True, True)])
def test_optimize_matches_jax(robust, gps):
    gj, _ = _square_graph(robust, gps)
    oj = jpg.optimize(gj, iters=6, cg_iters=50)
    ot = tpg.optimize(_to_port(gj), iters=6, cg_iters=50)
    np.testing.assert_allclose(ot.poses.numpy(), np.asarray(oj.poses),
                               rtol=0, atol=1e-9)
    assert int(ot.n_poses) == int(oj.n_poses)


def test_marginals_match_jax():
    rng = np.random.default_rng(11)
    for K, n_loops in [(6, 0), (12, 3)]:
        gj = _random_chain_loops_graph(K, n_loops, rng, dtype=jnp.float64)
        g = _to_port(gj)
        dj = np.asarray(jpg.dense_marginals(gj, K))
        dt = tpg.dense_marginals(g, K).numpy()
        scale = np.abs(dj).max(axis=(1, 2), keepdims=True)
        assert np.all(np.abs(dt - dj) <= 1e-9 * scale)
        sj = jpg.selected_marginals(gj, K)
        st = tpg.selected_marginals(g, K)
        assert np.all(np.abs(st - sj) <= 1e-9 * scale)


# ---- behavioural assertions of tests/test_posegraph.py -------------------

def test_chain_with_loop_closes():
    gj, gt = _square_graph()
    g = _to_port(gj)
    n = len(gt)
    drift_before = float(np.linalg.norm(
        tse3.trans(g.poses[n - 1]).numpy() - gt[-1][1]))
    assert drift_before > 0.2
    g2 = tpg.optimize(g, iters=8, cg_iters=60)
    err_last = np.linalg.norm(tse3.trans(g2.poses[n - 1]).numpy() - gt[-1][1])
    assert err_last < 0.05, err_last
    mid = np.linalg.norm(tse3.trans(g2.poses[n // 2]).numpy() - gt[n // 2][1])
    assert mid <= drift_before


def _tmk(yaw, t):
    return tse3.make(tso3.quat_exp(_tp([0.0, 0.0, yaw])), _tp(t))


def test_prior_pins_pose():
    g = tpg.make_graph(8, 2, 8, dtype=torch.float64)
    g = tpg.set_pose(g, 0, tse3.identity(torch.float64))
    g = tpg.add_prior(g, 0, _tmk(0.3, [1.0, 2.0, 3.0]), 1e-4, 1e-4)
    g2 = tpg.optimize(g, iters=6, cg_iters=20)
    np.testing.assert_allclose(tse3.trans(g2.poses[0]).numpy(), [1, 2, 3],
                               atol=1e-5)
    assert abs(float(tso3.quat_log(tse3.rot(g2.poses[0]))[2]) - 0.3) < 1e-5


def test_between_residual_zero_at_truth():
    a, b = _tmk(0.4, [1.0, 0.0, 0.5]), _tmk(1.1, [2.0, 1.0, 0.5])
    e, _, _ = tpg._between_residual_jac(
        torch.stack([a, b]), torch.tensor([0]), torch.tensor([1]),
        tse3.between(a, b)[None])
    np.testing.assert_allclose(e.numpy(), 0.0, atol=1e-12)


def test_between_jacobians_match_autodiff():
    a, b = _tmk(0.4, [1.0, 0.0, 0.5]), _tmk(1.1, [2.0, 1.0, 0.5])
    meas = tse3.compose(tse3.between(a, b), tse3.exp(
        _tp([0.05, -0.03, 0.02, 0.01, 0.02, -0.04])))
    i0, i1 = torch.tensor([0]), torch.tensor([1])

    def res(d):
        di, dj = d[:6], d[6:]
        ap = tse3.make(tso3.quat_multiply(tse3.rot(a), tso3.quat_exp(di[3:6])),
                       tse3.trans(a) + di[0:3])
        bp = tse3.make(tso3.quat_multiply(tse3.rot(b), tso3.quat_exp(dj[3:6])),
                       tse3.trans(b) + dj[0:3])
        return tpg._between_residual_jac(torch.stack([ap, bp]), i0, i1,
                                         meas[None])[0][0]

    # quat_exp's small-angle branch at exactly 0 has the right derivative
    J = torch.autograd.functional.jacobian(
        res, torch.full((12,), 1e-9, dtype=torch.float64)).numpy()
    _, Ji, Jj = tpg._between_residual_jac(torch.stack([a, b]), i0, i1,
                                          meas[None])
    np.testing.assert_allclose(J[:3, :6], Ji[0, :3].numpy(), atol=1e-7)
    np.testing.assert_allclose(J[:3, 6:], Jj[0, :3].numpy(), atol=1e-7)
    np.testing.assert_allclose(J[3:, :6], Ji[0, 3:].numpy(), atol=0.05)
    np.testing.assert_allclose(J[3:, 6:], Jj[0, 3:].numpy(), atol=0.05)


def test_gps_factor_pins_translation():
    g = tpg.make_graph(16, 2, 32, max_gps=16, dtype=torch.float64)
    n = 8
    for k in range(n):
        g = tpg.set_pose(g, k, _tmk(0.0, [k * 1.0 + 0.3, 0.2, 0]))
        if k:
            g = tpg.add_between(g, k - 1, k, _tmk(0.0, [1.0, 0, 0]), 1e-1,
                                1e-3)
    for k in range(n):
        g = tpg.add_gps(g, k, _tp([k * 1.0, 0.0, 0.0]), 1e-2)
    g2 = tpg.optimize(g, iters=6, cg_iters=40)
    want = np.stack([np.arange(n), np.zeros(n), np.zeros(n)], 1)
    np.testing.assert_allclose(tse3.trans(g2.poses[:n]).numpy(), want,
                               atol=0.02)


def _chain_loops_graph(K, n_loops, rng, dtype=torch.float32):
    """tests/test_posegraph.py:_random_chain_loops_graph built by the port."""
    g = tpg.make_graph(K, 4, K + n_loops + 4, max_gps=4, dtype=dtype)
    yaw, pos = 0.0, np.zeros(3)
    for k in range(K):
        g = tpg.set_pose(g, k, _tmk(yaw, pos).to(dtype))
        yaw += rng.normal(scale=0.1)
        pos = pos + rng.normal(scale=[1.0, 0.3, 0.05], size=3)
    g = tpg.add_prior(g, 0, g.poses[0], 1e-3, 1e-3)
    for k in range(1, K):
        g = tpg.add_between(g, k - 1, k,
                            tse3.between(g.poses[k - 1], g.poses[k]),
                            0.1, 0.02)
    for _ in range(n_loops):
        i = int(rng.integers(0, K - 3))
        j = int(rng.integers(i + 2, K))
        g = tpg.add_between(g, i, j, tse3.between(g.poses[i], g.poses[j]),
                            0.3, 0.05)
    return tpg.add_gps(g, K // 2, tse3.trans(g.poses[K // 2]), 2.0)


def test_selected_marginals_equal_dense():
    rng = np.random.default_rng(11)
    for K, n_loops in [(6, 0), (12, 3), (24, 6)]:
        g = _chain_loops_graph(K, n_loops, rng)
        Sig_d = tpg.dense_marginals(g, K).numpy().astype(np.float64)
        Sig_s = tpg.selected_marginals(g, K)
        np.testing.assert_allclose(Sig_s, Sig_d, rtol=5e-3, atol=1e-6)


def test_selected_marginals_scales_to_2048():
    rng = np.random.default_rng(7)
    K = 2048
    g = _chain_loops_graph(K, 64, rng)
    t0 = time.perf_counter()
    Sig = tpg.selected_marginals(g, K)
    dt = time.perf_counter() - t0
    assert Sig.shape == (K, 6, 6) and np.all(np.isfinite(Sig))
    assert np.all(Sig[:, np.arange(6), np.arange(6)] > 0)
    assert dt < 60.0, dt
