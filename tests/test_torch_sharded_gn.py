"""The sharded pose-graph back end of the port (parallel/sharded.py:
sharded_posegraph_hvp, sharded_gn_step) on 2 gloo ranks on the CPU, in
f64, against the JAX package's 2-device functions and against the port's
one-process optimizer.

* H v and one GN step with the between factors split in two contiguous
  shards equal the JAX 2-device results within 1e-10 (the same sums: the
  port's sorted segment sums add each pose's lanes in lane order, as the
  reference's scatter-add, and the psum adds the two ranks' partials).
* Iterated on a consistent loop graph (measurements from true poses,
  poses 1.. perturbed by 0.2 m and 0.03 rad), the sharded GN reaches a
  solution of the graph, as backend.posegraph.optimize does on the same
  graph with a prior on pose 0: every factor's relative pose within 1e-6
  of its measurement.  (The reference's gauge prior holds pose 0 where
  it is at each step, without a residual, so the solution may drift by a
  gauge; the relative poses are what both fix.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.parallel import sharded as jsh

from better_fastlio2_tpu_torch.backend import posegraph as pg
from better_fastlio2_tpu_torch.utils import se3, so3
from torch_ranks import run_ranks, w_posegraph
from torch_threads import one_torch_thread  # noqa: F401

D = 2
K = 16
PRIOR_W = 1e4
CG_ITERS = 20  # past ~25 the CG residual is round-off and its steps noise
GN_STEPS, GN_CG_ITERS = 6, 60


def _graph():
    """True poses on a loop, a chain plus loop factors (2K, divisible by
    D) with measurements from the truth, perturbed initial poses."""
    rng = np.random.default_rng(11)
    ang = np.linspace(0.0, 2 * np.pi, K, endpoint=False)
    t = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0.1 * np.sin(3 * ang)],
                 1)
    q = so3.quat_exp(torch.as_tensor(
        np.stack([0.05 * np.sin(ang), 0.02 * np.cos(ang), ang + np.pi / 2],
                 1)))
    truth = se3.make(q, torch.as_tensor(t))
    bw_i = np.concatenate([np.arange(K), rng.integers(0, K, K)])
    bw_j = np.concatenate([(np.arange(K) + 1) % K,
                           (bw_i[K:] + rng.integers(2, K - 2, K)) % K])
    meas = se3.between(truth[torch.as_tensor(bw_i)],
                       truth[torch.as_tensor(bw_j)])
    w = np.tile([100.0, 100.0, 100.0, 400.0, 400.0, 400.0], (2 * K, 1))
    dq = so3.quat_exp(torch.as_tensor(rng.normal(size=(K, 3)) * 0.03))
    init = se3.make(so3.quat_multiply(q, dq),
                    torch.as_tensor(t + rng.normal(size=(K, 3)) * 0.2))
    init[0] = truth[0]
    return (truth.numpy(), init.numpy(), bw_i.astype(np.int32),
            bw_j.astype(np.int32), meas.numpy(), w)


@pytest.fixture(scope="module")
def runs():
    truth, init, bw_i, bw_j, meas, w = _graph()
    v = np.random.default_rng(2).normal(size=(K, 6))
    port = run_ranks(w_posegraph, D, init, bw_i, bw_j, meas, w, v, PRIOR_W,
                     CG_ITERS, GN_STEPS, GN_CG_ITERS)
    mesh = jsh.make_mesh(jax.devices("cpu")[:D])
    args = [jnp.asarray(a) for a in (init, bw_i, bw_j, meas, w)]
    hv = jax.jit(jsh.sharded_posegraph_hvp(mesh))(*args, jnp.asarray(v))
    one = jax.jit(jsh.sharded_gn_step(mesh, cg_iters=CG_ITERS))(
        *args, PRIOR_W)
    return (truth, init, bw_i, bw_j, meas), port, (np.asarray(hv),
                                                   np.asarray(one))


def test_sharded_hvp_and_gn_step_match_jax(runs):
    _, port, (hv_j, one_j) = runs
    for hv, one, _ in port:
        np.testing.assert_allclose(hv, hv_j, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(one, one_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(port[0][0], port[1][0])
    np.testing.assert_array_equal(port[0][2], port[1][2])


def test_sharded_gn_converges_with_optimize(runs):
    (truth, init, bw_i, bw_j, meas), port, _ = runs
    g = pg.make_graph(max_poses=K, max_priors=1, max_between=2 * K,
                      dtype=torch.float64, device="cpu")
    g = pg.set_poses(g, torch.as_tensor(init), K)
    g = pg.add_prior(g, 0, torch.as_tensor(truth[0]), 0.01, 0.01)
    for i, j, m in zip(bw_i, bw_j, meas):
        g = pg.add_between(g, int(i), int(j), torch.as_tensor(m), 0.1, 0.05)
    ref = pg.optimize(g, iters=8, cg_iters=80).poses[:K]
    got = torch.as_tensor(port[0][2])
    m = torch.as_tensor(meas)
    bi, bj = torch.as_tensor(bw_i).long(), torch.as_tensor(bw_j).long()
    for poses in (got, ref):
        e, _, _ = pg._between_residual_jac(poses, bi, bj, m)
        assert float(e.abs().max()) < 1e-6
        # the initial poses violate the factors: the solve moved them
    e0, _, _ = pg._between_residual_jac(torch.as_tensor(init), bi, bj, m)
    assert float(e0.abs().max()) > 0.1
