"""The sync-free update of the fused solve (slice 4) on the CPU.

* The fused measure and update against the JAX package pass by pass in
  f64: lax.while_loop and lax.cond run eagerly under jax.disable_jit, so
  each executed pass's Gram and refresh flag are visible.  The port runs
  all max_iter + 1 passes; its first `iters` passes agree with the
  reference's passes within 1e-9 (f64 sums in another order), a prior
  0.3 m off makes the lazy refresh fire, and the results agree within
  1e-9.
* A steady scan of the bench configuration makes no port read: pipelined
  windows whose readbacks stay pending move utils.device.host_syncs by
  nothing; consuming a readback is its one read.
* to_host and readback_wait refuse to run while a CUDA graph is being
  captured.
"""

import numpy as np
import pytest
import torch

from better_fastlio2_tpu.core import esikf as jesikf
from better_fastlio2_tpu.core import measurement as jmeas
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.core import esikf as tesikf
from better_fastlio2_tpu_torch.core import measurement as tmeas
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from better_fastlio2_tpu_torch.utils import device as tdev
from test_torch_math import _t, _toy_problem_f64
from test_torch_pipeline_bench import bench_cfg
from test_torch_window import _args, _bench_groups
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp


def _pass_grams(measure, log):
    """measure, logging each concrete pass's Gram and refresh flag (the
    JAX package's shape-only trace of the measure is not a pass)."""
    def spy(x, conv, aux):
        m = measure(x, conv, aux)
        if not isinstance(m.gram, jax.core.Tracer):
            log.append((np.asarray(m.gram), np.asarray(m.aux.refreshed)))
        return m
    return spy


@pytest.mark.parametrize("early,compact", [(False, 0), (True, 0),
                                           (True, 1000)])
def test_sync_free_update_matches_jax_pass_by_pass(early, compact):
    mj, mt, scan, xj, xt, P0 = _toy_problem_f64()
    # a prior 0.3 m off, so that the lazy refresh fires
    xj = xj._replace(pos=xj.pos + jnp.asarray([0.3, -0.2, 0.1]))
    xt = xt._replace(pos=xt.pos + _t([0.3, -0.2, 0.1]))
    valid = np.ones(len(scan), bool)
    kw = dict(single_association=True, fused_solve=True,
              early_converge=early, solve_compact=compact)
    fj, aj = jmeas.make_measure_fn(mj, jnp.asarray(scan), jnp.asarray(valid),
                                   **kw)
    log_j, log_t = [], []
    with jax.disable_jit():
        xpj, Ppj, _, ij = jesikf.update_iterated(
            xj, jnp.asarray(P0), _pass_grams(fj, log_j), aj, max_iter=4,
            n_cols=6)
    ft, at = tmeas.make_measure_fn(mt, _t(scan), torch.as_tensor(valid),
                                   **kw)
    xpt, Ppt, _, it = tesikf.update_iterated(
        xt, _t(P0), _pass_grams(ft, log_t), at, max_iter=4, n_cols=6)
    n = int(ij["iters"])
    assert int(it["iters"]) == n and len(log_j) == n and len(log_t) == 5
    for (gj, rj), (gt, rt) in zip(log_j, log_t[:n]):
        np.testing.assert_allclose(gt, gj, rtol=1e-9, atol=1e-9)
        assert bool(rt) == bool(rj)
    assert any(bool(r) for _, r in log_j)  # the refresh fired
    assert int(it["t"]) == int(ij["t"])
    np.testing.assert_allclose(xpt.pos.numpy(), np.asarray(xpj.pos),
                               atol=1e-9)
    np.testing.assert_allclose(Ppt.numpy(), np.asarray(Ppj), atol=1e-9)


def test_steady_scan_makes_no_port_read():
    """Pipelined windows whose readbacks stay pending: a steady window's
    two scans move host_syncs by nothing; consuming its readback is the
    one read."""
    groups = _bench_groups()
    p = LIOPipeline(bench_cfg(tcfg, "float32"), device="cpu", window=2,
                    pipelined=True, readback_depth=100)
    for g in groups[:11]:
        p.process_scan(*_args(g))  # IMU init, 4 warmup windows, 1 steady
    assert p.ls.map.dmom is not None and p._step.sync_free
    tdev.host_syncs.reset()
    for g in groups[11:13]:  # one steady window
        p.process_scan(*_args(g))
    assert tdev.host_syncs.count == 0 and len(p._pending_ws) == 6
    assert p.poll() == 12 and tdev.host_syncs.count == 6


def test_host_reads_refuse_graph_capture(monkeypatch):
    t = torch.ones(3)
    rb = tdev.readback_async(t)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(tdev.HostReadInCapture, match="graph capture"):
        tdev.to_host(t)
    with pytest.raises(tdev.HostReadInCapture):
        tdev.readback_wait(rb)
