"""Port parity: SLAMPipeline with live dynamic removal in window mode
(W = 4, quantized, pipelined) against the JAX package, in f64 on the CPU,
in both tracking modes: tests/test_torch_slam_dynamic.py's comparison
(each scan's removal mask equal, the trajectory within 1e-6 m), with the
constant-velocity extrapolation over the pending windows and the open
window's scans.  A file of its own so that each stays near a minute.
"""

import pytest

from test_torch_slam_dynamic import run_parity
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", ["overlap", "appearance"])
def test_window_dynamic_slam_matches_jax(monkeypatch, mode):
    run_parity(monkeypatch, mode, window=4)
