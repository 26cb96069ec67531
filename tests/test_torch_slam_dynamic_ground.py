"""Port parity: SLAMPipeline with live dynamic removal on the port's own
ground mask, against the JAX package in f64 on the CPU
(tests/test_torch_slam_dynamic.py's comparison, with the ground mask
handed the other way).  A file of its own so that each stays near a
minute.
"""

from test_torch_slam_dynamic import run_parity
from torch_threads import one_torch_thread  # noqa: F401


def test_dynamic_slam_on_the_ports_ground_matches_jax(monkeypatch):
    """The port's pipeline on its own ground mask, end to end: the
    reference is handed the port's mask (held against its own outside the
    ill-posed patches), and every scan's removal mask and the trajectory
    match.  No labelled sequence lets both sides run their own masks: at
    2500-6000 returns a scan every scan tried had 155-277 points in
    ill-posed patches (a ground seed set of two returns), where the
    reference's plane is an arbitrary vector of a 2-D null space."""
    n_ill = run_parity(monkeypatch, "appearance", window=0, port_mask=True)
    assert min(n_ill) > 0

