"""Port parity: apps/multi_session.py against the JAX package, in f64 on
the CPU.

* MultiSessionMerger on two sessions of the room world of
  tests/test_multisession.py (the query stored in an offset frame, both
  written once and read by both packages): the same SC and RS loop
  pairs, the same optimized poses (within 1e-8: Gauss-Newton with CG
  inner solves sits in between), the same query anchor, the same
  trajectory files and merged session;
* the information gain both ways (exact selected marginals, and the
  Jacobi marginals of _jacobi_marginals): the same RS targets and
  marginals.
The behavioural assertions of tests/test_multisession.py are in
tests/test_torch_app_behaviors.py.
"""

import os

import numpy as np
import pytest

from better_fastlio2_tpu.apps import multi_session as japp
from better_fastlio2_tpu_torch.apps import multi_session as tapp
from better_fastlio2_tpu_torch.io.session import SessionReader
from test_multisession import make_session, room_world, yaw_pose
from torch_threads import one_torch_thread  # noqa: F401


def _sessions(root, rng, n_c=5, n_q=4, world_n=12000,
              offset=yaw_pose(0.3, [4.0, -2.0, 0.0])):
    world = room_world(rng, n=world_n)
    central = [yaw_pose(0.0, [x, 0, 0]) for x in np.linspace(-8, 8, n_c)]
    query = [yaw_pose(0.1, [x, 3, 0]) for x in np.linspace(-6, 6, n_q)]
    cdir, qdir = os.path.join(root, "central"), os.path.join(root, "query")
    make_session(cdir, rng, world, central)
    make_session(qdir, rng, world, query, local_frame=offset)
    return world, central, query, cdir, qdir


def _read_rows(path):
    return np.loadtxt(path).reshape(-1, 12)


def test_merge_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    _, _, _, cdir, qdir = _sessions(str(tmp_path), rng, n_c=4, n_q=3,
                                    world_n=6000)
    cfg = dict(sc_dist_thresh=0.5, dtype="float64")
    mj = japp.MultiSessionMerger(cdir, qdir, japp.MultiSessionConfig(**cfg))
    mt = tapp.MultiSessionMerger(cdir, qdir, tapp.MultiSessionConfig(**cfg),
                                 device="cpu")
    sj, st = mj.run(), mt.run()
    assert st == sj and st["sc_loops"] + st["rs_loops"] >= 2
    assert mt.sc_pairs == mj.sc_pairs and mt.rs_pairs == mj.rs_pairs
    np.testing.assert_allclose(mt.graph.poses.numpy(),
                               np.asarray(mj.graph.poses), rtol=0, atol=1e-8)
    np.testing.assert_allclose(mt._poses_bfr, mj._poses_bfr, atol=1e-8)
    np.testing.assert_allclose(mt.query_anchor(), mj.query_anchor(),
                               atol=1e-8)
    oj, ot = str(tmp_path / "oj"), str(tmp_path / "ot")
    mj.write_outputs(oj)
    mt.write_outputs(ot)
    names = sorted(os.listdir(oj))
    assert sorted(os.listdir(ot)) == names
    for name in names:
        if name.endswith(".txt"):
            np.testing.assert_allclose(_read_rows(os.path.join(ot, name)),
                                       _read_rows(os.path.join(oj, name)),
                                       atol=2e-8)
    ej, et = str(tmp_path / "ej"), str(tmp_path / "et")
    mj.export_merged_session(ej)
    mt.export_merged_session(et)
    rj, rt = SessionReader(ej), SessionReader(et)
    np.testing.assert_allclose(rt.poses, rj.poses, atol=2e-6)  # %.6f text
    assert [e[:2] for e in rt.edges] == [e[:2] for e in rj.edges]


@pytest.mark.parametrize("exact", [True, False])
def test_rs_target_selection_matches_jax(tmp_path, exact):
    """RS candidates scored by information gain on the initial graph (all
    query keyframes as candidates, the radius widened so every central
    node is in reach)."""
    rng = np.random.default_rng(6)
    _, _, _, cdir, qdir = _sessions(str(tmp_path), rng, n_c=6, n_q=4,
                                    world_n=4000)
    cfg = dict(rs_search_radius=40.0, dtype="float64")
    mj = japp.MultiSessionMerger(cdir, qdir, japp.MultiSessionConfig(**cfg))
    mt = tapp.MultiSessionMerger(cdir, qdir, tapp.MultiSessionConfig(**cfg),
                                 device="cpu")
    mj.optimize()
    mt.optimize()
    cands = list(range(mt.nq))
    assert mt.select_rs_targets(cands, exact=exact) == \
        mj.select_rs_targets(cands, exact=exact)
    if not exact:
        np.testing.assert_allclose(mt._jacobi_marginals(),
                                   mj._jacobi_marginals(), rtol=1e-9,
                                   atol=1e-12)
