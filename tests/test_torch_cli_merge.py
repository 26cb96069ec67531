"""The port's `run.py multi_session` and `object_update` against the JAX
package's, on a session that the port's `mapping` wrote from a KITTI
directory (tests/test_torch_cli_apps.py:session), merged with itself,
with the port on --device cpu: the JSON lines are equal, every query
keyframe closes a Scan Context loop with its twin, every query object is
fused with its own copy, and both write the same files."""

import os

from better_fastlio2_tpu_torch.io.session import SessionReader
from test_torch_cli_apps import _files, both, session  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_multi_session_matches_jax(session):
    root, _ = session
    s = str(root / "S")
    res = both(root, ["multi_session", "--central", s, "--query", s])
    (jj, dj), (jt, dt) = res["jax"], res["port"]
    n = SessionReader(s).num_keyframes
    assert jt == jj and jt["sc_loops"] == n
    assert _files(dt) == _files(dj)
    assert SessionReader(os.path.join(dt, "merged_session")).num_keyframes \
        == 2 * n


def test_object_update_matches_jax(session):
    root, _ = session
    s = str(root / "S")
    res = both(root, ["object_update", "--central", s, "--query", s])
    (jj, dj), (jt, dt) = res["jax"], res["port"]
    assert jt == jj
    assert jt["n_central_objects"] == jt["n_query_objects"] == jt["fused"]
    assert jt["new"] == jt["old"] == 0
    assert _files(dt) == _files(dj) == [f"objects_{k}.pcd" for k in
                                        ("fused", "new", "old")]
