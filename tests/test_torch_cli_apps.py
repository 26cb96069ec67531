"""The port's `run.py online_relo` against the JAX package's, on a
session that the port's `mapping` wrote from a KITTI directory
(tests/test_torch_cli_parity.py's), with the port on --device cpu: the
JSON lines are equal, and relo_pose.txt's rows within 1e-4 (the port
relocalizes in float32 where the JAX package runs float64).
tests/test_torch_cli_merge.py holds `multi_session` and `object_update`
on the same session."""

import contextlib
import io
import os

import numpy as np
import pytest

from better_fastlio2_tpu.run import main as jax_main
from better_fastlio2_tpu_torch.run import main as run_main
from test_torch_cli import small_cfg_yaml
from test_torch_cli_parity import F64_YAML, last_json, moving_kitti
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_apps")
    moving_kitti(root / "kitti")
    cfg = small_cfg_yaml(root / "f64.yaml", F64_YAML)
    run_main(["mapping", "--dataset", f"kitti:{root / 'kitti'}", "--config",
              cfg, "--output", str(root / "S"), "--device", "cpu"])
    return root, cfg


def both(root, argv, out_flag="--output"):
    """The subcommand through both packages, each into its own output
    directory: {name: (JSON line, output dir)}."""
    res = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", run_main, ["--device", "cpu"])):
        out = str(root / f"{argv[0]}_{name}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv + [out_flag, out] + extra)
        res[name] = (last_json(buf.getvalue()), out)
    return res


def _files(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs)


def test_online_relo_matches_jax(session):
    root, cfg = session
    res = both(root, ["online_relo", "--prior", str(root / "S"),
                      "--dataset", f"kitti:{root / 'kitti'}", "--config",
                      cfg, "--max-scans", "8"])
    (jj, dj), (jt, dt) = res["jax"], res["port"]
    assert jt == jj
    assert jt["initialized"] and jt["relo_frames"] >= 1
    assert jt["frames"] == 8
    pj = np.loadtxt(os.path.join(dj, "relo_pose.txt"))
    pt = np.loadtxt(os.path.join(dt, "relo_pose.txt"))
    assert pt.shape == pj.shape == (8, 7)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
