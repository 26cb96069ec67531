"""Two separately started processes joined through init_distributed over a
TCP coordinator (the multi-host path; mirrors tests/test_multihost.py)
against the same 2-rank program spawned by parallel/launch.py.

Each program runs twice on the CPU with gloo: as two processes started by
hand (`--process-id 0/1 --num-processes 2 --coordinator host:port`) and
as `--nprocs 2` (one command spawning both ranks).  The ownership-sharded
tick and the SPMD window pipeline give the same trajectories both ways
(within 1e-5 m, the mirror's bound; the runs are the same program on the
same inputs), and the filter moved.  The mirror is marked slow for its
compile times; these runs take a few seconds each, so these are not.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

from torch_ranks import REPO, _free_port, launch
from torch_threads import one_torch_thread  # noqa: F401

MODULE = "better_fastlio2_tpu_torch.parallel.launch"


def _by_hand(argv, out, timeout=300):
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", MODULE, "--process-id", str(pid),
         "--num-processes", "2", "--coordinator", coord, "--device", "cpu",
         "--out", str(out), *argv],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("program", [[], ["--spmd"]],
                         ids=["sharded_tick", "spmd_window"])
def test_two_processes_match_spawned(tmp_path, program):
    argv = [*program, "--n-scans", "20", "--dtype", "float32"]
    hand = _by_hand(argv, tmp_path / "hand.json")
    spawned = launch(["--nprocs", "2", "--device", "cpu", *argv],
                     tmp_path / "spawn.json")
    assert hand["world_size"] == spawned["world_size"] == 2
    t2 = np.asarray(hand["ranks"][0]["traj"])
    t1 = np.asarray(spawned["ranks"][0]["traj"])
    assert t2.shape == t1.shape == (19, 7)
    np.testing.assert_allclose(t2, t1, atol=1e-5)
    np.testing.assert_array_equal(t2, np.asarray(hand["ranks"][1]["traj"]))
    assert np.linalg.norm(t2[-1, :3] - t2[0, :3]) > 0.05
