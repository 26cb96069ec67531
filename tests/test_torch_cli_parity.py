"""`run.py mapping` of the port against the JAX package's, on one KITTI
directory with a `dtype: float64` YAML (the port with --device cpu).

The directory holds a moving synthetic sequence whose clouds were moved
into their scan-end frames (chip_smoke.write_kitti_dir), so both
pipelines track it.  The state dumps (`pos_log.txt`, `mat_pre.txt`,
`mat_out.txt`) agree within 2e-6, the print precision (6 decimals); the
keyframe count is equal, the session's keyframe poses agree within one
printed step of the g2o file (1e-6), the keyframe clouds and descriptors
are the same bytes; the time log has the same header, rows, stamps and
point counts, and the port's map counts (from its step's trace; the JAX
package writes 0) add up; the summary lines agree but for the measured
rate."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from better_fastlio2_tpu.run import main as jax_main
from better_fastlio2_tpu_torch.io.session import SessionReader
from better_fastlio2_tpu_torch.io.synthetic import (Trajectory,
                                                    make_lio_sequence)
from better_fastlio2_tpu_torch.run import main as run_main
from chip_smoke import write_kitti_dir
from test_torch_cli import small_cfg_yaml
from torch_threads import one_torch_thread  # noqa: F401

TRAJ = Trajectory(t_still=0.5, speed=2.0)
F64_YAML = ("dtype: float64\n"
            "keyframeAddingDistThreshold: 1.0\n")


def moving_kitti(root):
    """20 scans, 1.5 s of them at 2 m/s, deskewed: a KITTI directory."""
    groups = list(make_lio_sequence(
        duration=2.0, scan_rate=10.0, imu_rate=100.0, n_points=3000,
        seed=3, noise=0.004, traj=TRAJ))
    write_kitti_dir(str(root), groups, TRAJ)
    return groups


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """Both packages' `mapping --state-log` over the same directory."""
    root = tmp_path_factory.mktemp("cli_parity")
    groups = moving_kitti(root / "kitti")
    cfg = small_cfg_yaml(root / "f64.yaml", F64_YAML)
    outs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", run_main, ["--device", "cpu"])):
        out = str(root / name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["mapping", "--dataset", f"kitti:{root / 'kitti'}",
                  "--config", cfg, "--output", out, "--state-log"] + extra)
        outs[name] = (out, last_json(buf.getvalue()))
    return groups, outs


def _rows(path):
    with open(path) as f:
        return [line.split() for line in f]


@pytest.mark.parametrize("log", ["pos_log.txt", "mat_pre.txt",
                                 "mat_out.txt"])
def test_state_logs_match_jax(mapped, log):
    groups, outs = mapped
    rj = _rows(os.path.join(outs["jax"][0], log))
    rt = _rows(os.path.join(outs["port"][0], log))
    assert len(rt) == len(rj) == len(groups) - 2  # init, one scan late
    assert [r[0] for r in rt] == [r[0] for r in rj]  # the stamps
    np.testing.assert_allclose(np.array(rt, float), np.array(rj, float),
                               rtol=0, atol=2e-6)
    if log == "pos_log.txt":  # both track: a row describes the scan before
        est = np.array(rt, float)[:, 1:4]
        gt = np.array([g["gt_pos"] for g in groups[1:-1]])
        err = np.linalg.norm((est - est[0]) - (gt - gt[0]), axis=1)
        assert err.max() < 0.05


def test_session_and_summary_match_jax(mapped):
    _, outs = mapped
    (dj, sj), (dt, st) = outs["jax"], outs["port"]
    assert st.pop("scans_per_sec") > 0 and sj.pop("scans_per_sec") > 0
    assert st == sj and st["keyframes"] >= 3
    rj, rt = SessionReader(dj), SessionReader(dt)
    assert rt.num_keyframes == rj.num_keyframes == st["keyframes"]
    # the g2o prints 6 decimals: within one printed step
    np.testing.assert_allclose(np.asarray(rt.poses), np.asarray(rj.poses),
                               rtol=0, atol=1.0001e-6)
    assert [e[:2] for e in rt.edges] == [e[:2] for e in rj.edges]
    for sub in ("PCDs", "SCDs"):
        names = sorted(os.listdir(os.path.join(dt, sub)))
        assert names == sorted(os.listdir(os.path.join(dj, sub)))
        for n in names:
            with open(os.path.join(dt, sub, n), "rb") as a, \
                    open(os.path.join(dj, sub, n), "rb") as b:
                assert a.read() == b.read(), (sub, n)
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))


def test_time_log_matches_jax(mapped):
    groups, outs = mapped
    tj = _rows(os.path.join(outs["jax"][0], "fast_lio_time_log.csv"))
    tt = _rows(os.path.join(outs["port"][0], "fast_lio_time_log.csv"))
    assert tt[0] == tj[0]  # the header
    assert len(tt) == len(tj) == 1 + len(groups)
    cols_t = [r[0].split(",") for r in tt[1:]]
    cols_j = [r[0].split(",") for r in tj[1:]]
    assert all(len(c) == 11 for c in cols_t + cols_j)
    # the stamp and the point and delete counts; the others are measured
    # times, and the map counts, which the JAX package leaves 0
    for k in (0, 2, 5):
        assert [c[k] for c in cols_t] == [c[k] for c in cols_j], k
    assert all(c[k] == "0" for c in cols_j for k in (7, 8, 9))
    # the port's map counts, from the step's trace (ScanTimer.trace_scan):
    # every scan with a result (the init scan has none, the last one's is
    # pending at the end) grows the map by the voxels it claims, and
    # without a crop one scan's map is the next one's start
    st, end, add = (np.array([int(c[k]) for c in cols_t[1:-1]])
                    for k in (7, 8, 9))
    assert np.all(end - st == add) and add[0] == end[0] > 0
    np.testing.assert_array_equal(st[1:], end[:-1])
    assert all(c[k] == "0" for c in (cols_t[0], cols_t[-1]) for k in (7, 8, 9))
