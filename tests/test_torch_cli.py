"""The port's CLI (run.py) and session files on the CPU.

* Disk to session (mirrors tests/test_disk_e2e.py): a short synthetic
  sequence written in each dataset's byte layout (KITTI raw-sync, MulRan,
  NCLT), `run.py mapping --dataset <fmt>:<dir> --device cpu` through to a
  saved session, read back with SessionReader.
* The YAML-driven KITTI run (mirrors tests/test_config_e2e.py, `slow` as
  there).
* The session files (mirrors tests/test_session_io.py): PCD binary and
  ASCII, the native writer's PCD read back, SCD precision, g2o, KITTI pose
  rows and the writer/reader cycle, each byte for byte equal to the JAX
  package's files.
* The device rule: without a GPU and without --device the CLI raises.
* The mapping options the disk runs leave off: --dynamic (the report and
  the dumps), --gps with --loop, the yaml's camera block.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from better_fastlio2_tpu.io import pcd as jpcd
from better_fastlio2_tpu.io import session as jsession
from better_fastlio2_tpu_torch.io import native as tnative
from better_fastlio2_tpu_torch.io.pcd import read_pcd, write_pcd
from better_fastlio2_tpu_torch.io.session import (SessionReader,
                                                  SessionWriter,
                                                  kitti_pose_line, read_g2o,
                                                  read_scd, write_g2o,
                                                  write_scd)
from better_fastlio2_tpu_torch.io.synthetic import (Trajectory,
                                                    make_lio_sequence)
from better_fastlio2_tpu_torch.run import main as run_main
from chip_smoke import write_kitti_dir
from test_config_e2e import _make_kitti_sequence
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_T = 1_600_000_000.0  # epoch offset of the MulRan and NCLT stamps


def sequence():
    """tests/test_disk_e2e.py's near-stationary sequence."""
    return list(make_lio_sequence(
        duration=2.0, scan_rate=10.0, imu_rate=100.0, n_points=3000,
        seed=4, noise=0.004, traj=Trajectory(t_still=1.4, speed=0.5)))


def imu_stream(groups):
    """(t_abs, acc, gyr) with each sample once (groups share boundary
    samples)."""
    seen = {}
    for g in groups:
        for j, t in enumerate(g["imu_t"]):
            seen.setdefault(round(float(g["scan_beg_abs"] + t), 6),
                            (g["imu_acc"][j], g["imu_gyr"][j]))
    ts = sorted(seen)
    return (np.asarray(ts) + BASE_T, np.stack([seen[t][0] for t in ts]),
            np.stack([seen[t][1] for t in ts]))


def small_cfg_yaml(path, extra: str = ""):
    """tests/test_disk_e2e.py:_small_cfg_yaml, plus `extra` lines."""
    with open(path, "w") as f:
        f.write(
            "mapping:\n"
            "  det_range: 60.0\n"
            "  cube_len: 300.0\n"
            "  mappingSurfLeafSize: 0.5\n"
            "ikdtree:\n"
            "  max_iteration: 3\n"
            "  filter_size_map_min: 0.5\n"
            "shapes:\n"
            "  n_raw: 4096\n"
            "  n_ds: 2048\n"
            "  n_imu: 32\n"
            "  map_capacity_log2: 16\n"
            "  map_bucket: 4\n"
            "  map_max_probe: 8\n"
            "  knn_chunk: 2048\n" + extra)
    return str(path)


def write_mulran(root, groups):
    od = root / "sensor_data" / "Ouster"
    od.mkdir(parents=True)
    for g in groups:
        stamp_ns = int(round((BASE_T + g["scan_beg_abs"]) * 1e9))
        pts = np.zeros((len(g["pts"]), 4), np.float32)
        pts[:, :3] = g["pts"]
        pts.tofile(od / f"{stamp_ns}.bin")
    ts, acc, gyr = imu_stream(groups)
    with open(root / "sensor_data" / "xsens_imu.csv", "w") as f:
        for j, t in enumerate(ts):
            row = ([int(round(t * 1e9))] + [0.0] * 7 + list(gyr[j])
                   + list(acc[j]))
            f.write(",".join(str(v) for v in row) + "\n")
    with open(root / "global_pose.csv", "w") as f:
        for g in groups:
            stamp_ns = int(round((BASE_T + g["scan_beg_abs"]) * 1e9))
            P = np.hstack([np.eye(3), np.asarray(g["gt_pos"])[:, None]])
            f.write(",".join([str(stamp_ns)]
                             + [f"{v:.6f}" for v in P.reshape(-1)]) + "\n")


def write_nclt(root, groups):
    vd = root / "velodyne_sync"
    vd.mkdir(parents=True)
    for g in groups:
        utime = int(round((BASE_T + g["scan_beg_abs"]) * 1e6))
        xyz = np.asarray(g["pts"], np.float64)
        u16 = np.clip(np.round((xyz + 100.0) / 0.005), 0,
                      65535).astype("<u2")
        rec = np.zeros((len(xyz), 8), np.uint8)
        rec[:, :6] = u16.view(np.uint8).reshape(len(xyz), 6)
        rec.tofile(vd / f"{utime}.bin")
    ts, acc, gyr = imu_stream(groups)
    with open(root / "ms25.csv", "w") as f:
        for j, t in enumerate(ts):
            row = ([int(round(t * 1e6))] + [0.0] * 3 + list(acc[j])
                   + list(gyr[j]))
            f.write(",".join(str(v) for v in row) + "\n")
    with open(root / "groundtruth_seq.csv", "w") as f:
        for g in groups:
            utime = int(round((BASE_T + g["scan_beg_abs"]) * 1e6))
            f.write(",".join([str(utime)]
                             + [f"{v:.6f}" for v in g["gt_pos"]]
                             + ["0", "0", "0"]) + "\n")


def _run_and_check(tmp_path, spec):
    cfg = small_cfg_yaml(tmp_path / "cfg.yaml")
    out = str(tmp_path / "session")
    run_main(["mapping", "--dataset", spec, "--config", cfg, "--output",
              out, "--blind", "0.5", "--device", "cpu"])
    r = SessionReader(out)
    assert r.num_keyframes >= 1
    poses = np.asarray(r.poses)
    assert np.all(np.isfinite(poses))
    assert r.scd(0).shape == (20, 60)
    xyz, _ = r.cloud(0)
    assert len(xyz) > 100
    log = open(os.path.join(out, "fast_lio_time_log.csv")).readlines()
    assert len(log) == 1 + 20
    # the near-stationary sequence stays put
    assert np.linalg.norm(poses[:, 4:7] - poses[0, 4:7], axis=1).max() < 2.0


@pytest.mark.parametrize("fmt", ["kitti", "mulran", "nclt"])
def test_disk_to_session(tmp_path, fmt):
    groups = sequence()
    data = tmp_path / "data"
    if fmt == "kitti":
        write_kitti_dir(str(data), groups)
    else:
        {"mulran": write_mulran, "nclt": write_nclt}[fmt](data, groups)
    _run_and_check(tmp_path, f"{fmt}:{data}")


@pytest.mark.slow
def test_yaml_driven_kitti_run_writes_session(tmp_path):
    """configs/velodyne64_kitti.yaml alone drives the run (subprocess, as
    a user runs it)."""
    data, out = str(tmp_path / "kitti"), str(tmp_path / "session")
    _make_kitti_sequence(data)
    r = subprocess.run(
        [sys.executable, "-m", "better_fastlio2_tpu_torch.run", "mapping",
         "--dataset", f"kitti:{data}", "--config",
         os.path.join(REPO, "configs", "velodyne64_kitti.yaml"),
         "--output", out, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stderr[-3000:]
    for f in ["singlesession_posegraph.g2o", "trajectory.pcd",
              "transformations.pcd", "globalMap.pcd", "poses_kitti.txt",
              "fast_lio_time_log.csv"]:
        assert os.path.exists(os.path.join(out, f)), f
    assert len(os.listdir(os.path.join(out, "PCDs"))) >= 1
    assert os.path.isdir(os.path.join(out, "SCDs"))
    rows = np.atleast_2d(np.loadtxt(os.path.join(out, "poses_kitti.txt")))
    assert np.all(np.isfinite(rows))
    assert np.all(np.abs(rows[:, [3, 7, 11]]) < 2.0)


def test_cli_device_rule(tmp_path, capsys):
    """--device cpu runs the plain kernel versions; with neither a GPU nor
    --device the CLI raises before it reads anything."""
    argv = ["mapping", "--dataset", "synthetic", "--duration", "0.4",
            "--n-points", "500", "--config",
            small_cfg_yaml(tmp_path / "c.yaml")]
    run_main(argv + ["--device", "cpu"])
    assert '"scans": 4' in capsys.readouterr().out
    if torch.cuda.is_available():
        return
    for sub in (argv, ["multi_session", "--central", "a", "--query", "b",
                       "--output", "c"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_main(sub)


# ---- session files (tests/test_session_io.py) ---------------------------

def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def test_pcd_roundtrip_binary_and_ascii(rng, tmp_path):
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, 500).astype(np.float32)
    for binary in (True, False):
        p, pj = tmp_path / f"x_{binary}.pcd", tmp_path / f"j_{binary}.pcd"
        write_pcd(str(p), xyz, inten, binary=binary)
        jpcd.write_pcd(str(pj), xyz, inten, binary=binary)
        _same_bytes(p, pj)
        x2, i2 = read_pcd(str(p))
        np.testing.assert_allclose(x2, xyz, atol=1e-5)
        np.testing.assert_allclose(i2, inten, atol=1e-4)
        for a, b in zip((x2, i2), jpcd.read_pcd(str(p))):
            np.testing.assert_array_equal(a, b)


def test_native_pcd_cross_read(rng, tmp_path):
    """The C++ writer's PCD reads back through the numpy reader."""
    assert tnative.available()
    xyz = rng.normal(size=(200, 3)).astype(np.float32)
    p = str(tmp_path / "n.pcd")
    tnative.write_pcd_xyzi(p, xyz, None)
    x2, _ = read_pcd(p)
    np.testing.assert_array_equal(x2, xyz)


def test_scd_precision(rng, tmp_path):
    """SCD files carry 3 decimals (Scancontext.cpp:523)."""
    desc = rng.uniform(0, 8, size=(20, 60))
    p, pj = tmp_path / "000000.scd", tmp_path / "j.scd"
    write_scd(str(p), desc)
    jsession.write_scd(str(pj), desc)
    _same_bytes(p, pj)
    d2 = read_scd(str(p))
    assert d2.shape == (20, 60)
    np.testing.assert_allclose(d2, np.round(desc, 3), atol=5e-4)
    np.testing.assert_array_equal(d2, jsession.read_scd(str(p)))


def test_g2o_roundtrip(rng, tmp_path):
    poses = np.zeros((5, 7))
    poses[:, 0] = 1.0
    poses[:, 4:7] = rng.normal(size=(5, 3))
    edges = [(0, 1, poses[1]), (1, 2, poses[2]), (0, 4, poses[4])]
    p, pj = tmp_path / "g.g2o", tmp_path / "j.g2o"
    write_g2o(str(p), poses, edges)
    jsession.write_g2o(str(pj), poses, edges)
    _same_bytes(p, pj)
    lines = open(p).read().splitlines()
    assert lines[0].startswith("VERTEX_SE3:QUAT 0 ")
    assert any(ln.startswith("EDGE_SE3:QUAT 0 4 ") for ln in lines)
    p2, e2 = read_g2o(str(p))
    np.testing.assert_allclose(p2, poses, atol=1e-5)
    assert len(e2) == 3 and e2[2][0] == 0 and e2[2][1] == 4


def test_kitti_pose_line():
    R = np.eye(3)
    t = np.array([1.0, 2.0, 3.0])
    row = kitti_pose_line(R, t)
    vals = np.array([float(v) for v in row.split()])
    assert len(vals) == 12
    np.testing.assert_allclose(vals.reshape(3, 4)[:, 3], t)
    a = 0.3
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1.0]])
    assert kitti_pose_line(R, t) == jsession.kitti_pose_line(R, t)


def test_session_writer_reader_cycle(rng, tmp_path):
    """The port's session directory equals the JAX package's file for
    file, and reads back."""
    roots = []
    for W, name in ((SessionWriter, "t"), (jsession.SessionWriter, "j")):
        r = np.random.default_rng(7)
        root = str(tmp_path / name)
        w = W(root=root)
        for k in range(3):
            cloud = r.normal(size=(100, 3)).astype(np.float32)
            desc = r.uniform(0, 5, (20, 60))
            pose = np.array([1.0, 0, 0, 0, k * 1.0, 0, 0])
            w.add_keyframe(cloud, np.zeros(100), desc, pose)
            if k:
                w.add_edge(k - 1, k, np.array([1.0, 0, 0, 0, 1.0, 0, 0]))
        w.save()
        roots.append(root)
    files = sorted(os.path.relpath(os.path.join(d, f), roots[0])
                   for d, _, fs in os.walk(roots[0]) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), roots[1])
                           for d, _, fs in os.walk(roots[1]) for f in fs)
    for f in files:
        _same_bytes(os.path.join(roots[0], f), os.path.join(roots[1], f))
    r = SessionReader(roots[0])
    assert r.num_keyframes == 3
    assert len(r.edges) == 2
    xyz, _ = r.cloud(1)
    assert xyz.shape == (100, 3)
    assert r.scd(2).shape == (20, 60)
    gm, _ = r.global_map()
    assert len(gm) == 300
    assert os.path.exists(os.path.join(roots[0], "poses_kitti.txt"))


CAMERA_YAML = ("camera:\n"
               "  camera_en: true\n"
               "  camera_external: [0.0, -1.0, 0.0, 0.0, 0.0, 0.0, -1.0, 0.3,"
               " 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]\n"
               "  camera_internal: [516.23584, 0.0, 641.125888, 0.0, 0.0,"
               " 533.185608, 338.72537, 0.0, 0.0, 0.0, 1.0, 0.0]\n")


@pytest.mark.parametrize("option", ["dynamic", "gps_loop", "camera"])
def test_mapping_options_run(tmp_path, capsys, option):
    """The mapping options the disk runs leave off, on the CPU: --dynamic
    on the labelled outdoor world writes dynamic_report.json scored after
    the appearance test's 24 frames and the --dynamic-dump clouds;
    --gps --loop on MulRan (global_pose.csv fixes, the async back end and
    loop thread, closed at the end); the yaml's camera: block writes one
    colored PCD a keyframe (configs/hap_ros.yaml's camera)."""
    out = tmp_path / "out"
    argv = ["mapping", "--output", str(out), "--device", "cpu",
            "--config", small_cfg_yaml(tmp_path / "c.yaml",
                                       CAMERA_YAML if option == "camera"
                                       else "")]
    if option == "dynamic":
        argv += ["--dataset", "synthetic-outdoor", "--dynamic",
                 "--duration", "2.8", "--n-points", "3000",
                 "--dynamic-dump", str(tmp_path / "dump")]
    elif option == "gps_loop":
        write_mulran(tmp_path / "m", sequence())
        argv += ["--dataset", f"mulran:{tmp_path / 'm'}", "--gps",
                 "--gps-rate", "5", "--loop", "--blind", "0.5"]
    else:
        argv += ["--dataset", "synthetic", "--duration", "1.5",
                 "--n-points", "3000"]
    run_main(argv)
    summary = json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    r = SessionReader(str(out))
    assert r.num_keyframes == summary["keyframes"] >= 1
    assert np.all(np.isfinite(np.asarray(r.poses)))
    if option == "dynamic":
        rep = json.loads((out / "dynamic_report.json").read_text())
        assert rep["n_scans"] == 28 and rep["n_scans_scored"] == 28 - 24
        assert summary["dynamic_pr_rr_f1"] == [rep["precision"],
                                               rep["recall"], rep["f1"]]
        assert all(0.0 <= v <= 1.0 for v in summary["dynamic_pr_rr_f1"])
        assert any(f.endswith("_removed.pcd")
                   for f in os.listdir(tmp_path / "dump"))
    elif option == "gps_loop":
        assert summary["scans"] == 20 and summary["loops"] >= 0
    else:
        colored = sorted(os.listdir(out / "ColoredPCDs"))
        assert colored == [f"{k:06d}.pcd" for k in range(r.num_keyframes)]
