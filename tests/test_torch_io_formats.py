"""The port's dataset loaders, preprocess handlers and scan timer against
the JAX package's (io/kitti.py, io/mulran.py, io/nclt.py,
io/preprocess.py, utils/timing.py; all host numpy on both sides, so the
outputs must be equal exactly), with the golden decode assertions of
tests/test_dataset_fixtures.py on the port's copies.  The fixtures are
that file's, written in each format's byte layout.  Last, the assertions
of tests/test_evaluate.py on the port's io/evaluate.py."""

import os
import struct

import numpy as np
import pytest

from better_fastlio2_tpu.io import kitti as jkitti
from better_fastlio2_tpu.io import mulran as jmulran
from better_fastlio2_tpu.io import nclt as jnclt
from better_fastlio2_tpu.io import preprocess as jpp
from better_fastlio2_tpu.utils import timing as jtiming
from better_fastlio2_tpu_torch import config as tcfg
from better_fastlio2_tpu_torch.io import evaluate as tev
from better_fastlio2_tpu_torch.io import kitti as tkitti
from better_fastlio2_tpu_torch.io import mulran as tmulran
from better_fastlio2_tpu_torch.io import nclt as tnclt
from better_fastlio2_tpu_torch.io import preprocess as tpp
from better_fastlio2_tpu_torch.utils import timing as ttiming
from test_dataset_fixtures import (make_kitti_fixture, make_mulran_fixture,
                                   nclt_pack)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _groups_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for ga, gb in zip(a, b):
        assert ga.keys() == gb.keys()
        for k in ga:
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
            assert np.asarray(ga[k]).dtype == np.asarray(gb[k]).dtype, k


def _nclt_fixture(root):
    os.makedirs(root / "velodyne_sync")
    xyz = np.array([[12.5, -3.125, 0.5], [0.25, 0.1, -0.05],
                    [-40.0, 7.5, 2.0]])
    utime0 = 1_357_847_000_000_000 // 1000  # microseconds
    p = root / "velodyne_sync" / f"{utime0}.bin"
    p.write_bytes(nclt_pack(xyz, [7, 8, 9], [0, 1, 2]))
    (root / "velodyne_sync" / f"{utime0 + 100_000}.bin").write_bytes(
        nclt_pack(xyz + 0.5, [7, 8, 9], [0, 1, 2]))
    with open(root / "ms25.csv", "w") as f:
        for k in range(25):
            t = utime0 - 20_000 + k * 10_000
            row = [t, 0.1, 0.2, 0.3, 1.5, 2.5, 9.5, 0.07, 0.08, 0.09]
            f.write(",".join(str(v) for v in row) + "\n")
    with open(root / "groundtruth_2013-01-10.csv", "w") as f:
        f.write(f"{utime0},1.0,2.0,3.0,0.0,0.0,0.0\n")
        f.write(f"{utime0 + 100_000},1.5,2.0,3.0,0.0,0.0,0.0\n")
    return p, xyz


# ---------------------------------------------------------------- KITTI
def test_kitti_decode(tmp_path):
    make_kitti_fixture(str(tmp_path))
    seq = tkitti.KittiRawSequence(str(tmp_path))
    assert len(seq) == 2
    xyz, inten, toff = seq.scan(0)
    np.testing.assert_allclose(xyz[0], [10.0, 0.0, -1.5])
    np.testing.assert_allclose(inten, [0.1, 0.2, 0.3, 0.4], atol=1e-7)
    assert abs(seq.velo_t[1] - seq.velo_t[0] - 0.1) < 1e-6
    gs = list(seq.groups(blind=1.0))
    g = gs[0]
    assert len(g["pts"]) == 3  # blind point removed
    np.testing.assert_allclose(g["imu_acc"][0], [1.1, 2.2, 9.7])
    np.testing.assert_allclose(g["imu_gyr"][0], [0.01, 0.02, 0.03])
    assert not np.allclose(g["imu_gyr"][0], [9.9, 9.9, 9.9])
    assert np.all(np.diff(g["imu_t"]) > 0)
    assert g["imu_t"][-1] <= g["scan_end_t"] + 1e-9
    # the JAX package's loader on the same directory, group for group
    jseq = jkitti.KittiRawSequence(str(tmp_path))
    np.testing.assert_array_equal(seq.velo_t, jseq.velo_t)
    np.testing.assert_array_equal(seq.oxts_t, jseq.oxts_t)
    for k in range(2):
        for a, b in zip(seq.scan(k), jseq.scan(k)):
            np.testing.assert_array_equal(a, b)
    for blind, pfn in ((1.0, 1), (0.3, 2)):
        _groups_equal(seq.groups(blind=blind, point_filter_num=pfn),
                      jseq.groups(blind=blind, point_filter_num=pfn))


def test_kitti_yaw_time_synthesis(tmp_path):
    make_kitti_fixture(str(tmp_path))
    seq = tkitti.KittiRawSequence(str(tmp_path), deskewed=False)
    xyz, _, toff = seq.scan(0)
    expect = tkitti.synthesize_velodyne_times(xyz)
    np.testing.assert_allclose(toff, expect)
    np.testing.assert_allclose(toff[0], 0.0, atol=1e-9)
    np.testing.assert_allclose(toff[2], 0.025, atol=1e-6)
    np.testing.assert_allclose(toff[3], 0.0625, atol=1e-6)
    np.testing.assert_array_equal(
        toff, jkitti.KittiRawSequence(str(tmp_path), deskewed=False)
        .scan(0)[2])
    pts = np.random.default_rng(0).normal(size=(500, 3)) * 20.0
    for period in (0.1, 0.05):
        np.testing.assert_array_equal(
            tkitti.synthesize_velodyne_times(pts, period),
            jkitti.synthesize_velodyne_times(pts, period))
    _groups_equal(
        seq.groups(), jkitti.KittiRawSequence(str(tmp_path),
                                              deskewed=False).groups())


# ---------------------------------------------------------------- MulRan
def test_mulran_decode(tmp_path):
    make_mulran_fixture(str(tmp_path))
    seq = tmulran.MulranSequence(str(tmp_path))
    assert len(seq) == 2
    xyz, inten = seq.scan(0)
    np.testing.assert_allclose(xyz[0], [5.0, 0.0, 0.0])
    np.testing.assert_allclose(inten, [10.0, 20.0, 30.0])
    g = list(seq.groups(blind=1.0))[0]
    np.testing.assert_allclose(g["imu_gyr"][0], [0.04, 0.05, 0.06])
    np.testing.assert_allclose(g["imu_acc"][0], [0.7, 0.8, 9.6])
    assert len(g["pts"]) == 2  # blind point culled
    t, poses = seq.ground_truth()
    np.testing.assert_allclose(poses[0][:, 3], [100.0, 200.0, 3.0])
    np.testing.assert_allclose(poses[1][:, 3], [101.0, 200.0, 3.0])
    assert abs(t[1] - t[0] - 0.1) < 1e-6
    jseq = jmulran.MulranSequence(str(tmp_path))
    for a, b in zip(seq.ground_truth(), jseq.ground_truth()):
        np.testing.assert_array_equal(a, b)
    for blind, pfn in ((1.0, 1), (0.1, 2)):
        _groups_equal(seq.groups(blind=blind, point_filter_num=pfn),
                      jseq.groups(blind=blind, point_filter_num=pfn))


# ----------------------------------------------------------------- NCLT
def test_nclt_decode(tmp_path):
    p, xyz = _nclt_fixture(tmp_path)
    dec, inten = tnclt.decode_nclt_bin(str(p))
    np.testing.assert_allclose(dec, xyz, atol=0.0051)  # 5 mm steps
    np.testing.assert_array_equal(inten, [7, 8, 9])
    for a, b in zip((dec, inten), jnclt.decode_nclt_bin(str(p))):
        np.testing.assert_array_equal(a, b)
    seq = tnclt.NcltSequence(str(tmp_path))
    assert len(seq) == 2
    g = list(seq.groups(blind=1.0))[0]
    np.testing.assert_allclose(g["imu_acc"][0], [1.5, 2.5, 9.5])
    np.testing.assert_allclose(g["imu_gyr"][0], [0.07, 0.08, 0.09])
    assert len(g["pts"]) == 2  # blind point culled
    t, gt = seq.ground_truth()
    np.testing.assert_allclose(gt[0, :3], [1.0, 2.0, 3.0])
    jseq = jnclt.NcltSequence(str(tmp_path))
    for a, b in zip(seq.ground_truth(), jseq.ground_truth()):
        np.testing.assert_array_equal(a, b)
    _groups_equal(seq.groups(blind=1.0), jseq.groups(blind=1.0))


def test_nclt_scaling_golden(tmp_path):
    """u16 20000 -> 0 m; 24600 -> 23.0 m; 0 -> -100 m."""
    path = tmp_path / "one.bin"
    path.write_bytes(struct.pack("<HHHBB", 20000, 24600, 0, 42, 1))
    xyz, inten = tnclt.decode_nclt_bin(str(path))
    np.testing.assert_allclose(xyz[0], [0.0, 23.0, -100.0], atol=1e-6)
    assert inten[0] == 42


# ------------------------------------------------------------- handlers
def test_handler_dispatch_honors_lidar_and_livox_type():
    """lidar_type / livox_type select the decode (Preprocess::process,
    preprocess.cpp:51-63 + config/hap_ros.yaml's livox_type split)."""
    cfg = tcfg.LIOConfig()
    assert tpp.handler_for(cfg.preprocess) is tpp.preprocess_livox
    cfg.preprocess.livox_type = 2
    assert tpp.handler_for(cfg.preprocess) is tpp.preprocess_livox_ros
    cfg.preprocess.lidar_type = 2
    assert tpp.handler_for(cfg.preprocess) is tpp.preprocess_velodyne
    cfg.preprocess.lidar_type = 3
    assert tpp.handler_for(cfg.preprocess) is tpp.preprocess_ouster
    cfg.preprocess.lidar_type = 4
    assert tpp.handler_for(cfg.preprocess) is tpp.preprocess_robosense
    cfg.preprocess.lidar_type = 7
    with pytest.raises(ValueError, match="lidar_type 7"):
        tpp.handler_for(cfg.preprocess)
    hap = tcfg.load_yaml(os.path.join(REPO, "configs", "hap_ros.yaml"))
    assert tpp.handler_for(hap.preprocess) is tpp.preprocess_livox_ros
    # every shipped config selects the same handler in both packages
    for name in sorted(os.listdir(os.path.join(REPO, "configs"))):
        if name.endswith(".yaml"):
            c = tcfg.load_yaml(os.path.join(REPO, "configs", name))
            assert (tpp.handler_for(c.preprocess).__name__
                    == jpp.handler_for(c.preprocess).__name__), name


def test_livox_ros_decode_gates():
    """livoxros_handler (preprocess.cpp:477-526): line/tag gates,
    duplicate suppression, blind cull, zero per-point time."""
    rng = np.random.default_rng(3)
    n = 500
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    pts[5] = pts[4]  # consecutive duplicate -> suppressed
    pts[10] = [0.5, 0.5, 0.5]  # inside blind radius
    tag = np.full(n, 0x10, np.uint8)
    tag[20:40] = 0x20  # bad return type
    line = np.zeros(n, np.int64)
    line[50:60] = 9  # beyond n_scans
    args = (pts, np.ones(n, np.float32), tag, line)
    p, t, i = tpp.preprocess_livox_ros(*args, n_scans=6, blind=4.0,
                                       point_filter_num=1)
    assert np.all(t == 0.0)
    assert len(p) <= n - 20 - 10 - 2  # tag + line + dup/blind culls
    assert np.all(np.linalg.norm(p, axis=1) > 4.0)
    for pfn in (1, 3):
        for a, b in zip(tpp.preprocess_livox_ros(*args, 6, 4.0, pfn),
                        jpp.preprocess_livox_ros(*args, 6, 4.0, pfn)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _raw_scan(seed, n=3000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    pts[:50] *= 0.01  # inside the blind radius
    pts[60, 1] = np.nan  # not finite
    pts[61, 2] = np.inf
    return rng, pts, rng.uniform(0, 255, n).astype(np.float32)


@pytest.mark.parametrize("handler", ["livox", "velodyne_stamped",
                                     "velodyne_yaw", "ouster", "robosense",
                                     "common"])
def test_handlers_match_jax(handler):
    """Each vendor handler equals the JAX package's on the same raw scan
    (finite filter, stride, blind cull, time normalisation), dtypes
    too."""
    rng, pts, inten = _raw_scan(11)
    n = len(pts)
    calls = {
        "livox": lambda m: m.preprocess_livox(
            pts, inten, rng.integers(0, 256, n).astype(np.uint8),
            rng.integers(0, 100_000_000, n), blind=2.0, point_filter_num=2),
        "velodyne_stamped": lambda m: m.preprocess_velodyne(
            pts, inten, rng.uniform(0, 1e5, n), time_unit=2, blind=2.0,
            point_filter_num=3),
        "velodyne_yaw": lambda m: m.preprocess_velodyne(
            pts, None, None, scan_rate=10.0, blind=1.0),
        "ouster": lambda m: m.preprocess_ouster(
            pts, inten, rng.integers(0, 100_000_000, n), blind=1.5),
        "robosense": lambda m: m.preprocess_robosense(
            pts, inten, 1.7e9 + rng.uniform(0, 0.1, n), blind=1.0,
            point_filter_num=2),
        "common": lambda m: m.preprocess_common(
            pts, rng.uniform(0, 0.1, n), None, 3.0, 4),
    }
    state = rng.bit_generator.state
    out_t = calls[handler](tpp)
    rng.bit_generator.state = state  # the same random fields for JAX
    out_j = calls[handler](jpp)
    assert len(out_t[0]) > 100
    assert np.all(np.isfinite(out_t[0]))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert tpp.TIME_UNIT_SCALE == jpp.TIME_UNIT_SCALE


# ---------------------------------------------------------------- timing
def test_scan_timer_csv_matches_jax(tmp_path, monkeypatch):
    """ScanTimer's fast_lio_time_log.csv (laserMapping.cpp:2562-2574): the
    same header and columns as the JAX package's for the same stages and
    counters, on a shared fake clock.  The port's trace_scan fills a
    scan's row, found by its stamp, from a traced result: incremental
    time from lio.insert, search time from lio.update, preprocess time
    from lio.imu + lio.fov_crop + lio.downsample, the tree sizes from the
    map's voxels and the claims, add point size from the claims."""
    clock = iter(np.arange(0, 1000, 0.0125))

    def fake():
        return float(next(clock))

    assert ttiming.CSV_HEADER == jtiming.CSV_HEADER
    paths = []
    for mod in (ttiming, jtiming):
        clock = iter(np.arange(0, 1000, 0.0125))
        monkeypatch.setattr(mod.time, "perf_counter", fake)
        timer = mod.ScanTimer()
        for k in range(5):
            timer.begin_scan(1.6e9 + 0.1 * k)
            with timer.stage("total_scan"):
                with timer.stage("preprocess"):
                    pass
            timer.count("scan_points", 1000 + k)
            timer.count("add_points", 10 * k)
            timer.end_scan()
        assert timer.mean("total", skip=1) > 0
        assert timer.scans_per_sec(skip=1) > 0
        paths.append(tmp_path / f"{mod.__name__}.csv")
        timer.write_csv(str(paths[-1]))
    rows = paths[0].read_text().splitlines()
    assert rows == paths[1].read_text().splitlines()
    assert len(rows) == 6 and rows[0] + "\n" == ttiming.CSV_HEADER
    assert all(len(r.split(",")) == 11 for r in rows)

    from better_fastlio2_tpu_torch.utils import trace as ttrace

    sites = tuple(ttrace.SpanSite(*s) for s in (
        ("lio.scan", -1, 0, 8), ("lio.imu", 0, 1, 2),
        ("lio.fov_crop", 0, 2, 3), ("lio.downsample", 0, 3, 4),
        ("lio.update", 0, 4, 5), ("lio.update.pass", 4, 6, 7),
        ("lio.insert", 0, 5, 9)))

    def traced(stamp, voxels, claims):
        """A traced result: the readout of a scan whose stages took 2.5,
        0.1, 0.4, 5.0 and 0.8 ms, its insert claiming `claims` voxels."""
        values = np.full(ttrace.TRACE_LEN, np.nan, np.float32)
        values[:3] = 0.0
        values[3:13] = [0, 10, 2510, 2610, 3010, 8010, 3020, 5000, 9000,
                        8810]
        values[3 + ttrace.STAMPS:-1] = 0
        values[3 + ttrace.STAMPS + ttrace.COUNTERS.index("map.claims")] = \
            claims
        return {"map_voxels": voxels, "trace": ttrace.ScanTrace(
            7, stamp, values, sites, {"lio.host.wait": (50, 9100)})}

    timer = ttiming.ScanTimer()
    for k in range(3):
        timer.begin_scan(1.6e9 + 0.1 * k)
        timer.count("scan_points", 1000 + k)
        timer.end_scan()
    timer.trace_scan(traced(1.6e9 + 0.1, 5200, 180))  # a result a scan late
    timer.trace_scan(traced(1.7e9, 1, 1))  # no such scan: nothing
    timer.write_csv(str(tmp_path / "traced.csv"))
    cols = [r.split(",") for r in
            (tmp_path / "traced.csv").read_text().splitlines()[1:]]
    assert cols[0][3:] == cols[2][3:] == ["0.00000000", "0.00000000", "0",
                                          "0.00000000", "0", "0", "0",
                                          "0.00000000"]
    assert cols[1][3:] == ["0.00080000", "0.00500000", "0", "0.00000000",
                           "5020", "5200", "180", "0.00300000"]


# ---- the evaluation harness (tests/test_evaluate.py on the port's copy;
# tests/test_torch_colorize.py::test_evaluate_matches_jax holds it
# against the JAX package's) ----------------------------------------------

def test_umeyama_recovers_rigid_transform(rng):
    pts = rng.normal(size=(100, 3))
    ang = 0.7
    R_true = np.array([[np.cos(ang), -np.sin(ang), 0],
                       [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    t_true = np.array([3.0, -1.0, 2.0])
    R, t, s = tev.umeyama_align(pts, pts @ R_true.T + t_true)
    np.testing.assert_allclose(R, R_true, atol=1e-9)
    np.testing.assert_allclose(t, t_true, atol=1e-9)
    assert s == 1.0


def test_ate_zero_after_alignment(rng):
    gt = np.cumsum(rng.normal(size=(50, 3)), axis=0)
    est = gt @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]).T + [5, 5, 0]
    assert tev.ate_rmse(est, gt, align=True) < 1e-9
    assert tev.ate_rmse(est, gt, align=False) > 1.0


def test_rpe_detects_scale_drift():
    gt = np.cumsum(np.tile([1.0, 0, 0], (50, 1)), axis=0)
    assert tev.rpe(gt * 1.1, gt, delta=10) > 0.5  # 10 % scale drift
    assert tev.rpe(gt, gt, delta=10) < 1e-12


def test_associate_nearest():
    t_gt = np.arange(0, 10, 0.1)
    t_est = t_gt[::2] + 0.01
    ei, gi = tev.associate(t_est, t_gt, max_dt=0.05)
    assert len(ei) == len(t_est)
    np.testing.assert_array_equal(gi, np.arange(0, 100, 2))
    ei2, _ = tev.associate(np.array([100.0]), t_gt)  # out of tolerance
    assert len(ei2) == 0


def test_pr_rr_f1():
    pred = np.array([1, 1, 1, 0, 0, 0], bool)
    gt = np.array([1, 1, 0, 1, 0, 0], bool)
    for v in tev.pr_rr_f1(pred, gt):
        assert abs(v - 2 / 3) < 1e-9
