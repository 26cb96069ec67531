"""The metric arithmetic of the result line and of the per-layer
readers."""

import math

import pytest

from lio_bench import harness as H
from lio_bench import kernel_bytes as KB


def test_p95_is_nearest_rank_over_all_scans():
    vals = list(range(1, 101))  # 1..100 ms
    assert H.p95(vals) == 95
    assert H.p95([5.0]) == 5.0
    # one stall among 20 scans is the tail: 19 of 20 values are <= p95
    v = [10.0] * 19 + [80.0]
    assert H.p95(v) == 10.0
    v = [10.0] * 18 + [80.0, 90.0]
    assert H.p95(v) == 80.0
    with pytest.raises(H.BenchError):
        H.p95([])


def test_union_and_host_gap():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert H.union_seconds(iv) == pytest.approx(3.0)
    # the same calls: 12 ms and 10 ms of wall, 9 ms and 9 ms on the device
    assert H.host_gap_ms([0.012, 0.010], [0.009, 0.009]) == pytest.approx(2.0)
    with pytest.raises(H.BenchError):
        H.host_gap_ms([], [])
    with pytest.raises(H.BenchError):
        H.host_gap_ms([0.01], [])


def test_kernel_bytes():
    assert KB.k2_bytes(16384) == 41 * 16384 + 4 * 156
    assert KB.k2_bytes(16384, True) == 53 * 16384 + 4 * 156
    # 10 calls of 1 MB at 1 TB/s in 20 us: the bound is half the time
    assert KB.roofline_share(10 ** 6, 10, 2e-5, 1e12) == pytest.approx(50.0)
    assert KB.roofline_share(10 ** 6, 0, 1.0, 1e12) is None
    assert KB.roofline_share(10 ** 6, 3, 0.0, 1e12) is None


def _facts(**kw):
    f = {"scans": 10, "window_s": 0.4, "busy_s": 0.15,
         "gap_calls": ([0.02, 0.02], [0.015, 0.015]),
         "device_records": 58000, "passes": [2, 2, 3, 2],
         "by_name": {"void neq_cluster_kernel<16>(float)": [4e-5, 20],
                     "void hth_cluster_kernel<false>(x)": [8e-5, 40],
                     "elementwise": [0.1, 100]},
         "counters": {"fused_normal_eqs": 20, "fused_hth": 40},
         "shapes": {"n_ds": 10240, "solve_compact": 8192},
         "extrinsic": False,
         "peaks": {"hbm_bytes_per_s": 3.35e12}}
    f.update(kw)
    return f


def test_readers():
    f = _facts()
    r = {n: H.load_reader(n)(f) for n in (
        "host_gap_ms.scan", "device_busy_ms_per_scan",
        "launches_per_scan", "esikf_passes_per_scan", "roofline_share.k2")}
    assert r["host_gap_ms.scan"] == pytest.approx(5.0)
    assert r["device_busy_ms_per_scan"] == pytest.approx(15.0)
    assert r["launches_per_scan"] == pytest.approx(5800.0)
    assert r["esikf_passes_per_scan"] == pytest.approx(2.25)
    assert r["roofline_share.k2"] == pytest.approx(
        100 * KB.k2_bytes(10240) * 40 / 3.35e12 / 8e-5)
    # nothing to read: no share of a roofline, never 0
    assert H.load_reader("roofline_share.k2")(_facts(peaks=None)) is None
    assert H.load_reader("roofline_share.k2")(
        _facts(counters={"fused_normal_eqs": 0, "fused_hth": 0})) is None
    assert H.load_reader("esikf_passes_per_scan")(_facts(passes=[])) is None


def test_breakdown_names_gaps_by_host_work():
    f = _facts(intervals=[(0.0, 1.0), (3.0, 4.0), (4.5, 5.0)],
               host_events=[(0.5, 3.5, "lio_bench.feed"),
                            (1.5, 2.5, "aten::copy_")])
    b = H.breakdown(f)
    assert b["idle_gaps"][0] == ["aten::copy_", 2.0]
    assert b["idle_gaps"][1] == ["no host operation", 0.5]
    assert b["device_ops"][0][0] == "elementwise"
    assert len(b["device_ops"]) <= 10 and math.isfinite(b["device_ops"][0][1])
