"""The metric arithmetic of the result line and of the per-layer
readers, and a traced run of the harness on the CPU that prints every
metric its cell declares."""

import math
import time

import numpy as np
import pytest
import torch

from lio_bench import harness as H
from lio_bench import kernel_bytes as KB
from lio_bench import run

from .small import cfg_over, traffic_over


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


STAGE_READERS = {"stage_device_ms.imu": "lio.imu",
                 "stage_device_ms.crop": "lio.fov_crop",
                 "stage_device_ms.downsample": "lio.downsample",
                 "stage_device_ms.update": "lio.update",
                 "stage_device_ms.insert": "lio.insert"}
# a traced scan's layout: lio.scan, its five stages one after the other
# (one stamp a boundary), an ESIKF pass inside the update
SITES = (("lio.scan", -1, 0, 6), ("lio.imu", 0, 0, 1),
         ("lio.fov_crop", 0, 1, 2), ("lio.downsample", 0, 2, 3),
         ("lio.update", 0, 3, 4), ("lio.update.pass", 4, 3, 7),
         ("lio.insert", 0, 4, 5))


def _scan_trace(stamps_us: dict, scan: int = 1):
    """A trace record as the program's readout makes it: the stamps
    (slot -> us from the lio.scan start; the others absent), no counts,
    no launch mark, no host spans."""
    from better_fastlio2_tpu_torch.utils import trace as T

    v = np.full(T.TRACE_LEN, np.nan, np.float32)
    v[:3] = 0.0  # the first stamp at 0 on the device's clock
    v[3 + T.STAMPS:T.TRACE_LEN - 1] = 0.0
    for slot, us in stamps_us.items():
        v[3 + slot] = us
    return T.ScanTrace(scan, 0.0, v, tuple(T.SpanSite(*s) for s in SITES),
                       {})


def test_stage_readers_on_trace_records():
    a = {0: 0.0, 1: 80.0, 2: 350.0, 3: 770.0, 4: 5930.0, 5: 6750.0,
         6: 6785.0, 7: 2000.0}
    b = {0: 0.0, 1: 140.0, 2: 440.0, 3: 1770.0, 4: 8410.0, 5: 9530.0,
         6: 9568.0}  # its pass's end stamp absent: that span left out
    f = _facts(program_trace=[_scan_trace(a, 1), _scan_trace(b, 2)])
    want = {"lio.imu": (80 + 140) / 2e3, "lio.fov_crop": (270 + 300) / 2e3,
            "lio.downsample": (420 + 1330) / 2e3,
            "lio.update": (5160 + 6640) / 2e3,
            "lio.insert": (820 + 1120) / 2e3}
    for name, span in STAGE_READERS.items():
        assert H.load_reader(name)(f) == pytest.approx(want[span], rel=1e-6)
    # a span only some calls have: the others add 0
    assert H.span_ms(f, "lio.update.pass") == pytest.approx(0.615)
    assert H.span_ms(f, "lio.scan") == pytest.approx((6785 + 9568) / 2e3)
    # nothing to read: no traced call, or no call with the span
    for name in STAGE_READERS:
        assert H.load_reader(name)(_facts(program_trace=[])) is None
    none = {k: v for k, v in a.items() if k not in (1, 2)}
    assert H.load_reader("stage_device_ms.crop")(
        _facts(program_trace=[_scan_trace(none)])) is None


def test_traced_run_prints_every_declared_metric(monkeypatch):
    """A --trace 1 run of a cell on the CPU at small sizes: every per-layer
    metric the cell declares is in the line, a finite number, the stages
    read from the traced pipeline's own spans.  The CPU has no device
    records: K2's, its calls and the card's peaks are stood in, and the
    device's readings are zeros."""
    facts_of = H.stretch_facts

    def with_k2(*a, **k):
        f = facts_of(*a, **k)
        f["by_name"]["hth_cluster_kernel<true> (CPU stand-in)"] = [1e-3, 90]
        f["counters"]["fused_hth"] = 90
        f["peaks"] = H.peaks_of("NVIDIA H100 80GB HBM3")
        return f

    monkeypatch.setattr(H, "stretch_facts", with_k2)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        bench = H.load_benchmark()
        cell = "vlp16_room_scan"
        line = run.run_cell(bench, H.cell_of(bench, cell), 2 ** 31 + 11, 1.0,
                            True, time.perf_counter(), device="cpu",
                            cfg_over=cfg_over, traffic_over=traffic_over)
    finally:
        torch.set_num_threads(n)
    assert line["correct"], line["compared"]
    want = H.declared(bench, cell, True)
    assert set(STAGE_READERS) <= set(want)
    assert set(line["metrics"]) == set(want)
    for name, m in line["metrics"].items():
        assert math.isfinite(m["value"]) and m["unit"] == want[name]
    for name in STAGE_READERS:
        assert line["metrics"][name]["value"] > 0.0
    assert list(line)[-1] == "compared" and "breakdown" in line
