"""The run's check of its own result line, and BENCHMARK.json against
the files the harness finds by name."""

import json
import math

import pytest

from lio_bench import check, harness as H

BENCH = H.load_benchmark()


def _line(want, drop=None, value=1.0, unit=None):
    m = {k: {"value": value, "unit": unit or u} for k, u in want.items()}
    if drop:
        m.pop(drop)
    return m


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_every_declared_metric_is_checked(cell, trace):
    want = H.declared(BENCH, cell, trace)
    assert want
    H.check_line(_line(want), want)
    for name in want:
        with pytest.raises(H.BenchError, match=name.replace(".", r"\.")):
            H.check_line(_line(want, drop=name), want)
    for bad in (math.nan, math.inf, None, True, "1"):
        with pytest.raises(H.BenchError):
            H.check_line(_line(want, value=bad), want)
    with pytest.raises(H.BenchError):
        H.check_line(_line(want, unit="parsecs"), want)
    extra = dict(_line(want), stray={"value": 1.0, "unit": "ms"})
    with pytest.raises(H.BenchError):
        H.check_line(extra, want)


def test_cells_report_what_the_contract_asks():
    for w in BENCH["workloads"]:
        e2e = H.declared(BENCH, w["name"], False)
        per = H.declared(BENCH, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert per
        for m in BENCH["per_layer"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                assert m["moves"] in e2e


def test_files_found_by_name():
    for c in BENCH["configs"]:
        d = json.load(open(H.ROOT / c["file"]))
        assert d["name"] == c["name"] and d["reduced"] == c["reduced"]
        assert H.load_config(c["name"]) == d
    from lio_bench.traffic import gen
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        gen.load_spec(w["traffic"])
        limits = H.load_limits(w["name"])
        assert set(limits) <= set(check.NUMBERS) and "report_gap" in limits
        assert limits["report_gap"] == 0.0
    for m in BENCH["per_layer"]:
        assert callable(H.load_reader(m["name"]))
    assert H.peaks_of("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
