"""The benchmark's run of one cell: set-up, the measured window, the
bounded traced stretch, and the statistics of the result line.

A cell (BENCHMARK.json `workloads`) names a configuration
(configs/<config>.json, the program's settings as it runs them) and a
traffic mix (traffic/<traffic>.json, read by traffic/gen.py).  Each
per-layer metric is a reader of its own, metrics/<name>.py, over the
facts of the traced run (`stretch_facts`): the profiled stretch, the
untraced calls after it, and the trace records of the program's own
spans and counters (`span_ms` reads a span).  Nothing here names a
cell, a configuration or a metric: a later cell or metric is files and a
BENCHMARK.json entry.

The program is driven from its entry, `LIOPipeline.process_scan`, back
to back: the next scan goes in when the last call has returned, and
each call returns the scan's result.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "better_fastlio2_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result: the message goes to stderr, the
    exit code is not 0 and no result line is printed."""


# -- the cell --------------------------------------------------------------

def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def declared(bench: dict, cell: str, trace: bool) -> dict[str, str]:
    """{metric: unit} that a run of `cell` prints: the end-to-end metrics
    without a trace, the per-layer ones with it; a metric with a
    `workloads` list belongs to the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return {m["name"]: m["unit"] for m in group
            if "workloads" not in m or cell in m["workloads"]}


def load_config(name: str) -> dict:
    with open(HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def load_limits(cell: str) -> dict[str, float]:
    with open(HERE / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def load_reader(metric: str):
    """metrics/<metric>.py's `read(facts) -> float | None`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "lio_bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- statistics of the result line ------------------------------------------

def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of all values do not exceed."""
    v = sorted(values)
    if not v:
        raise BenchError("no samples for a percentile")
    return float(v[max(math.ceil(0.95 * len(v)) - 1, 0)])


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def host_gap_ms(call_s, device_s) -> float:
    """Milliseconds a call in which the device ran none of the call's
    work: over the same calls, the wall time of each call less the device
    time between the events around its copy and graph launch, averaged."""
    if not call_s or len(call_s) != len(device_s):
        raise BenchError("no calls for the host gap")
    return 1e3 * sum(c - d for c, d in zip(call_s, device_s)) / len(call_s)


def check_line(metrics: dict, want: dict[str, str]) -> None:
    """Every declared metric present, a finite number, with its unit; no
    other metric.  Raises BenchError naming the first fault."""
    for name, unit in want.items():
        m = metrics.get(name)
        if m is None:
            raise BenchError(f"metric {name} is missing from the result")
        v = m.get("value")
        if (not isinstance(v, (int, float)) or isinstance(v, bool)
                or not math.isfinite(v)):
            raise BenchError(f"metric {name} is not a finite number: {v!r}")
        if m.get("unit") != unit:
            raise BenchError(f"metric {name} has unit {m.get('unit')!r}, "
                             f"not {unit!r}")
    extra = sorted(set(metrics) - set(want))
    if extra:
        raise BenchError(f"metrics not declared for this run: {extra}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name only begins with the latter)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# -- state snapshots ----------------------------------------------------------

STATE = ("pos", "rot", "off_r", "off_t", "vel", "bg", "ba", "grav")
MAP = ("key", "count", "points")
BOX = ("cube_lo", "cube_hi", "cube_init", "last_acc_w", "last_gyr_b",
       "ekf_inited")


def snapshot(ls, device=None) -> dict:
    """A copy of the program's state (`LIOPipeline.ls`) as the check reads
    it: the filter state, the covariance, the local-map box, the IMU
    rates carried to the next scan, and the map's keys, counts and
    points; on its device and stream, or on `device`."""
    leaves = {k: getattr(ls.x, k) for k in STATE}
    leaves.update({k: getattr(ls.map, k) for k in MAP})
    leaves.update({k: getattr(ls, k) for k in BOX}, P=ls.P)
    return {k: (v.to(device, copy=True) if device is not None else v.clone())
            for k, v in leaves.items()}


def snapshot_bytes(snap: dict) -> int:
    return sum(v.numel() * v.element_size() for v in snap.values())


# -- the traced stretch ------------------------------------------------------

def _records(prof):
    """(device records, host records) of a finished profile as (start s,
    end s, name) triples, read from the raw kineto events (fast); device
    records are the kernels, copies and sets that ran on the card, not
    the ranges of record_function annotations."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s0 = e.start_ns() / 1e9
        rec = (s0, s0 + e.duration_ns() / 1e9, name)
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith("lio.")):
                dev.append(rec)
        else:
            host.append(rec)
    return dev, host


def stretch_facts(prof, window_s: float, scans: int, results: list,
                  counters: dict, cfg, card: str, gap_calls: tuple,
                  program_trace=()) -> dict:
    """What every traced run has, for the per-layer readers: the device
    records the profiler saw in the stretch (kernels, copies, sets), their
    union, the time by name, the ESIKF passes of the stretch's scans, the
    program's device counters of K1 and K2 launches, the configuration,
    the card's peaks; for the host gap, the wall and device seconds of
    each of the untraced calls that follow the stretch (the profiler
    slows the host); and `program_trace`, the program's own trace record
    of each call of its traced pipeline (utils/trace.ScanTrace: its spans
    and counters), which runs unprofiled after the window."""
    dev, host = _records(prof)
    iv = [(a, b) for a, b, _ in dev]
    by_name: dict[str, list] = {}
    for a, b, name in dev:
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += b - a
        rec[1] += 1
    return {
        "scans": scans, "window_s": window_s, "busy_s": union_seconds(iv),
        "device_records": len(dev), "by_name": by_name,
        "intervals": iv, "host_events": host,
        "gap_calls": gap_calls,
        "passes": [r["iters"] for r in results],
        "counters": counters, "shapes": cfg.shapes.__dict__,
        "extrinsic": bool(cfg.mapping.extrinsic_est_en),
        "peaks": peaks_of(card),
        "program_trace": list(program_trace),
    }


def span_ms(facts: dict, name: str) -> float | None:
    """Milliseconds a call of the program's spans called `name`: summed
    within each call's trace record, averaged over the calls; None where
    no call has such a span."""
    per, seen = [], False
    for rec in facts["program_trace"]:
        ms = 0.0
        for sp in rec.spans:
            if sp.name == name:
                ms += (sp.end_us - sp.start_us) * 1e-3
                seen = True
        per.append(ms)
    return sum(per) / len(per) if seen else None


def kernel_time(facts: dict, fragment: str) -> tuple[float, int]:
    """(seconds, records) of the device records whose name holds
    `fragment`."""
    rows = [v for k, v in facts["by_name"].items() if fragment in k]
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


def breakdown(facts: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps named by the innermost host operation open at their middle."""
    ops = sorted(((k, v[0]) for k, v in facts["by_name"].items()),
                 key=lambda kv: -kv[1])[:10]
    merged = []
    for s, e in sorted(facts["intervals"]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(merged, merged[1:])), reverse=True)[:10]
    host = facts["host_events"]
    out = []
    for length, mid in gaps:
        open_ = [(e - s, name) for s, e, name in host if s <= mid <= e]
        out.append([min(open_)[1] if open_ else "no host operation", length])
    return {"device_ops": [[k[:160], v] for k, v in ops], "idle_gaps": out}


def peaks_of(card: str) -> dict | None:
    with open(HERE / "peaks.json") as f:
        table = json.load(f)["cards"]
    return table.get(card)
