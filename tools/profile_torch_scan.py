#!/usr/bin/env python3
"""Where a scan's time goes in the PyTorch/CUDA port, on one GPU.

    python tools/profile_torch_scan.py [--config {fused,row,row_ext,
                                        bench_room,bench_outdoor}]
                                       [--warmup 40] [--window 20]

Runs one main path of chip_smoke.py (LIOPipeline at the room bench shapes
on make_bench_sequence("room")): `fused` the single-association fused
solve (slice 1, K1), `row` the ESIKF row path with the reference
re-association (K2), `row_ext` the row path with extrinsic estimation,
`bench_room` / `bench_outdoor` the bench configuration of bench.py (slice
3, K1; the outdoor one on make_bench_sequence("outdoor")).  It runs
--warmup scans, then records --window steady scans under torch.profiler
(CPU and CUDA activities).  The bench configurations first record the
warmup program apart: scans 3-10 under the profiler and the syncs of
scans 11-15, all before the steady program starts at scan 17.  Prints the
card's name and power limit and one JSON line; a bench configuration's
line holds the fields below for the steady scans and, under `warmup`, for
the warmup program's:

  wall_ms_per_scan        host clock per scan (each scan ends in the info
                          readback, which waits for the device)
  device_busy_share       union of the device activity intervals over the
                          window's wall time (1 - idle share)
  device_ms_per_scan      summed device time of every kernel and copy
  launches_per_scan       device activities (kernels and copies) per scan
  stages                  per record_function span of the step (lio.*),
                          per scan: host_ms (the span on the host clock),
                          kernel_ms (device time of the activities it
                          launched), device_span_ms (first to last of those
                          on the device timeline) and launches_per_scan;
                          lio.update includes lio.associate and lio.refresh
  kernels                 for K1 (fused_normal_eqs: neq_cluster_kernel)
                          and K2 (fused_hth: hth_cluster_kernel), one
                          device kernel per call: calls per scan and
                          device microseconds per call
  top_kernels             the 15 largest device-time entries by name
  syncs_per_scan          over SYNC_SCANS further scans, unprofiled:
                          `port_reads`, the device->host reads the port
                          makes through utils.device.to_host; `torch`,
                          every synchronising call torch itself reports
                          under torch.cuda.set_sync_debug_mode("warn"); and
                          `sites`, those torch syncs per scan by the line
                          of the port that made them (the innermost frame
                          in better_fastlio2_tpu_torch/), largest first

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import traceback
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

SYNC_SCANS = 5  # unprofiled scans over which the syncs are counted
PORT = "better_fastlio2_tpu_torch"
# the bench configurations' warmup-program windows (sequence indices; the
# first group only initialises, group k runs the k-th step)
WARM_PROFILED = range(3, 11)
WARM_SYNCED = range(11, 16)
CONFIGS = {"fused": cs.room_config, "row": lambda: cs.row_config(False),
           "row_ext": lambda: cs.row_config(True),
           "bench_room": lambda: cs.bench_config("room"),
           "bench_outdoor": lambda: cs.bench_config("outdoor")}


def _dev_time(ev) -> float:
    """Device microseconds of a profiler event (name differs by version)."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    return 0.0


def _launches(ev) -> int:
    """Device activities launched inside a host event and its children."""
    return len(ev.kernels) + sum(_launches(c) for c in ev.cpu_children)


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_window(feed, groups) -> dict:
    """Feed `groups` under torch.profiler; the per-scan breakdown of the
    module docstring (without the syncs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for g in groups:
            feed(g)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    n = len(groups)
    events = prof.events()
    spans = [e for e in events if e.name.startswith("lio.")]
    # kineto reports each record_function range twice: as the host range
    # and as a device "user annotation" spanning its kernels; the latter
    # are not device activities of their own
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("lio.")]
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in dev)
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    stages: dict[str, dict] = {}
    for e in spans:
        st = stages.setdefault(e.name, {"host_ms": 0.0, "kernel_ms": 0.0,
                                        "device_span_ms": 0.0,
                                        "launches": 0, "calls": 0})
        if e.device_type == DeviceType.CUDA:
            st["device_span_ms"] += e.time_range.elapsed_us() / 1e3 / n
        else:
            st["host_ms"] += e.time_range.elapsed_us() / 1e3 / n
            st["kernel_ms"] += _dev_time(e) / 1e3 / n
            st["launches"] += _launches(e)
            st["calls"] += 1
    for st in stages.values():
        st["launches_per_scan"] = st.pop("launches") / n
        st["calls_per_scan"] = st.pop("calls") / n
    by_name: dict[str, list] = {}
    for e in dev:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    kern = {}
    for name, kernel in (("fused_normal_eqs", "neq_cluster_kernel"),
                         ("fused_hth", "hth_cluster_kernel")):
        rows = [v for k, v in by_name.items() if kernel in k]
        calls = sum(v[1] for v in rows)
        kern[name] = {"calls_per_scan": calls / n,
                      "device_us_per_call": (sum(v[0] for v in rows) / calls
                                             if calls else None)}
    return {
        "scans": n,
        "wall_ms_per_scan": 1e3 * wall_s / n,
        "device_busy_share": busy_us / (1e6 * wall_s),
        "device_ms_per_scan": dev_us / 1e3 / n,
        "launches_per_scan": len(dev) / n,
        "stages": stages,
        "kernels": kern,
        "top_kernels": [{"name": k[:120], "device_ms_per_scan": v[0] / 1e3 / n,
                         "per_scan": v[1] / n} for k, v in top],
    }


def count_syncs(feed, groups) -> dict:
    """Feed `groups` unprofiled and count the syncs per scan (`port_reads`,
    `torch`, `sites` of the module docstring)."""
    import torch

    from better_fastlio2_tpu_torch.utils.device import host_syncs

    sites: collections.Counter = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        # called while the syncing op is on the stack: name the port's
        # innermost frame (or torch's own line when the port has none)
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack() if PORT in f.filename]
        f = ours[-1] if ours else None
        where = (f"{f.filename[f.filename.rindex(PORT):]}:{f.lineno}"
                 if f else f"{filename}:{lineno}")
        sites[where] += 1

    host_syncs.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for g in groups:
                feed(g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = max(len(groups), 1)
    return {"scans": len(groups), "port_reads": host_syncs.count / n,
            "torch": sum(sites.values()) / n,
            "sites": {k: v / n for k, v in sites.most_common()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="fused")
    ap.add_argument("--warmup", type=int, default=40)
    ap.add_argument("--window", type=int, default=20)
    args = ap.parse_args()

    import torch

    from better_fastlio2_tpu_torch.io.synthetic import make_bench_sequence
    from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a GPU")
    bench = args.config.startswith("bench_")
    if bench and args.warmup <= cs.PLANE_CACHE_WARMUP:
        cs.fail(f"--warmup must pass the {cs.PLANE_CACHE_WARMUP} warmup-"
                "program scans")
    card = cs.card_line()
    groups = make_bench_sequence(
        "outdoor" if args.config == "bench_outdoor" else "room",
        args.warmup + args.window + SYNC_SCANS + 1)
    pipe = LIOPipeline(CONFIGS[args.config]())

    def feed(g):
        return pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"],
                                 g["imu_gyr"], g["imu_t"], g["scan_beg_abs"],
                                 g["scan_end_t"])

    done = 0
    warm = None
    if bench:
        for g in groups[:WARM_PROFILED.start]:
            feed(g)
        warm = profile_window(feed, groups[WARM_PROFILED.start:
                                           WARM_PROFILED.stop])
        warm["first_scan"] = WARM_PROFILED.start
        warm["syncs_per_scan"] = count_syncs(
            feed, groups[WARM_SYNCED.start:WARM_SYNCED.stop])
        done = WARM_SYNCED.stop
    for g in groups[done:args.warmup]:
        feed(g)
    torch.cuda.synchronize()
    out = {"config": args.config, "first_scan": args.warmup}
    out.update(profile_window(
        feed, groups[args.warmup:args.warmup + args.window]))
    out["syncs_per_scan"] = count_syncs(
        feed, groups[args.warmup + args.window:][:SYNC_SCANS])
    if warm is not None:
        out["warmup"] = warm
        out["dmom_built"] = pipe.ls.map.dmom is not None
    print(card, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
