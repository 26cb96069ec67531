#!/usr/bin/env python3
"""Where a scan's time goes in the PyTorch/CUDA port, on one GPU.

    python tools/profile_torch_scan.py [--config {fused,row,row_ext,
                                        bench_room,bench_outdoor}
                                        | --cell CELL [--seed N]]
                                       [--warmup 40] [--scans 32]
                                       [--calls 256] [--overhead S]
                                       [--window W]

Runs one program as users run it: LIOPipeline(cfg, trace=True), each scan
a replay of its program's one-tick CUDA graph, with the step's spans and
counters recorded inside the graph (utils/trace.py).  --config picks a
main path of chip_smoke.py on make_bench_sequence ("room", or "outdoor"
for bench_outdoor): `fused` the single-association fused solve (K1),
`row` the ESIKF row path with the reference re-association (K2),
`row_ext` the row path with extrinsic estimation, `bench_room` /
`bench_outdoor` the bench configuration of bench.py (K1; their 5-NN
warmup program is profiled apart, scans 3-10, under `warmup`).  --cell
runs a cell of the benchmark instead: its configuration and traffic
(lio_bench/configs, lio_bench/traffic) from --seed.

After --warmup scans it profiles --scans steady calls under torch.profiler
(`stretch`), then runs --calls calls with the profiler off (`replay`),
then counts the syncs of SYNC_SCANS more.  Prints the card's name and
power limit, one line on standard error per traced call of `replay`
(the `ms` fields below, of that call), and one JSON line:

  stretch                the profiled calls, from the device records the
                         profiler saw, each stamp's record named by its
                         slot (trace_stamp<k>):
    wall_ms_per_scan, device_busy_share, device_ms_per_scan,
    launches_per_scan    as their names say (records: kernels, copies,
                         sets, the stamps included)
    stamp_records_per_scan
    graph_idle_ms_per_scan  the lio.scan span bounded by its first and
                         last stamp's records, less the union of the
                         device records inside it, mean a scan
    stages               per stage of lio.scan (head, lio.imu, ...,
                         lio.insert, tail) and per ESIKF pass: the
                         stage's ms between its stamps' records, the
                         kernel ms and records that started in it (stamps
                         apart) and its idle ms, per scan
    clock_residual_us    after one offset, the largest distance between
                         a stamp and the start of its own record
                         (clock_residual_drift_us after an offset and a
                         drift, clock_drift_ppm)
    clock_offset_error_us  the program's own device-to-host offset (from
                         each scan's bracket) less that one offset
    kernels, top_kernels K1 / K2 / IMU stage calls and us a call; the 15
                         largest device-time entries by name
  replay                 the unprofiled calls, from their trace records:
    ms                   mean ms of the call's wall, the device's lio.scan
                         and its stages (lio.imu, lio.fov_crop,
                         lio.downsample, lio.update, lio.insert; head_tail
                         the rest of lio.scan; lio.associate and
                         lio.refresh summed over the passes), the device's
                         lio.launch (from the launch mark to the first
                         stamp), the host spans (lio.host.pack, .launch, .wait,
                         .record), and on the host clock the lio.scan
                         start after the launch began (launch_to_scan)
                         and the wait's end after the lio.scan end
                         (scan_to_wait_end)
    levels               the same means over the calls slower and faster
                         than the median wall (the program's two speeds:
                         which span carries the slow level)
    if_bodies_taken_per_scan  by IF node name, and `total`
    map_claims_per_scan, map_probe_rounds_per_scan, passes_per_scan,
    refresh_fires_per_scan
    kernel_launches_per_scan  each hand-written kernel's launches that ran
                         over the calls (device counters): the IMU stage
                         one a scan
  syncs_per_scan         over SYNC_SCANS further calls: `port_reads` (the
                         port's reads through utils.device), `torch`
                         (every sync torch reports under
                         set_sync_debug_mode("warn")) and `sites`, those
                         by the port's line that made them
  graph                  the steady graph's nodes (by type, K1 / K2 / the
                         IMU stage, conditional, their bodies, trace) and
                         capture time
  overhead               with --overhead S (and --cell): an untraced
                         pipeline and a traced one fed the same scans in
                         alternating blocks of 64 calls, S seconds each:
                         call ms p50 / p95 of each

--window W (> 1, bench configurations only, with --scans given) drives
the pipeline as bench.py does (pipelined, window W, quantized, unroll
min(W, 8); the step is not traced in window mode): after the window that
captures the steady step's CUDA graph, --scans steady scans (whole
windows of graph replays) under the profiler (`stretch` without stages)
and the syncs of two more windows.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import statistics
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

SYNC_SCANS = 5  # unprofiled scans over which the syncs are counted
PORT = "better_fastlio2_tpu_torch"
# the bench configurations' warmup-program scans (sequence indices; the
# first group only initialises, group k runs the k-th step)
WARM_PROFILED = range(3, 11)
WARM_SYNCED = range(11, 16)
CONFIGS = {"fused": cs.room_config, "row": lambda: cs.row_config(False),
           "row_ext": lambda: cs.row_config(True),
           "bench_room": lambda: cs.bench_config("room"),
           "bench_outdoor": lambda: cs.bench_config("outdoor")}
STAGES = ("lio.imu", "lio.fov_crop", "lio.downsample", "lio.update",
          "lio.insert")
STAMP = re.compile(r"trace_stamp<(\d+)>")
OVERHEAD_BLOCK = 64


def _union(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _device_records(prof) -> list[tuple[int, int, str]]:
    """The kernels, copies and sets the profiler saw on the card, as
    (start ns, end ns, name), in start order."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        if e.name().startswith("lio."):
            continue
        s = e.start_ns()
        out.append((s, s + e.duration_ns(), e.name()))
    out.sort()
    return out


def _scan_windows(dev, recs):
    """Each profiled scan's device records, split at its lio.scan stamp
    (slot 0), paired with the scan's trace record; raises when the
    stamps' records and the records of the calls disagree."""
    starts = [i for i, r in enumerate(dev)
              if (m := STAMP.search(r[2])) and m.group(1) == "0"]
    if len(starts) != len(recs):
        raise RuntimeError(f"{len(starts)} lio.scan stamp records for "
                           f"{len(recs)} traced calls")
    bounds = starts + [len(dev)]
    return [(dev[a:b], rec) for a, b, rec in zip(bounds, bounds[1:], recs)]


def _stretch_stages(windows, realtime: int) -> dict:
    """The per-stage attribution, graph idle and clock residual of the
    profiled scans (the module docstring's `stretch`)."""
    stages: dict[str, dict] = collections.defaultdict(
        lambda: {"span_ms": 0.0, "kernel_ms": 0.0, "records": 0,
                 "idle_ms": 0.0})
    idle_ms, stamps, pairs, offsets = [], 0, [], []
    for recs, rec in windows:
        marks = {}  # slot -> (start, end) of its stamp's record
        work = []
        for s, e, name in recs:
            m = STAMP.search(name)
            if m:
                marks.setdefault(int(m.group(1)), (s, e))
            else:
                work.append((s, e))
        stamps += len(marks)
        for slot, (s, _) in marks.items():
            v = float(rec.stamp_us[slot])
            if v == v:  # present
                pairs.append((s, s - (rec.device_t0_ns + round(v * 1e3))))
        offsets.append(rec.clock_offset_ns)
        last = max(e for _, e in marks.values())
        first = marks[0][0]
        idle_ms.append((last - first - _union(
            [(max(s, first), min(e, last)) for s, e, _ in recs
             if e > first and s < last])) * 1e-6)
        sites = rec.sites
        top = [s for s in sites if s.parent == 0]
        parts = [("head", sites[0].start, top[0].start)]
        parts += [(s.name, s.start, s.end) for s in top]
        parts += [("tail", top[-1].end, sites[0].end)]
        parts += [(f"pass{i}", s.start, s.end) for i, s in enumerate(
            x for x in sites if x.name == "lio.update.pass")]
        for name, a, b in parts:
            if a not in marks or b not in marks:
                continue
            lo, hi = marks[a][0], marks[b][0]
            inside = [(max(s, lo), min(e, hi)) for s, e in work
                      if lo <= s < hi]
            st = stages[name]
            st["span_ms"] += (hi - lo) * 1e-6
            st["kernel_ms"] += sum(e - s for s, e in inside) * 1e-6
            st["records"] += len(inside)
            st["idle_ms"] += (hi - lo - _union(inside)) * 1e-6
    n = len(windows)
    t = np.array([p[0] for p in pairs], np.float64)
    d = np.array([p[1] for p in pairs], np.float64)
    off = float(np.median(d))
    rate, icpt = np.polyfit(t - t[0], d, 1)
    return {
        "graph_idle_ms_per_scan": sum(idle_ms) / n,
        "graph_idle_ms": idle_ms,
        "stamp_records_per_scan": stamps / n,
        "clock_residual_us": float(np.max(np.abs(d - off))) * 1e-3,
        # the residual left by one offset and a drift, and the drift
        "clock_residual_drift_us": float(np.max(np.abs(
            d - icpt - rate * (t - t[0])))) * 1e-3,
        "clock_drift_ppm": float(rate) * 1e6,
        # the profiler's clock is the host's realtime clock: how far the
        # program's own offset (Clock, from the brackets; to
        # perf_counter_ns) lies from that one offset
        "clock_offset_error_us": (statistics.median(offsets) + realtime
                                  - off) * 1e-3,
        "stages": {k: {f: v / n for f, v in st.items()}
                   for k, st in stages.items()},
    }


def profile_stretch(feed, groups, traced: bool) -> dict:
    """Feed `groups` under torch.profiler: the stretch's device totals,
    and with `traced` the per-stage attribution by the stamps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = [feed(g) for g in groups]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # the profiler's records are on the realtime clock, the program's host
    # spans on perf_counter_ns
    realtime = time.time_ns() - time.perf_counter_ns()
    dev = _device_records(prof)
    n = len(groups)
    by_name: dict[str, list] = {}
    for s, e, name in dev:
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += (e - s) * 1e-3
        rec[1] += 1
    kern = {}
    for name, kernel in (("fused_normal_eqs", "neq_cluster_kernel"),
                         ("fused_hth", "hth_cluster_kernel"),
                         ("imu_stage", "imu_stage_kernel")):
        rows = [v for k, v in by_name.items() if kernel in k]
        calls = sum(v[1] for v in rows)
        kern[name] = {"calls_per_scan": calls / n,
                      "device_us_per_call": (sum(v[0] for v in rows) / calls
                                             if calls else None)}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out = {
        "scans": n,
        "wall_ms_per_scan": 1e3 * wall_s / n,
        "device_busy_share": _union((s, e) for s, e, _ in dev) * 1e-9
        / wall_s,
        "device_ms_per_scan": sum(e - s for s, e, _ in dev) * 1e-6 / n,
        "launches_per_scan": len(dev) / n,
        "kernels": kern,
        "top_kernels": [{"name": k[:120], "device_ms_per_scan": v[0] / 1e3 / n,
                         "per_scan": v[1] / n} for k, v in top],
    }
    if traced:
        out.update(_stretch_stages(_scan_windows(
            dev, [o["trace"] for o in outs if o is not None]), realtime))
    return out


HOST = ("lio.host.pack", "lio.host.launch", "lio.host.wait",
        "lio.host.record")


def _call_row(rec: dict, wall_ms: float) -> dict:
    """One traced call's ms: its wall, lio.scan and its stages, the
    device's lio.launch, the host spans, and on the host clock the
    lio.scan start after the launch began and the wait's end after the
    lio.scan end."""
    sp = {s.name: s for s in rec.spans}
    row = {"call": rec.scan, "wall": wall_ms}
    row.update(rec.stage_ms(("lio.scan", *STAGES, "lio.associate",
                             "lio.refresh", "lio.launch", *HOST)))
    row["launch_to_scan"] = -1e-3 * sp["lio.host.launch"].start_us
    row["scan_to_wait_end"] = 1e-3 * (sp["lio.host.wait"].end_us
                                      - sp["lio.scan"].end_us)
    return row


def _means(rows) -> dict:
    n = max(len(rows), 1)
    out = {k: sum(r[k] for r in rows) / n for k in rows[0] if k != "call"}
    out["head_tail"] = out["lio.scan"] - sum(out[k] for k in STAGES)
    return out


def replay_calls(feed, groups) -> dict:
    """Feed `groups` with the profiler off: the means of their trace
    records (the module docstring's `replay`), a `call` line each on
    standard error."""
    rows, outs = [], []
    for g in groups:
        t0 = time.perf_counter()
        o = feed(g)
        wall = 1e3 * (time.perf_counter() - t0)
        if o is not None:
            outs.append(o)
            rows.append(_call_row(o["trace"], wall))
            print(json.dumps({k: round(v, 4) for k, v in rows[-1].items()}),
                  file=sys.stderr)
    n = max(len(rows), 1)
    recs = [o["trace"] for o in outs]
    med = statistics.median(r["wall"] for r in rows)
    counts = [r.counters for r in recs]
    ifs = {k: sum(c[k] for c in counts) / n
           for k in counts[0] if not k.startswith("map.")}
    ifs["total"] = sum(ifs.values())
    return {
        "scans": len(rows),
        "ms": _means(rows),
        "levels": {"slow": _means([r for r in rows if r["wall"] > med]),
                   "fast": _means([r for r in rows if r["wall"] <= med])},
        "if_bodies_taken_per_scan": ifs,
        "map_claims_per_scan": sum(c["map.claims"] for c in counts) / n,
        "map_probe_rounds_per_scan": sum(c["map.probe_rounds"]
                                         for c in counts) / n,
        "passes_per_scan": sum(o["iters"] for o in outs) / n,
        "refresh_fires_per_scan": sum(o["refreshed"] for o in outs) / n,
    }


def count_syncs(feed, groups) -> dict:
    """Feed `groups` unprofiled and count the syncs per scan (`port_reads`,
    `torch`, `sites` of the module docstring)."""
    import torch

    from better_fastlio2_tpu_torch.utils.device import host_syncs

    sites: collections.Counter = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        # called while the syncing op is on the stack: name the port's
        # innermost frame (or torch's own line when the port has none);
        # torch's "prototype feature" warning of set_sync_debug_mode is
        # not a sync
        if "called a synchronizing" not in str(message):
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


def _feeder(pipe):
    def feed(g):
        return pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"],
                                 g["imu_gyr"], g["imu_t"], g["scan_beg_abs"],
                                 g["scan_end_t"])
    return feed


def _graph(pipe) -> dict:
    g = pipe.graph
    return {"of": pipe._graph_of, "steps": g.steps,
            "capture_s": g.capture_s, **g.nodes,
            "captured_launches": g.captured_launches}


def per_scan(pipe, group, warmup: int, scans: int, calls: int,
             bench: bool) -> dict:
    """The per-scan breakdown of the module docstring on `pipe` (traced)
    fed `group(i)`: the bench configurations' warmup program apart
    (`warmup`), then the steady calls from scan --warmup on."""
    import torch

    feed = _feeder(pipe)
    done = 0
    out = {"first_scan": warmup}
    if bench:
        for i in range(WARM_PROFILED.start):
            feed(group(i))
        warm = profile_stretch(feed, [group(i) for i in WARM_PROFILED], True)
        warm["first_scan"] = WARM_PROFILED.start
        warm["syncs_per_scan"] = count_syncs(
            feed, [group(i) for i in WARM_SYNCED])
        done = WARM_SYNCED.stop
        out["warmup"] = warm
    for i in range(done, warmup):
        feed(group(i))
    torch.cuda.synchronize()
    k = warmup
    out["stretch"] = profile_stretch(feed, [group(i) for i in
                                            range(k, k + scans)], True)
    k += scans
    ran0 = cs.launches_ran()
    out["replay"] = replay_calls(feed, [group(i) for i in
                                        range(k, k + calls)])
    out["replay"]["kernel_launches_per_scan"] = {
        name: (v - ran0[name]) / max(calls, 1)
        for name, v in cs.launches_ran().items()}
    k += calls
    out["syncs_per_scan"] = count_syncs(
        feed, [group(i) for i in range(k, k + SYNC_SCANS)])
    out["graph"] = _graph(pipe)
    if bench:
        out["dmom_built"] = pipe.ls.map.dmom is not None
    return out


def overhead(make, group, start: int, seconds: float) -> dict:
    """Call ms of an untraced and a traced pipeline (`make(trace)`) fed
    the same scans, in alternating blocks of OVERHEAD_BLOCK calls, until
    each has run `seconds`."""
    pipes = {False: make(False), True: make(True)}
    feeds = {k: _feeder(p) for k, p in pipes.items()}
    for k in pipes:
        for i in range(start):
            feeds[k](group(i))
    lat = {False: [], True: []}
    spent = {False: 0.0, True: 0.0}
    i = start
    while min(spent.values()) < seconds:
        for k in (False, True):
            for j in range(OVERHEAD_BLOCK):
                g = group(i + j)
                t0 = time.perf_counter()
                feeds[k](g)
                dt = time.perf_counter() - t0
                lat[k].append(1e3 * dt)
                spent[k] += dt
        i += OVERHEAD_BLOCK

    def q(v, p):
        v = sorted(v)
        return v[max(-(-len(v) * p // 100) - 1, 0)]

    return {("on" if k else "off"): {"calls": len(v), "p50_ms": q(v, 50),
                                     "p95_ms": q(v, 95)}
            for k, v in lat.items()}


def profile_windowed(pipe, group, scans: int) -> dict:
    """The --window breakdown of the module docstring."""
    import torch

    feed = _feeder(pipe)
    W = pipe.window
    n_warm = -(-cs.PLANE_CACHE_WARMUP // W)  # warmup windows (rounded up)
    cap_end = 1 + (n_warm + 1) * W  # the window after warmup captures
    for i in range(cap_end):
        feed(group(i))
    torch.cuda.synchronize()
    n = max(1, scans // W) * W
    out = {"window": W, "first_scan": cap_end}
    out["stretch"] = profile_stretch(
        feed, [group(i) for i in range(cap_end, cap_end + n)], False)
    out["syncs_per_scan"] = count_syncs(
        feed, [group(i) for i in range(cap_end + n, cap_end + n + 2 * W)])
    out["graph"] = _graph(pipe)
    return out


def _cell_source(cell: str, seed: int):
    """(config, group(i)) of a benchmark cell: its configuration and its
    traffic from `seed`."""
    from better_fastlio2_tpu_torch.config import LIOConfig
    from lio_bench import harness
    from lio_bench.traffic import gen

    spec = harness.cell_of(harness.load_benchmark(), cell)
    cfg_dict = harness.load_config(spec["config"])
    traffic = gen.Traffic(gen.load_spec(spec["traffic"]), seed,
                          extrinsic=gen.extrinsic_of(cfg_dict))
    return (lambda: LIOConfig.from_dict(cfg_dict)), traffic.group


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--config", choices=sorted(CONFIGS))
    src.add_argument("--cell", help="a workload of BENCHMARK.json")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=40)
    ap.add_argument("--scans", type=int, default=None,
                    help="profiled steady scans (default 32)")
    ap.add_argument("--calls", type=int, default=256,
                    help="traced calls with the profiler off")
    ap.add_argument("--overhead", type=float, default=0.0,
                    help="seconds a side of the trace-on/off comparison")
    ap.add_argument("--window", type=int, default=None,
                    help="pipeline window W (needs --scans)")
    args = ap.parse_args()
    if args.window is not None and args.scans is None:
        cs.fail("--window is the pipeline window W; the number of profiled "
                "scans, which --window once gave, is now --scans: give both")
    scans = 32 if args.scans is None else args.scans

    import torch

    from better_fastlio2_tpu_torch.io.synthetic import make_bench_sequence
    from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a GPU")
    name = args.config or "fused"
    bench = args.cell is None and name.startswith("bench_")
    W = args.window or 1
    if W > 1 and not bench:
        cs.fail("--window drives the bench configurations only")
    if args.overhead and not args.cell:
        cs.fail("--overhead feeds a cell's traffic: give --cell")
    if bench and W == 1 and args.warmup <= cs.PLANE_CACHE_WARMUP:
        cs.fail(f"--warmup must pass the {cs.PLANE_CACHE_WARMUP} warmup-"
                "program scans")
    card = cs.card_line()
    if args.cell:
        config, group = _cell_source(args.cell, args.seed)
        out = {"cell": args.cell, "seed": args.seed}
    else:
        n_groups = (args.warmup + scans + args.calls + SYNC_SCANS + 1
                    if W == 1 else 1 + (-(-cs.PLANE_CACHE_WARMUP // W) + 1)
                    * W + max(1, scans // W) * W + 2 * W)
        groups = make_bench_sequence(
            "outdoor" if name == "bench_outdoor" else "room", n_groups)
        config, group = CONFIGS[name], groups.__getitem__
        out = {"config": name}
    if W > 1:
        pipe = LIOPipeline(config(), pipelined=True, window=W,
                           quantized=True, unroll=min(W, 8))
        out.update(profile_windowed(pipe, group, scans))
    else:
        out.update(per_scan(LIOPipeline(config(), trace=True), group,
                            args.warmup, scans, args.calls, bench))
        if args.overhead:
            out["overhead"] = overhead(
                lambda t: LIOPipeline(config(), trace=t), group,
                args.warmup, args.overhead)
    print(card, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
