"""Run one cell of the benchmark and print its result line.

    python3 lio_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, lio_bench/ and the
program, better_fastlio2_tpu_torch.  The cell (BENCHMARK.json) names a
configuration (configs/) and a traffic mix (traffic/); the seed makes
the traffic.  Set-up builds or loads the program's kernels, makes the
traffic, and runs the IMU initialisation and the warmup scans that
capture every graph the window replays.  The window then feeds scans
back to back for --seconds; with --trace 1 a bounded stretch of it runs
under the profiler and the per-layer metrics are read from that stretch,
and after the window a second pipeline with the program's own trace on
(LIOPipeline(trace=True)), started from the first one's state, runs the
scans that follow unprofiled, for the metrics that read the program's
spans and counters.  After the window the reference (ref/) judges the
program's answers (check.py).  The last line of standard output is one
JSON object; the compared numbers with their limits are also the last
lines of standard error.  Exits non-zero without a result when no GPU
(or too few) is present, when the program or a file is missing, when
JAX or the JAX package was loaded, or when a declared metric could not
be read.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ.setdefault(var, str(ROOT / "build" / sub))
os.environ.setdefault("USE_FLAX", "0")
# one process with few threads: the host's share of a scan is one thread's
# work, and idle pool threads that spin steal its core
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
os.environ.setdefault("USE_JAX", "0")

import numpy as np  # noqa: E402

from lio_bench import harness as H  # noqa: E402

SAMPLES = 5  # checked steps drawn in a window
STRETCH_SCANS = 32  # scans in the traced stretch
STRETCH_AT = 0.3  # the stretch opens at this share of the window
GAP_SCANS = 32  # untraced calls after the stretch that time the host gap
TRACE_CALLS = 32  # calls of the program's traced pipeline after the window
STAGES = ("lio.imu", "lio.fov_crop", "lio.downsample", "lio.update",
          "lio.insert")  # the spans that partition a scan's lio.scan
WARM_SCANS = 8  # scans of set-up after the start (the graph's capture)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_line(device) -> tuple[str, dict]:
    import torch

    if device.type != "cuda":
        return "cpu", {"platform": "cpu", "kind": "cpu", "count": 1}
    name = torch.cuda.get_device_name(device)
    info = {"platform": "gpu", "kind": name, "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable: {e}"
    log(json.dumps({"card": name, "nvidia_smi": smi}))
    return name, info


def build_pipeline(cfg, device, fault=None, trace=False):
    """The program as the cell drives it, one scan a call, with its own
    trace on or off; `fault` (a function of the step) wraps every step
    the pipeline builds: the planted faults of the tests."""
    import better_fastlio2_tpu_torch.pipeline.lio as lio

    make = lio.make_step_fn
    if fault is not None:
        lio.make_step_fn = lambda *a, **k: fault(make(*a, **k))
    try:
        return lio.LIOPipeline(cfg, device=str(device), trace=trace)
    finally:
        lio.make_step_fn = make


def feed(pipe, g):
    return pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"],
                             g["imu_gyr"], g["imu_t"], g["scan_beg_abs"],
                             g["scan_end_t"])


def program_trace(pipe, cfg, device, fault, groups) -> list:
    """The trace records (utils/trace.ScanTrace) of the program's own
    spans and counters over `groups` but the first: a second pipeline,
    its trace on, takes `pipe`'s state and goes on from there, unprofiled;
    its first call captures its graph and is left out.  `pipe` is not
    fed again."""
    tp = build_pipeline(cfg, device, fault, trace=True)
    tp.inited, tp.acc_norm = True, pipe.acc_norm
    tp.last_scan_end_abs = pipe.last_scan_end_abs
    tp._scan_count = pipe._scan_count
    tp.ls = pipe.ls
    return [feed(tp, g)["trace"] for g in groups][1:]


def launch_counts() -> dict:
    """K1 and K2 launches that ran so far: the wrappers' host counts less
    their calls under a capture, plus the graphs' device counters."""
    from better_fastlio2_tpu_torch.ops import kernels
    from better_fastlio2_tpu_torch.pipeline import graphs

    return {k: getattr(kernels, k).launches - graphs.captured[k]
            + kernels.device_launches(k) for k in graphs.KERNELS}


class GapTimer:
    """Events around the copy and graph replay of each call, for the host
    gap: installed on the pipeline's graph for `n` calls."""

    def __init__(self, pipe, n: int):
        import torch

        self.graph, self.n, self.events = pipe.graph, n, []
        if self.graph is None:
            raise H.BenchError("the pipeline has no graph to time")
        replay = self.graph.replay

        def timed(rows):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = replay(rows)
            e1.record()
            self.events.append((e0, e1))
            return out

        self.graph.replay = timed

    def done(self) -> bool:
        if len(self.events) < self.n:
            return False
        if "replay" in vars(self.graph):
            del self.graph.replay
        return True

    def device_s(self) -> list:
        for _, e1 in self.events:
            e1.synchronize()
        return [e0.elapsed_time(e1) / 1e3 for e0, e1 in self.events]


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             cfg_over=None, traffic_over=None, fault=None,
             control: bool = False, limits_over=None) -> dict:
    """One run of `cell`; returns the result line's object (with
    `control` or a `fault`, also every number of the program, and with
    `control` the control's, under "readings").  cfg_over, traffic_over
    and limits_over change the cell's files as read: the tests' sizes and
    limits."""
    import torch

    from better_fastlio2_tpu_torch.config import LIOConfig
    from lio_bench import check
    from lio_bench.traffic import gen

    dev = torch.device(device)
    cfg_dict = H.load_config(cell["config"])
    if cfg_over:
        cfg_over(cfg_dict)
    spec = gen.load_spec(cell["traffic"])
    if traffic_over:
        traffic_over(spec)
    limits = H.load_limits(cell["name"])
    if limits_over:
        limits_over(limits)
    want = H.declared(bench, cell["name"], trace)
    card, dev_info = card_line(dev)
    cfg = LIOConfig.from_dict(cfg_dict)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # ---- set-up: traffic, program, warmup --------------------------------
    t = time.perf_counter()
    traffic = gen.Traffic(spec, seed, extrinsic=gen.extrinsic_of(cfg_dict))
    log(json.dumps({"traffic": cell["traffic"], "lap_scans": traffic.lap_scans,
                    "returns_per_scan": traffic.returns(),
                    "make_s": time.perf_counter() - t}))
    pipe = build_pipeline(cfg, dev, fault)
    g = 0
    while not pipe.inited:
        feed(pipe, traffic.group(g))
        g += 1
    first_group = g
    results = []  # every result the program returned, in scan order

    def call():
        nonlocal g
        out = feed(pipe, traffic.group(g))
        g += 1
        results.append(out)

    # the start: the program's first scan, checked against the reference's
    # own initialisation; then the scans that capture the graph
    call()
    sync()
    steps = [{"scans": (0, 1), "before": None,
              "after": H.snapshot(pipe.ls, "cpu")}]
    for _ in range(WARM_SCANS):
        call()
    if pipe.graph is not None:
        log(json.dumps({"graph_of": pipe._graph_of, "steps": pipe.graph.steps,
                        "capture_s": pipe.graph.capture_s, "nodes": {
                            k: v for k, v in pipe.graph.nodes.items()
                            if k != "by_type"}}))
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the window --------------------------------------------------------
    rng = np.random.default_rng(seed)
    due = sorted(rng.uniform(0.02, 0.95, SAMPLES) * seconds)
    first_scan = g - first_group  # the window's first scan
    lat = []
    prof = gap = facts_in = None
    snap_bytes = 0
    t_open = time.perf_counter()
    elapsed = 0.0
    while True:
        k = g - first_group  # this call's scan
        opening = trace and prof is None and elapsed >= STRETCH_AT * seconds
        # no checked step inside the traced stretch or the host gap's calls
        quiet = not opening and (prof is None or (
            facts_in is not None and (gap is None or gap.done())))
        sample = due and elapsed >= due[0] and quiet
        if sample:
            before = H.snapshot(pipe.ls)
            sync()
        if opening:
            sync()
            counters = launch_counts()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            t_a, stretch_first = time.perf_counter(), k
        t0 = time.perf_counter()
        call()
        lat.append(time.perf_counter() - t0)
        if sample:
            after = H.snapshot(pipe.ls)
            sync()
            steps.append({"scans": (k, k + 1), "before": before,
                          "after": after})
            snap_bytes += H.snapshot_bytes(before) + H.snapshot_bytes(after)
            due.pop(0)
        done = k + 1  # scans fed so far
        if prof is not None and facts_in is None and \
                done - stretch_first >= STRETCH_SCANS:
            sync()
            t_b = time.perf_counter()
            prof.__exit__(None, None, None)
            c1 = launch_counts()
            facts_in = (t_b - t_a, done - stretch_first, stretch_first,
                        {n: c1[n] - counters[n] for n in c1})
            gap = GapTimer(pipe, GAP_SCANS) if cuda else None
            gap_from = len(lat)
        elapsed = time.perf_counter() - t_open
        # the window closes once every sample drawn is taken and the traced
        # stretch and the host gap's calls are done
        if elapsed >= seconds and not due and (not trace or (
                facts_in is not None and (gap is None or gap.done()))):
            break
    sync()
    t_close = time.perf_counter()
    n_win = g - first_group - first_scan
    window_s = t_close - t_open
    dev_info["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(dev)) if cuda else 0)

    # ---- the program's answers ---------------------------------------------
    traj = np.asarray(pipe.trajectory, np.float64)
    win_rows = traj[first_scan:first_scan + n_win]
    failed = n_win - int(np.sum(np.all(np.isfinite(win_rows), axis=1)))
    gt = np.stack([traffic.group(first_group + j)["gt_pos"]
                   for j in range(first_scan, first_scan + len(win_rows))])
    err = np.linalg.norm(win_rows[:, :3] - gt, axis=1)
    lq = np.quantile(np.asarray(lat) * 1e3, [0.5, 0.9, 0.99, 1.0])
    log(json.dumps({"window_scans": n_win, "window_s": window_s,
                    "scans_per_s": n_win / window_s,
                    "call_ms_p50_p90_p99_max": lq.tolist(),
                    "calls_s": float(np.sum(lat)),
                    "loadavg": open("/proc/loadavg").read().split()[:3],
                    "ate_rmse_m": float(np.sqrt(np.mean(err ** 2))),
                    "end_error_m": float(err[-1]),
                    "checked_steps": [s["scans"] for s in steps],
                    "snapshot_bytes": snap_bytes}))
    facts = None
    if trace:
        sw, sn, s0, cnt = facts_in
        calls = lat[gap_from:gap_from + GAP_SCANS]
        gap_calls = (calls, gap.device_s() if gap is not None else calls)
        t = time.perf_counter()
        traced = program_trace(pipe, cfg, dev, fault, [
            traffic.group(g + i) for i in range(TRACE_CALLS + 1)])
        trace_s = time.perf_counter() - t
        facts = H.stretch_facts(prof, sw, sn, results[s0:s0 + sn], cnt,
                                cfg, card, gap_calls, traced)
        k2_s, k2_rec = H.kernel_time(facts, "hth_cluster_kernel")
        log(json.dumps({"stretch_scans": sn, "stretch_first_scan": s0,
                        "window_s": sw, "busy_s": facts["busy_s"],
                        "gap_call_ms": [1e3 * c for c in gap_calls[0]],
                        "gap_device_ms": [1e3 * d for d in gap_calls[1]],
                        "k2": {"counter_calls": cnt["fused_hth"],
                               "cupti_records": k2_rec, "device_s": k2_s},
                        "passes": facts["passes"]}))
        ms = {n: H.span_ms(facts, n) for n in ("lio.scan",) + STAGES}
        if None not in ms.values():
            ms["head_tail"] = ms["lio.scan"] - sum(ms[n] for n in STAGES)
        log(json.dumps({"program_trace": {"calls": len(traced),
                                          "s": trace_s, "ms": ms}}))
        prof = traced = None
    del pipe, gap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the reference's judgement ------------------------------------------
    t = time.perf_counter()
    ref = check.reference_answers(cfg_dict, traffic, first_group, steps, dev)
    detail = {}
    nums = check.numbers(check.program_answers(traj, steps, cfg_dict), ref,
                         detail)
    log(json.dumps({"gaps": detail}))
    log(json.dumps({"numbers": nums}))
    ok, compared = check.verdict(nums, limits)
    log(json.dumps({"reference_s": time.perf_counter() - t}))
    extra = {"program": nums} if control or fault is not None else {}
    if control:
        t = time.perf_counter()
        cref = check.reference_answers(cfg_dict, traffic, first_group, steps,
                                       dev, control=True)
        cdetail = {}
        extra["control"] = check.numbers(cref, ref, cdetail)
        log(json.dumps({"control_gaps": cdetail,
                        "control_s": time.perf_counter() - t}))

    # ---- the result line ----------------------------------------------------
    metrics = {}
    if trace:
        dev_info["busy_s"] = facts["busy_s"]
        dev_info["window_s"] = facts["window_s"]
        for name, unit in want.items():
            v = H.load_reader(name)(facts)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": unit}
    else:
        e2e = {"setup_s": t_open - t_start, "scan_ms_p95": H.p95(lat) * 1e3}
        for name, unit in want.items():
            if name in e2e:
                metrics[name] = {"value": float(e2e[name]), "unit": unit}
    H.check_line(metrics, want)
    bad = H.forbidden_modules()
    if bad:
        raise H.BenchError(f"modules of JAX or the JAX package loaded: {bad}")
    line = {"correct": bool(ok and failed == 0), "attempted": n_win,
            "failed": failed, "metrics": metrics, "device": dev_info}
    if trace:
        line["breakdown"] = H.breakdown(facts)
    if extra:
        line["readings"] = extra
    line["compared"] = {k: {"value": v["value"] if math.isfinite(v["value"])
                            else 1e308, "limit": v["limit"]}
                        for k, v in compared.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = H.load_benchmark()
        cell = H.cell_of(bench, args.workload)
        import torch

        if not torch.cuda.is_available():
            raise H.BenchError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise H.BenchError(f"{cell['chips']} GPUs asked for, "
                               f"{torch.cuda.device_count()} present")
        line = run_cell(bench, cell, args.seed, args.seconds,
                        bool(args.trace), T_START)
    except (H.BenchError, OSError, ImportError, KeyError) as e:
        log(f"lio_bench: {type(e).__name__}: {e}")
        return 2
    for k, v in line["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
