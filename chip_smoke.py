#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build   — compile every kernel of the port from its sources (nvcc,
               sm_90a), one compiler per source, all started together;
               print each kernel's registers, shared memory and spills
               (ptxas -v; any spill fails), and the thread-block cluster
               size each kernel's setup took on this card;
  2. kernels — hold K1 (fused_normal_eqs) against its plain PyTorch
               version on the card at the main path's shapes (and ragged
               ones; a view with a storage offset, which takes the
               kernel's scalar-load branch, must give the same bits), and
               time it: `ms` the wall time of one call, wrapper included
               (CUDA events around each call, median of 100 after
               warmup); `device_us` the device time per call (100 calls
               captured in one CUDA graph, replayed with events around;
               `device_us_n1` the same at N = 1, the fixed cost); the
               plain version; the library call rows^T rows on prebuilt
               (N, 8) rows; and `launch_floor_us`, the graph time of a
               one-element fill, the least any launch costs;
  3. k2      — the same for K2 (fused_hth) in both modes, plus an all-false
               mask (exactly 0), and the library call hx^T hx + hx^T h on
               prebuilt (N, 12) rows;
  4. main    — run LIOPipeline, the port's entry point, over 240 scans of
               the room benchmark sequence at the full bench shapes on the
               fused single-association path (slice 1), count the kernel
               launches of that run and its host syncs (the port's own
               reads through utils.device.to_host, and every synchronising
               call torch reports under set_sync_debug_mode("warn")),
               re-check K1 on three of
               its scans, and gate the trajectory on the room accuracy gate
               of bench.py (end error <= 0.030 m, ATE <= 0.15 m);
  5. row     — the same sequence and shapes on the ESIKF row path (the
               reference re-association on every converged pass, 6 gain
               columns), K2 launched on every updated scan and re-checked
               on three, K1 never; the room gate;
  6. row_ext — the row path with extrinsic estimation (12 gain columns);
               end error and ATE <= 0.15 m, looser than the room gate
               because the JAX package itself reads 0.08 m there;
  7. bench_room — the bench configuration of bench.py:249-309 on the room
               sequence (slice 3): 16 warmup scans of 5-NN association,
               then the steady program (moment planes from the dense
               moment table, the dense-moment insert, the insert budgets),
               K1 on every updated scan and re-checked on three steady
               scans, K2 never; the room gate; ms/scan, port reads and
               torch syncs reported for the warmup and the steady scans
               apart, and whether the dense moment table was built;
  8. bench_outdoor — the same on 400 scans of the outdoor sequence with
               n_ds 10240, solve_compact 8192 and ds_drop_high_z; K1's
               launches counted by the width of the buffer they ran on
               (the compacted (16, 8192) and the full (16, 10240)), at
               least one compacted, and K1 re-checked on a compacted call
               of the path; bench.py's outdoor gate (end error <= 0.136
               m, ATE <= 0.68 m: 2x and 10x the C++ reference's 0.068 m);
  9. bench_room_window — the bench configuration as bench.py:388-389
               drives it (slice 4): LIOPipeline(pipelined=True, window=8,
               quantized=True, unroll=8) over the room sequence; the
               warmup windows eagerly, the steady windows as replays of
               one CUDA graph of the sync-free steady step (captured at
               the first steady window) under sync debug mode "error";
               the room gate; steady ms/scan beside the per-scan phase's;
               device_ms_per_scan (steady windows replayed back to back,
               CUDA events, as bench.py:487-520 times the device: the
               median of 10 groups, on the graph recaptured without the
               K1 probes, and on the probed one beside it); the graph's
               nodes and K1 kernel nodes per step (by K1's handle, equal
               to its calls at capture), the replays counted, and its
               capture time; port reads and torch syncs per steady
               window; peak
               memory with the graph's pool; K1's pass-0 inputs and
               outputs inside the graph held against the plain version;
 10. bench_outdoor_window — the same on the outdoor sequence with
               window=16 (unroll 8: two replays a window), K1 inside the
               graph checked at both widths (8192 and 10240);
 11. library_graph — the library calls' device time per call (graph
               replay), after the paths so that the cuBLAS workspace of
               the capturing stream does not count in their peak memory;
 12. one_launch — under torch.profiler, one call of K1 and of K2 in each
               mode runs exactly one device kernel (run last, so that the
               profiler cannot touch the timed paths).

Output: one line per phase, the card's name and power limit, one
{"kernels": [...]} line, and last {"ok": true, "device": {...}}.  Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np

N_SCANS = 240
N_SCANS_OUTDOOR = 400
WARMUP_SCANS = 20
PLANE_CACHE_WARMUP = 16  # bench.py's 5-NN warmup scans before the steady program
SOLVE_COMPACT = 8192  # the outdoor workload's compacted solve width (bench.py)
CHECK_SCANS = (60, 130, 200)  # scans whose kernel inputs are re-checked
WINDOW = {"room": 8, "outdoor": 16}  # bench.py:325-328
CHAIN_WINDOWS, CHAIN_GROUPS = 4, 10  # device timing of the window (bench.py)
TIMING_RUNS = 100
GRAPH_CALLS = 100  # calls captured in one CUDA graph for device_us
GRAPH_REPLAYS = 20
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores
K1_FLOPS_PER_LANE = 140  # transform, residual, gate, rows, 36 FMAs, voxel test
# K2 per lane: two (one) cross products, the w products, 78 + 12 (21 + 6)
# FMAs; bytes: four (three) (N, 3) f32 inputs, pd2 f32, sel u8
K2_FLOPS_PER_LANE = {True: 220, False: 80}
K2_BYTES_PER_LANE = {True: 4 * 12 + 4 + 1, False: 3 * 12 + 4 + 1}
# the JAX package in f32 on the CPU over the same 240 room scans (ATE, end
# error in m): the reference level each row phase is printed beside
JAX_ROOM_REF = {"row": (0.0178, 0.0040), "row_ext": (0.0842, 0.0816)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def first_card() -> str:
    """The nvidia-smi id of the first card CUDA may use."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    return "0" if vis is None else vis.split(",")[0].strip()


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "-i", first_card(), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """The least time the card could take (ms), and what bounds it: the
    bytes over the memory rate or the operations over the f32 rate."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, runs: int = TIMING_RUNS, warmup: int = 10) -> float:
    """Median time of one call, CUDA events around each call: on an idle
    card, the host's time to issue it (wrapper included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def graph_us(fn, calls: int = GRAPH_CALLS,
             replays: int = GRAPH_REPLAYS) -> float:
    """Device microseconds per call, free of the host: `calls` calls of
    `fn` captured in one CUDA graph, replayed `replays` times with CUDA
    events around each replay; the median replay over `calls`."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capturing stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    evs = []
    for _ in range(replays):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return 1e3 * float(np.median([s.elapsed_time(e) for s, e in evs])) / calls


def device_kernels(fn) -> list[str]:
    """The names of the device kernels that one call of `fn` runs, from
    torch.profiler's CUDA activities (after a call outside the profiler,
    so that building and setup are not in it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def offset_view(t):
    """A copy of `t` that is a view one element into a fresh buffer: equal
    values at an address that is not 16-byte aligned."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def ptxas_report(out: str) -> list[dict]:
    """Registers, shared memory and spills of each kernel in one source's
    nvcc -Xptxas -v output."""
    recs = []
    for block in out.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        m = re.search(r"\d+([a-z_]+_kernel)(?:ILb([01])E)?", mangled)
        name = (m.group(1) + {"1": "<true>", "0": "<false>", None: ""}[
            m.group(2)]) if m else mangled
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        recs.append({"kernel": name,
                     "registers": int(regs.group(1)) if regs else None,
                     "smem_bytes": int(smem.group(1)) if smem else 0,
                     "spill_stores": int(spill.group(1)) if spill else None,
                     "spill_loads": int(spill.group(2)) if spill else None})
    return recs


def random_soa(n: int, seed: int):
    """A seeded (16, n) SoA buffer and (16,) pose like the solve sees:
    points within ~25 m, unit normals, some lanes gated or moved."""
    import torch

    from better_fastlio2_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    p_imu = rng.normal(size=(n, 3)).astype(np.float32) * 10.0
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d = rng.normal(size=n).astype(np.float32)
    invb = (0.9 / np.sqrt(np.maximum(np.linalg.norm(p_imu, axis=-1),
                                     1e-8))).astype(np.float32)
    ok = rng.uniform(size=n) > 0.2
    ijk = np.floor(p_imu / 0.5).astype(np.int32)
    ijk[: n // 8] += 1
    valid = rng.uniform(size=n) > 0.05
    soa = kernels.pack_soa(*(torch.as_tensor(a) for a in
                             (p_imu, normal, d, invb, ok, ijk, valid)))
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([[w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                   2 * (x * z + w * y)],
                  [2 * (x * y + w * z), w * w - x * x + y * y - z * z,
                   2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x),
                   w * w - x * x - y * y + z * z]])
    params = np.concatenate([R.reshape(-1), rng.normal(size=3), [0.5],
                             np.zeros(3)]).astype(np.float32)
    return soa, torch.as_tensor(params)


def compare_k1(soa, params, G_k, mv_k) -> dict:
    """Hold one K1 result against the plain version on the same inputs.

    Each entry of G within rtol 1e-5 / atol 1e-3 max|G| and, tighter,
    within kernels.fused_normal_eqs_tolerance: 1e-5 sqrt(G_ii G_jj) (its
    own size, so n_valid at [7, 7] and the n.n block are held to theirs)
    plus the lanes on the edge of the residual gate.  n_moved equal up to
    the valid lanes whose p_w/vs lies within 1e-5 of an integer."""
    import torch

    from better_fastlio2_tpu_torch.ops import kernels

    G_r, mv_r = kernels.fused_normal_eqs_reference(soa, params)
    G_tol, slack, gate_lanes = kernels.fused_normal_eqs_tolerance(soa,
                                                                  params)
    dG = (G_k.double() - G_r.double()).abs()
    scale = float(G_r.abs().max())
    err = float(dG.max())
    ratio = dG / G_tol.clamp(min=1e-300)
    over = float(ratio.max())
    loose = 1e-5 * G_r.double().abs() + 1e-3 * max(scale, 1e-30)
    if not (bool((dG <= G_tol).all()) and bool((dG <= loose).all())):
        i, j = divmod(int(torch.argmax(ratio)), 8)
        fail(f"K1 G disagrees with the plain version: G[{i},{j}] "
             f"{float(G_k[i, j])} vs {float(G_r[i, j])}, tolerance "
             f"{float(G_tol[i, j]):.3e} (max err {err:.3e}, N="
             f"{soa.shape[1]})")
    dmv = abs(float(mv_k) - float(mv_r))
    if dmv > slack:
        fail(f"K1 n_moved {float(mv_k)} vs plain {float(mv_r)} "
             f"({slack} boundary lanes, N={soa.shape[1]})")
    return {"n": soa.shape[1], "max_abs_err": err, "max_abs_G": scale,
            "max_err_over_tol": over, "gate_lanes": gate_lanes,
            "n_moved": float(mv_k), "n_moved_plain": float(mv_r),
            "boundary_lanes": slack}


def random_hth(n: int, seed: int, sel: str = "random"):
    """Seeded K2 inputs like the row path's: points within ~25 m, their
    imu-frame copies, unit normals and C, small residuals, and a bool
    mask: `sel` "random" (80 % true), "all" or "none".  CPU tensors, f32;
    the tests take the same inputs."""
    import torch

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 10.0
    pimu = pts + rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    C = rng.normal(size=(n, 3)).astype(np.float32)
    C /= np.linalg.norm(C, axis=-1, keepdims=True)
    pd2 = rng.normal(size=n).astype(np.float32) * 0.05
    mask = {"random": rng.uniform(size=n) > 0.2, "all": np.ones(n, bool),
            "none": np.zeros(n, bool)}
    return [torch.as_tensor(a) for a in (pts, pimu, nrm, C, pd2, mask[sel])]


def compare_k2(ins, extrinsic: bool, HTH_k, HTh_k) -> dict:
    """Hold one K2 result against the plain version on the same inputs:
    every entry within kernels.fused_hth_tolerance (1e-5 sqrt(HTH_ii
    HTH_jj), and 1e-5 sqrt(HTH_ii sum w pd2^2) for HTh), HTH exactly
    symmetric."""
    import torch

    from better_fastlio2_tpu_torch.ops import kernels

    HTH_r, HTh_r = kernels.fused_hth_reference(*ins, extrinsic=extrinsic)
    tol_H, tol_h = kernels.fused_hth_tolerance(*ins, extrinsic=extrinsic)
    dH = (HTH_k.double() - HTH_r.double()).abs()
    dh = (HTh_k.double() - HTh_r.double()).abs()
    ratio = torch.cat([(dH / tol_H.clamp(min=1e-300)).flatten(),
                       dh / tol_h.clamp(min=1e-300)])
    if not (bool((dH <= tol_H).all()) and bool((dh <= tol_h).all())):
        k = int(torch.argmax(ratio))
        fail(f"K2 (extrinsic={extrinsic}) disagrees with the plain version "
             f"at {'HTH' if k < 144 else 'HTh'}[{k % 144}]: max err "
             f"{float(max(dH.max(), dh.max())):.3e}, {float(ratio.max()):.3g}"
             f" of its tolerance (N={ins[0].shape[0]})")
    if not torch.equal(HTH_k, HTH_k.T):
        fail("K2's HTH is not exactly symmetric")
    return {"n": ins[0].shape[0], "extrinsic": extrinsic,
            "max_abs_err": float(max(dH.max(), dh.max())),
            "max_abs_HTH": float(HTH_r.abs().max()),
            "max_err_over_tol": float(ratio.max()),
            "n_valid": int(ins[5].sum())}


def phase_build() -> None:
    from better_fastlio2_tpu_torch.ops import _build, kernels

    t0 = time.perf_counter()
    reports = _build.build_all(force=True)
    dt = time.perf_counter() - t0
    ptxas = {name: ptxas_report(out) for name, out in reports.items()}
    for name in _build.SOURCES:
        recs = ptxas.get(name)
        if not recs or any(r["registers"] is None or r["spill_stores"] is None
                           for r in recs):
            fail(f"no ptxas report for {name}.cu: {reports.get(name)!r}")
        spilled = [r for r in recs if r["spill_stores"] or r["spill_loads"]]
        if spilled:
            fail(f"{name}.cu spills registers: {spilled}")
    for name in _build.SOURCES:
        kernels._launcher(name)  # load and pick the cluster size
    print(json.dumps({"phase": "build", "sources": _build.SOURCES,
                      "compiled": sorted(reports), "seconds": round(dt, 3),
                      "ptxas": ptxas, "clusters": kernels.cluster_info}),
          flush=True)


def phase_kernels(floor_us: float) -> dict:
    import torch

    from better_fastlio2_tpu_torch.ops import kernels

    checks = []
    for n, seed in ((16384, 1), (10240 + 37, 2), (1, 3)):
        soa, params = random_soa(n, seed)
        soa, params = soa.cuda(), params.cuda()
        G, mv = kernels.fused_normal_eqs(soa, params)
        # the same values at an unaligned address: the scalar-load branch
        G_o, mv_o = kernels.fused_normal_eqs(offset_view(soa), params)
        torch.cuda.synchronize()
        if not (torch.equal(G_o, G) and torch.equal(mv_o, mv)):
            fail(f"K1 on an offset view differs from K1 on the aligned "
                 f"buffer (N={n})")
        checks.append(compare_k1(soa, params, G, mv))
    zero = torch.zeros(kernels.SOA_CH, 4096, device="cuda")
    G0, mv0 = kernels.fused_normal_eqs(zero, params)
    torch.cuda.synchronize()
    if int(torch.count_nonzero(G0)) != 0 or float(mv0) != 0.0:
        fail("K1 on an all-zero buffer is not exactly zero")

    n = 16384  # n_ds at the room bench shapes
    soa, params = random_soa(n, 1)
    soa, params = soa.cuda(), params.cuda()
    call = functools.partial(kernels.fused_normal_eqs, soa, params)
    library = k1_library(soa, params)
    # the 13 live channels of the buffer (13-15 are padding the kernel
    # never reads), the pose, and G plus n_moved written
    bytes_moved = 13 * n * 4 + params.numel() * 4 + (64 + 1) * 4
    bound_ms, bound_by = bound(bytes_moved, K1_FLOPS_PER_LANE * n)
    bound_c, _ = bound(13 * SOLVE_COMPACT * 4 + params.numel() * 4
                       + (64 + 1) * 4, K1_FLOPS_PER_LANE * SOLVE_COMPACT)
    soa1, params1 = (t.cuda() for t in random_soa(1, 3))
    soa_c, params_c = (t.cuda() for t in random_soa(SOLVE_COMPACT, 4))
    call_c = functools.partial(kernels.fused_normal_eqs, soa_c, params_c)
    out = {"phase": "kernels", "checks": checks, "ms": time_ms(call),
           "device_us": graph_us(call),
           # the outdoor path's compacted (16, 8192) buffer
           "ms_compact": time_ms(call_c), "device_us_compact": graph_us(call_c),
           "compact_n": SOLVE_COMPACT, "bound_ms_compact": bound_c,
           # one lane: the fixed cost of the launch, barriers and reduction
           "device_us_n1": graph_us(functools.partial(
               kernels.fused_normal_eqs, soa1, params1)),
           "plain_ms": time_ms(lambda: kernels.fused_normal_eqs_reference(
               soa, params)),
           "library_ms": time_ms(library),
           "launch_floor_us": floor_us,
           "bound_ms": bound_ms, "bound_by": bound_by, "timed_n": n,
           "timing_runs": TIMING_RUNS, "graph_calls": GRAPH_CALLS}
    print(json.dumps(out), flush=True)
    return out


def phase_k2(floor_us: float) -> dict:
    import torch

    from better_fastlio2_tpu_torch.ops import kernels

    checks = []
    for extrinsic in (False, True):
        for n, seed in ((16384, 11), (10240 + 37, 12), (1, 13)):
            ins = [t.cuda() for t in random_hth(n, seed)]
            HTH, HTh = kernels.fused_hth(*ins, extrinsic=extrinsic)
            # the same values at unaligned addresses: the scalar branch
            H_o, h_o = kernels.fused_hth(*map(offset_view, ins),
                                         extrinsic=extrinsic)
            torch.cuda.synchronize()
            if not (torch.equal(H_o, HTH) and torch.equal(h_o, HTh)):
                fail(f"K2 (extrinsic={extrinsic}) on offset views differs "
                     f"from K2 on aligned inputs (N={n})")
            checks.append(compare_k2(ins, extrinsic, HTH, HTh))
        ins = [t.cuda() for t in random_hth(4096, 14, sel="none")]
        H0, h0 = kernels.fused_hth(*ins, extrinsic=extrinsic)
        torch.cuda.synchronize()
        if int(torch.count_nonzero(H0)) or int(torch.count_nonzero(h0)):
            fail(f"K2 (extrinsic={extrinsic}) on an all-false mask is not "
                 "exactly zero")

    n = 16384  # n_ds at the room bench shapes
    ins = [t.cuda() for t in random_hth(n, 11)]
    ins1 = [t.cuda() for t in random_hth(1, 13)]
    timing = {}
    for extrinsic in (False, True):
        call = functools.partial(kernels.fused_hth, *ins,
                                 extrinsic=extrinsic)
        library = k2_library(ins, extrinsic)
        bytes_moved = K2_BYTES_PER_LANE[extrinsic] * n + (144 + 12) * 4
        bound_ms, bound_by = bound(bytes_moved,
                                   K2_FLOPS_PER_LANE[extrinsic] * n)
        timing["ext" if extrinsic else "noext"] = {
            "ms": time_ms(call), "device_us": graph_us(call),
            "device_us_n1": graph_us(functools.partial(
                kernels.fused_hth, *ins1, extrinsic=extrinsic)),
            "plain_ms": time_ms(lambda: kernels.fused_hth_reference(
                *ins, extrinsic=extrinsic)),
            "library_ms": time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": bytes_moved}
    out = {"phase": "k2", "checks": checks, "timing": timing, "timed_n": n,
           "launch_floor_us": floor_us, "timing_runs": TIMING_RUNS,
           "graph_calls": GRAPH_CALLS,
           "tf32": torch.backends.cuda.matmul.allow_tf32}
    if out["tf32"]:
        fail("TF32 is on for float32 matmuls: the library yardstick would "
             "not be float32")
    print(json.dumps(out), flush=True)
    return out


def k1_library(soa, params):
    """K1's library yardstick: one matmul r8^T r8 on the prebuilt gated
    (N, 8) rows (it leaves out the transform, the gate and the count)."""
    import torch

    from better_fastlio2_tpu_torch.ops import kernels

    r8 = kernels._neq_rows(soa, params).contiguous()
    return functools.partial(torch.matmul, r8.T, r8)


def k2_library(ins, extrinsic: bool):
    """K2's library yardstick: hx^T hx and hx^T h on the prebuilt (N, 12)
    rows (it leaves out building them)."""
    from better_fastlio2_tpu_torch.ops import kernels

    w = ins[5].float()
    hx = kernels._hth_rows(*ins[:4], w, extrinsic).contiguous()
    h = (-ins[4] * w).contiguous()
    return lambda: (hx.T @ hx, hx.T @ h)


def phase_library_graph() -> dict:
    """The library yardsticks' device time per call (graph replay), at the
    kernels' timed inputs.  Run after the main paths: capturing cuBLAS on
    a new stream gives that stream a cuBLAS workspace for the life of the
    process, which would otherwise count in the paths' peak memory."""
    n = 16384
    soa, params = (t.cuda() for t in random_soa(n, 1))
    ins = [t.cuda() for t in random_hth(n, 11)]
    out = {"phase": "library_graph", "timed_n": n,
           "k1_library_device_us": graph_us(k1_library(soa, params)),
           "k2_library_device_us": {
               "ext" if e else "noext": graph_us(k2_library(ins, e))
               for e in (False, True)}}
    print(json.dumps(out), flush=True)
    return out


def phase_one_launch() -> dict:
    """One call of each kernel at the main path's N runs exactly one
    device kernel, and it is that kernel."""
    import torch

    from better_fastlio2_tpu_torch.ops import kernels

    n = 16384
    soa, params = (t.cuda() for t in random_soa(n, 1))
    ins = [t.cuda() for t in random_hth(n, 11)]
    calls = {
        "fused_normal_eqs": ("neq_cluster_kernel", functools.partial(
            kernels.fused_normal_eqs, soa, params)),
        "fused_hth": ("hth_cluster_kernel", functools.partial(
            kernels.fused_hth, *ins, extrinsic=False)),
        "fused_hth_ext": ("hth_cluster_kernel", functools.partial(
            kernels.fused_hth, *ins, extrinsic=True)),
    }
    seen = {}
    for name, (kernel, fn) in calls.items():
        names = device_kernels(fn)
        if len(names) != 1 or kernel not in names[0]:
            fail(f"{name}: one call ran {len(names)} device kernels "
                 f"{names}, expected one {kernel}")
        seen[name] = names[0]
    out = {"phase": "one_launch", "device_kernels_per_call": seen}
    print(json.dumps(out), flush=True)
    return out


def launch_floor_us() -> float:
    """The graph-replayed device time of a one-element zero_(): the least
    any single launch costs on this card."""
    import torch

    x = torch.ones(1, device="cuda")
    return graph_us(x.zero_)


def room_config():
    from better_fastlio2_tpu_torch.config import (IkdtreeConfig, LIOConfig,
                                                  MappingConfig, ShapesConfig)

    cfg = LIOConfig()
    cfg.shapes = ShapesConfig(
        n_raw=1 << 15, n_ds=1 << 14, n_imu=16, map_capacity_log2=20,
        map_bucket=4, map_max_probe=6, knn_chunk=1 << 14,
        map_dense_log2=(8, 8, 7), knn_max_live=12)
    cfg.mapping = MappingConfig(det_range=60.0, cube_len=400.0,
                                surf_leaf_size=0.5, extrinsic_est_en=False)
    cfg.ikdtree = IkdtreeConfig(
        max_iteration=4, filter_size_map_min=0.5, single_association=True,
        plane_cache=False, fused_solve=True, early_converge=True)
    return cfg


def row_config(extrinsic: bool):
    """room_config() on the ESIKF row path: the reference re-association
    on every converged pass (single_association off, so the fused solve
    does not apply), early_converge off, extrinsic estimation as given
    (the config.py default is on)."""
    cfg = room_config()
    cfg.ikdtree.single_association = False
    cfg.ikdtree.early_converge = False
    cfg.mapping.extrinsic_est_en = extrinsic
    return cfg


def bench_config(workload: str):
    """bench.py:249-309 for `workload` ("room" or "outdoor"): room_config()
    with the plane cache after a 16-scan warmup, the dense moment table
    (mom_dense), the insert budgets 2048 / 2048 / 4096 and, outdoors,
    n_ds 10240, solve_compact 8192 and ds_drop_high_z."""
    cfg = room_config()
    sh = cfg.shapes
    sh.insert_claim_budget = 2048
    sh.insert_dense_budget = 2048
    sh.insert_mom_budget = 4096
    if workload == "outdoor":
        sh.n_ds = sh.knn_chunk = 10240
        sh.solve_compact = SOLVE_COMPACT
        sh.ds_drop_high_z = True
    cfg.ikdtree.plane_cache = True
    cfg.ikdtree.plane_cache_warmup = PLANE_CACHE_WARMUP
    cfg.ikdtree.mom_dense = True
    return cfg


KERNELS = {"fused_normal_eqs": compare_k1, "fused_hth": compare_k2}


def run_main_path(cfg, groups, kernel: str = "fused_normal_eqs",
                  device=None, check_scans=CHECK_SCANS,
                  check_width: int | None = None) -> dict:
    """Drive LIOPipeline over `groups`; return the per-scan record, each
    kernel's launch count over the run (counts set to 0 just before) and
    `kernel`'s calls by the width of their input, the host syncs per scan
    (the port's to_host reads, and on CUDA every synchronising call torch
    reports), and the re-checks of `kernel` on `check_scans` and on its
    first call of width `check_width` (inputs captured as the path made
    them, compared after the run)."""
    import torch

    from better_fastlio2_tpu_torch.core import measurement
    from better_fastlio2_tpu_torch.ops import kernels
    from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
    from better_fastlio2_tpu_torch.utils.device import host_syncs

    fns = {name: getattr(kernels, name) for name in KERNELS}
    real = fns[kernel]
    captured = []
    widths: dict[int, int] = {}
    capture = [False]  # capture this call's inputs and outputs

    def spy(*args, **kw):  # counts widths, records the path's own calls
        out = real(*args, **kw)
        width = args[0].shape[-1] if kernel == "fused_normal_eqs" else (
            args[0].shape[0])
        widths[width] = widths.get(width, 0) + 1
        first_of_width = width == check_width and widths[width] == 1
        if not (capture[0] or first_of_width):
            return out
        if kernel == "fused_hth":
            captured.append(([a.clone() for a in args], kw["extrinsic"],
                             *(o.clone() for o in out)))
        else:
            captured.append((*(a.clone() for a in args),
                             *(o.clone() for o in out)))
        return out

    t_run = time.perf_counter()
    pipe = LIOPipeline(cfg, device=device)
    cuda = pipe.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gt, scan_ms, syncs, torch_syncs, outs = [], [], [], [], []
    launches = {name: [] for name in fns}
    for f in fns.values():
        f.launches = 0
    host_syncs.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for i, g in enumerate(groups):
                if pipe.inited:
                    gt.append(g["gt_pos"])
                l0 = {name: f.launches for name, f in fns.items()}
                s0, w0 = host_syncs.count, len(caught)
                capture[0] = i in check_scans
                setattr(measurement, kernel, spy)
                t0 = time.perf_counter()
                try:
                    out = pipe.process_scan(
                        g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                        g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
                    n_torch = sum("synchroniz" in str(w.message)
                                  for w in caught[w0:])
                    if cuda:
                        torch.cuda.synchronize()
                finally:
                    setattr(measurement, kernel, real)
                dt = time.perf_counter() - t0
                if out is not None:
                    scan_ms.append(1e3 * dt)
                    for name, f in fns.items():
                        launches[name].append(f.launches - l0[name])
                    syncs.append(host_syncs.count - s0)
                    torch_syncs.append(n_torch)
                    outs.append(out)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    totals = {name: f.launches for name, f in fns.items()}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    compare = KERNELS[kernel]
    checks = [compare(*c) for c in captured]
    return {"traj": np.array(pipe.trajectory), "gt": np.array(gt),
            "n_scans": len(groups),
            "seconds": time.perf_counter() - t_run,
            "scan_ms": scan_ms, "launches": launches, "syncs": syncs,
            "torch_syncs": torch_syncs, "widths": widths,
            "outs": outs, "totals": totals, "checks": checks,
            "peak_bytes": peak, "dmom_built": pipe.ls.map.dmom is not None}


def run_window_path(name: str, cfg, groups, gate_end: float, gate_ate: float,
                    per_scan: dict) -> dict:
    """Drive LIOPipeline as bench.py:388-389 does (pipelined, window W,
    quantized, unroll min(W, 8)) over `groups` and check it.

    The warmup windows run eagerly; the first steady window warms up on
    its first graph's worth of scans and captures the steady step as a
    CUDA graph; every later window is one pinned copy and W / steps graph
    replays.  The first K1 call of each width in every captured tick
    (pass 0) also writes its inputs and outputs into probe buffers, made
    and zeroed by the eager warm-up ticks, through a device select: a
    replay overwrites them only when its input has a nonzero entry
    (outdoors a tick whose live lanes overflow the compacted buffer
    passes zeros; a padded slot passes rows with no valid lane, G = 0).  After the run the probes hold each
    slot's last such call and are held against the plain version; every
    width must have at least one (`k1_graph_checks`).  The probes add a
    few small kernels to each tick of the graph.  The steady windows after the
    capture run under torch.cuda.set_sync_debug_mode("error"): any sync
    torch reports raises (the readback waits on a CUDA event, which it
    does not report), so their torch syncs are 0; their port reads are
    the readbacks consumed.  K1's launches inside the graph are its kernel
    nodes (which must match its calls at capture) times the replays
    StepGraph counts.  Then device_ms_per_scan (chain_device_ms): the
    median, on the graph with the probes and on the pipeline's graph
    captured anew without them (the headline)."""
    import torch

    from better_fastlio2_tpu_torch.core import measurement
    from better_fastlio2_tpu_torch.ops import kernels
    from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
    from better_fastlio2_tpu_torch.utils.device import host_syncs

    W = WINDOW[name.split("_")[1]]
    real = kernels.fused_normal_eqs
    spare: list[list] = []  # zeroed probe buffers, one per tick and width
    probes: list[list] = []  # K1 (soa, params, G, mv) of each tick's pass 0
    seen: set[int] = set()  # widths already met in the current tick

    def spy(soa, params):
        out = real(soa, params)
        if pipe.graph is None or soa.shape[1] in seen:
            return out  # not a steady tick's pass 0
        seen.add(soa.shape[1])
        call = (soa, params, *out)
        if not torch.cuda.is_current_stream_capturing():  # eager warm-up
            spare.append([torch.zeros_like(t) for t in call])
            return out
        bufs = spare.pop(0)
        live = torch.any(soa != 0)
        for b, t in zip(bufs, call):
            b.copy_(torch.where(live, t, b))
        probes.append(bufs)
        return out

    t_run = time.perf_counter()
    pipe = LIOPipeline(cfg, pipelined=True, window=W, quantized=True,
                       unroll=min(W, 8))
    tick = pipe._tick  # the steady tick the graph captures

    def probed_tick(*args):
        seen.clear()
        return tick(*args)

    pipe._tick = probed_tick
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        getattr(kernels, k).launches = 0
    gt, t_steady, n_steady = [], None, 0
    measurement.fused_normal_eqs = spy
    try:
        for g in groups:
            if pipe.inited:
                gt.append(g["gt_pos"])
            if t_steady is None and pipe.graph is not None and not pipe._wbuf:
                torch.cuda.synchronize()  # the steady windows start here
                t_steady, host_syncs.count = time.perf_counter(), 0
            if t_steady is not None:
                n_steady += 1
                torch.cuda.set_sync_debug_mode("error")
            try:
                pipe.process_scan(
                    g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                    g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        pipe.flush()
        torch.cuda.synchronize()
        t_end, reads = time.perf_counter(), host_syncs.count
    finally:
        measurement.fused_normal_eqs = real
    peak = torch.cuda.max_memory_allocated()
    graph = pipe.graph
    if graph is None or not n_steady:
        fail(f"{name}: the steady program was never captured and replayed")
    launches = {k: getattr(kernels, k).launches for k in KERNELS}
    if launches["fused_hth"]:
        fail(f"{name}: the path launched fused_hth: {launches}")
    # pass 0's K1 calls, refreshed by every replay, against the plain version
    checks = [compare_k1(*p) for p in probes]
    if spare or len(checks) != graph.steps * len({c["n"] for c in checks}):
        fail(f"{name}: {len(checks)} K1 probes ({len(spare)} unused) in a "
             f"graph of {graph.steps} ticks")
    by_width = {}
    for c in checks:
        b = by_width.setdefault(c["n"], {"calls": 0, "live": 0,
                                         "max_err_over_tol": 0.0})
        b["calls"] += 1
        b["live"] += c["max_abs_G"] > 0
        b["max_err_over_tol"] = max(b["max_err_over_tol"],
                                    c["max_err_over_tol"])
    if not all(b["live"] for b in by_width.values()):
        fail(f"{name}: a K1 width never ran on live lanes in the graph: "
             f"{by_width}")
    traj = np.array(pipe.trajectory)
    if len(traj) != len(groups) - 1 or not np.all(np.isfinite(traj)):
        fail(f"{name}: trajectory has {len(traj)} rows or non-finite values")
    ate, end = accuracy(traj, np.array(gt))
    if end > gate_end or ate > gate_ate:
        fail(f"{name} accuracy gate: end error {end:.4f} m (<= {gate_end}),"
             f" ATE {ate:.4f} m (<= {gate_ate})")
    steps = graph.steps
    # K1 inside the graph: its kernel nodes (by K1's function handle), one
    # for each K1 call the wrapper counted at capture, where nothing ran
    k1_nodes = graph.nodes["fused_normal_eqs"]
    k1_captured = graph.captured_launches["fused_normal_eqs"]
    if k1_nodes != k1_captured:
        fail(f"{name}: the graph holds {k1_nodes} K1 kernel nodes for "
             f"{k1_captured} K1 calls at capture")
    # the graph launches counted in StepGraph.replay, against the capture
    # window's replays after its warm-up ticks plus every later steady
    # window's (a flushed partial window counts whole): fewer means a
    # steady window ran eagerly
    replays = graph.replays
    expected = (W - steps) // steps + (-(-n_steady // W)) * (W // steps)
    if replays != expected:
        fail(f"{name}: {replays} graph replays, {expected} expected")
    nodes = graph.nodes
    capture_s = graph.capture_s
    probed = chain_device_ms(pipe, groups, W)
    # the pipeline's own graph, captured anew without the K1 probes
    del graph
    pipe._tick, pipe.graph = tick, None
    device = chain_device_ms(pipe, groups, W)
    out = {
        "phase": name, "scans": len(traj), "window": W, "unroll": min(W, 8),
        "graph_steps": steps, "seconds": time.perf_counter() - t_run,
        "ms_per_scan_steady": 1e3 * (t_end - t_steady) / n_steady,
        "ms_per_scan_per_scan_phase": per_scan["ms_per_scan_median"],
        "device_ms_per_scan": device["median"],
        "device_ms_per_scan_min": device["min"],
        "device_ms_groups": device["groups"],
        "device_ms_per_scan_probed": probed["median"],
        "device_ms_groups_probed": probed["groups"],
        "capture_s": capture_s,
        "capture_s_unprobed": pipe.graph.capture_s,
        "graph_nodes_per_step": nodes["nodes"] / steps,
        "graph_kernel_nodes_per_step": nodes["kernel_nodes"] / steps,
        "graph_kernel_nodes_per_step_unprobed": (
            pipe.graph.nodes["kernel_nodes"] / steps),
        "k1_launches_per_steady_scan": k1_nodes / steps,
        "k1_launches_python": launches["fused_normal_eqs"],
        # eager calls (the wrapper's count less the capture's calls, which
        # ran nothing) plus the graph's K1 nodes at every counted replay
        "k1_launches_executed": (launches["fused_normal_eqs"] - k1_captured
                                 + k1_nodes * replays),
        "graph_replays": replays, "steady_scans": n_steady,
        "port_reads_per_steady_window": reads * W / n_steady,
        "torch_syncs_per_steady_window": 0,
        "sync_debug_mode_steady": "error",
        "max_memory_allocated": peak,
        "ate_m": ate, "end_err_m": end,
        "gate": {"end_err_m": gate_end, "ate_m": gate_ate},
        "k1_graph_checks": by_width,
        "checks": checks,
    }
    print(json.dumps(out), flush=True)
    return out


def chain_device_ms(pipe, groups, W) -> dict:
    """Device milliseconds per scan of the steady graph (bench.py:487-520):
    CHAIN_WINDOWS distinct windows of the last scans, packed as the
    pipeline packs them (last_end_rel 0, as bench.py repacks) and put on
    the device, replayed back to back on the pipeline's final state with
    CUDA events around each group of them (under sync debug "error");
    the minimum and the median of CHAIN_GROUPS groups.  A pipeline whose
    graph is None captures it on the first window (the untimed warm
    one)."""
    import torch

    wins = []
    for c in range(CHAIN_WINDOWS):
        lo = len(groups) - (CHAIN_WINDOWS - c) * W
        rows = [pipe._pack_quant(
            *pipe._pad_points(g["pts"], g["pt_t"]),
            *pipe._pad_imu(g["imu_acc"], g["imu_gyr"], g["imu_t"]),
            0.0, float(g["scan_end_t"])) for g in groups[lo:lo + W]]
        wins.append(pipe._pack_window(rows).to("cuda"))
    pipe._run_graph(wins[0])  # warm
    torch.cuda.synchronize()
    group_ms = []
    for _ in range(CHAIN_GROUPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            s.record()
            for w in wins:
                pipe._run_graph(w)
            e.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        e.synchronize()
        group_ms.append(s.elapsed_time(e) / (CHAIN_WINDOWS * W))
    return {"min": float(np.min(group_ms)),
            "median": float(np.median(group_ms)), "groups": group_ms}


def accuracy(traj: np.ndarray, gt: np.ndarray) -> tuple[float, float]:
    """ATE and end error as bench.py computes them: displacements from the
    first tracked scan."""
    n = min(len(traj), len(gt))
    est = traj[:n, :3] - traj[0, :3]
    ref = gt[:n] - gt[0]
    err = np.linalg.norm(est - ref, axis=1)
    return float(np.sqrt(np.mean(err ** 2))), float(err[-1])


def summarize(name: str, res: dict, kernel: str, gate_end: float,
              gate_ate: float, program_warmup: int = 0) -> dict:
    """Check one main-path run (every scan tracked and finite; `kernel`
    launched on every updated scan, the other kernel never; the inputs of
    every check scan captured; the accuracy gate) and print its line.
    program_warmup > 0 (the bench paths): the first that many scans ran
    the warmup program; ms/scan, port reads and torch syncs are given for
    them and for the steady scans apart, and the steady program must
    have built the dense moment table."""
    traj = res["traj"]
    if len(traj) != res["n_scans"] - 1 or not np.all(np.isfinite(traj)):
        fail(f"{name}: trajectory has {len(traj)} rows or non-finite values")
    # every scan but the first (which only builds the map) runs the update
    per_scan = res["launches"][kernel]
    starved = [i for i, n in enumerate(per_scan[1:], 1) if n < 1]
    if starved or res["totals"][kernel] < 1:
        fail(f"{name}: {kernel} launched {res['totals'][kernel]} times; "
             f"scans without a launch: {starved[:10]}")
    others = {k: v for k, v in res["totals"].items() if k != kernel}
    if any(others.values()):
        fail(f"{name}: the path launched kernels it does not run: {others}")
    if len(res["checks"]) < len(CHECK_SCANS):
        fail(f"{name}: the path's {kernel} inputs were not captured on "
             "every check scan")
    if program_warmup and not res["dmom_built"]:
        fail(f"{name}: the steady program never built the dense moment "
             "table")
    ate, end = accuracy(traj, res["gt"])
    if end > gate_end or ate > gate_ate:
        fail(f"{name} accuracy gate: end error {end:.4f} m (<= {gate_end}),"
             f" ATE {ate:.4f} m (<= {gate_ate})")
    n_ds = [o["n_ds"] for o in res["outs"]]
    n_eff = [o["n_eff"] for o in res["outs"]]
    # scan_ms[i] is the (i + 1)-th scan through a step program
    first = program_warmup or WARMUP_SCANS
    steady = res["scan_ms"][first:]
    out = {
        "phase": name, "scans": len(traj), "kernel": kernel,
        "seconds": res["seconds"],
        "ms_per_scan_median": float(np.median(steady)),
        "ms_per_scan_p90": float(np.percentile(steady, 90)),
        "launches_total": res["totals"][kernel],
        "launches_per_scan": float(np.mean(per_scan[1:])),
        "port_reads_per_scan": float(np.mean(res["syncs"][1:])),
        "torch_syncs_per_scan": float(np.mean(res["torch_syncs"][1:])),
        "max_memory_allocated": res["peak_bytes"],
        "ate_m": ate, "end_err_m": end,
        "gate": {"end_err_m": gate_end, "ate_m": gate_ate},
        "n_ds_mean": float(np.mean(n_ds)), "n_ds_min": int(np.min(n_ds)),
        "n_ds_max": int(np.max(n_ds)), "n_eff_mean": float(np.mean(n_eff)),
        "map_voxels_final": res["outs"][-1]["map_voxels"],
        "checks": res["checks"],
    }
    if program_warmup:
        # the warmup program's scans but the first, which only builds the
        # map, against the steady program's
        w = slice(1, program_warmup)
        st = slice(program_warmup, None)
        out.update({
            "ms_per_scan_warmup_median": float(np.median(
                res["scan_ms"][w])),
            "launches_per_scan_warmup": float(np.mean(per_scan[w])),
            "launches_per_scan_steady": float(np.mean(per_scan[st])),
            "port_reads_per_scan_warmup": float(np.mean(res["syncs"][w])),
            "port_reads_per_scan_steady": float(np.mean(res["syncs"][st])),
            "torch_syncs_per_scan_warmup": float(np.mean(
                res["torch_syncs"][w])),
            "torch_syncs_per_scan_steady": float(np.mean(
                res["torch_syncs"][st])),
            "dmom_built": res["dmom_built"],
            "launches_by_width": {str(k): v for k, v in
                                  sorted(res["widths"].items())},
        })
    if name in JAX_ROOM_REF:
        out["jax_cpu_f32_ate_end_m"] = JAX_ROOM_REF[name]
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    # the smoke runs on one card: make it the only one CUDA sees
    os.environ["CUDA_VISIBLE_DEVICES"] = first_card()
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    try:
        import better_fastlio2_tpu_torch  # noqa: F401
        from better_fastlio2_tpu_torch.io.synthetic import make_bench_sequence
    except ImportError as e:
        fail(f"the port is not importable from here: {e}")
    card = card_line()
    phase_build()
    floor_us = launch_floor_us()
    k1 = phase_kernels(floor_us)
    k2 = phase_k2(floor_us)
    t0 = time.perf_counter()
    groups = make_bench_sequence("room", N_SCANS)
    print(json.dumps({"phase": "sequence", "scans": N_SCANS,
                      "seconds": time.perf_counter() - t0}), flush=True)
    main_out = summarize("main", run_main_path(room_config(), groups),
                         "fused_normal_eqs", 0.030, 0.15)
    row = summarize("row", run_main_path(row_config(False), groups,
                                         "fused_hth"), "fused_hth",
                    0.030, 0.15)
    row_ext = summarize("row_ext", run_main_path(row_config(True), groups,
                                                 "fused_hth"), "fused_hth",
                        0.15, 0.15)
    bench_room = summarize(
        "bench_room", run_main_path(bench_config("room"), groups),
        "fused_normal_eqs", 0.030, 0.15, program_warmup=PLANE_CACHE_WARMUP)
    t0 = time.perf_counter()
    outdoor = make_bench_sequence("outdoor", N_SCANS_OUTDOOR)
    print(json.dumps({"phase": "sequence_outdoor", "scans": N_SCANS_OUTDOOR,
                      "seconds": time.perf_counter() - t0}), flush=True)
    res = run_main_path(bench_config("outdoor"), outdoor,
                        check_width=SOLVE_COMPACT)
    compacted = res["widths"].get(SOLVE_COMPACT, 0)
    if not compacted:
        fail(f"bench_outdoor: no K1 launch ran on the compacted (16, "
             f"{SOLVE_COMPACT}) buffer: {res['widths']}")
    if not any(c["n"] == SOLVE_COMPACT for c in res["checks"]):
        fail("bench_outdoor: K1 was not re-checked on a compacted call")
    bench_outdoor = summarize("bench_outdoor", res, "fused_normal_eqs",
                              0.136, 0.68, program_warmup=PLANE_CACHE_WARMUP)
    del res
    room_w = run_window_path("bench_room_window", bench_config("room"),
                             groups, 0.030, 0.15, bench_room)
    outdoor_w = run_window_path("bench_outdoor_window",
                                bench_config("outdoor"), outdoor, 0.136,
                                0.68, bench_outdoor)
    del outdoor
    lib = phase_library_graph()
    phase_one_launch()
    print(json.dumps({"phase": "total",
                      "seconds": time.perf_counter() - t_start}), flush=True)
    k1_err = max(c["max_abs_err"] for c in k1["checks"] + main_out["checks"]
                 + bench_room["checks"] + bench_outdoor["checks"]
                 + room_w["checks"] + outdoor_w["checks"])
    k1_by_phase = {p["phase"]: p["launches_total"] for p in
                   (main_out, bench_room, bench_outdoor)}
    k1_by_phase.update({p["phase"]: p["k1_launches_executed"]
                        for p in (room_w, outdoor_w)})
    k2_err = max(c["max_abs_err"] for c in
                 k2["checks"] + row["checks"] + row_ext["checks"])
    k2_t = k2["timing"]["ext"]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_normal_eqs",
        "route": "cuda",
        "source": "better_fastlio2_tpu_torch/csrc/fused_normal_eqs.cu",
        "replaces": "better_fastlio2_tpu/ops/pallas_kernels.py:147",
        # the window phases' launches inside graph replays counted from
        # the captured graph (the wrapper's count sees only the capture)
        "launches": sum(k1_by_phase.values()),
        "launches_by_phase": k1_by_phase,
        "max_abs_err": k1_err,
        "ms": k1["ms"],
        "device_us": k1["device_us"],
        "ms_compact": k1["ms_compact"],
        "device_us_compact": k1["device_us_compact"],
        "bound_ms_compact": k1["bound_ms_compact"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "library_device_us": lib["k1_library_device_us"],
        "launch_floor_us": floor_us,
    }, {
        "name": "fused_hth",
        "route": "cuda",
        "source": "better_fastlio2_tpu_torch/csrc/fused_hth.cu",
        "replaces": "better_fastlio2_tpu/ops/pallas_kernels.py:262",
        "launches": row["launches_total"] + row_ext["launches_total"],
        "max_abs_err": k2_err,
        "ms": k2_t["ms"],
        "device_us": k2_t["device_us"],
        "plain_ms": k2_t["plain_ms"],
        "bound_ms": k2_t["bound_ms"],
        "bound_by": k2_t["bound_by"],
        "library_ms": k2_t["library_ms"],
        "library_device_us": lib["k2_library_device_us"]["ext"],
        "launch_floor_us": floor_us,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
