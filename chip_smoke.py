#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build   — compile every kernel of the port from its sources (nvcc,
               sm_90a), one compiler per source, all started together;
               print each kernel's registers, shared memory and spills
               (ptxas -v; any spill fails), and the thread-block cluster
               size each kernel's setup took on this card;
     (after the build: `if_node_cost`, the graph-replayed device time of
     one CUDA-graph IF node around a one-element fill, taken and
     skipped, beside the bare fill)
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
     imu     — the IMU stage kernel (csrc/imu_stage.cu) against its plain
               version (core/imu.py:propagate + undistort) on the card at
               both cells' shapes (M = 16 and 32 IMU rows, n = 32768
               points; valid prefixes of M, 1, 2 and M - 1 rows) within
               compare_imu_stage's tolerance, two runs bit-identical; its
               `ms`, `device_us`, the plain version's `plain_ms` and
               `plain_device_us` (one call replayed from a graph) and the
               bound at each cell's shape; every per-scan path (phases
               4-8) must run it once a ticked scan;
  4. main    — run LIOPipeline, the port's entry point, over 240 scans of
               the room benchmark sequence at the full bench shapes on the
               fused single-association path (slice 1), count the kernel
               launches of that run and its host syncs (the port's own
               reads through utils.device.to_host, and every synchronising
               call torch reports under set_sync_debug_mode("warn")),
               re-check K1 on three of
               its scans, and gate the trajectory on the room accuracy gate
               of bench.py (end error <= 0.030 m, ATE <= 0.15 m).  Per
               scan (phases 4-8, 13's per-scan run, 14 and 18) each
               scan replays its program's one-tick CUDA graph (slice 9),
               but each program's first, which runs eagerly and captures
               it: the phase fails unless every other scan replayed and
               a replayed scan made at most one torch sync (the info
               readback); the graph holds CUDA-graph conditional (IF)
               nodes for the ESIKF passes after the first, the refresh,
               the compaction, the two K1 widths and the row form's
               re-association (slice 10; printed a tick with the nodes
               inside their bodies), the kernel's kernel nodes (found by
               its handle, bodies included) equal its calls at capture,
               and the launches the replays ran, counted on the device,
               must equal what each replayed scan's ESIKF passes and
               refresh imply (K1 once a pass and once for a refresh's
               re-solve, K2 once a pass; passes and refresh fires a scan
               printed); its first call inside an ESIKF pass body is read
               back from probe buffers the capture wrote, with a ran flag
               (GraphProbe), on the first replay from each check scan on
               that ran that body; the first 24 scans run
               again with eager ticks (graphed=False) and must equal the
               replays bit for bit; nvidia-smi's SM clock, power and
               temperature are sampled every 40 scans; peak memory is
               given allocated and reserved (the graph pools);
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
               nodes, conditional nodes and K1 kernel nodes per step (by
               K1's handle, bodies included, equal to its calls at
               capture), the replays counted, and its capture time; the
               passes and refresh fires a steady scan and the K1
               launches the replays ran (on the device, against what the
               passes imply); port reads and torch syncs per steady
               window; peak
               memory with the graph's pool; K1's first call inside an
               ESIKF pass body of each tick held against the plain
               version where the body ran;
               every scan's wire row packed by the C++ packer
               (io/native.py, counted);
 10. bench_outdoor_window — the same on the outdoor sequence with
               window=16 (unroll 8: two replays a window), K1 inside the
               graph checked at the widths whose IF body ran (8192 and
               10240);
 11. slam    — bench.py --slam (slice 5) through SLAMPipeline: the room
               bench configuration in the window driver of phase 9 with
               keyframes, loop closure and the pose-graph back end on the
               host CPU (async back end, loop worker thread) over bench.py's
               240-scan loop-closing outdoor circle; bench.py's gates (a
               loop closed, corrected keyframe ATE <= max(0.25 m, odometry
               keyframe ATE)); steady ms/scan beside bench_room_window's,
               port reads and torch syncs (sync debug "warn") per steady
               window, K1 launches in the graph, the corrections that
               reached the captured graph, peak memory, and the back end's
               host ms for one descriptor, one loop verification (SC gate
               + ICP) and one optimize(6, 50);
 12. backend_cuda — the back end on the card on the slam phase's
               keyframes (descriptors, a loop verification, optimize): two
               runs bit-identical in f32; in f64 equal to the CPU port
               (descriptors exactly, ICP 1e-8, poses 1e-9);
 13. slam_handoff — on the room sequence, a +1 m correction forced
               through _apply_correction once the graph is captured and
               replayed: the pose feedback and map reset reach the graph
               (the map holds the shifted keyframe cloud, the replays go
               on), the trajectory equals an all-eager run bit for bit, and
               the next window follows the shifted frame; then the same
               per scan (`slam_handoff_per_scan`: the front end's one-tick
               steady graph), with its steady ms/scan, torch syncs and
               peak memory;
 14. dynamic — `run.py mapping --dataset synthetic-outdoor --dynamic`
               through the port's SLAMPipeline on the card (slice 6):
               LIOConfig() defaults (the row path with extrinsic
               estimation, K2 on every pass), loop closure off, the 2 m
               mount, the appearance test (run.py:97-116), over 80 scans
               of the labelled outdoor sequence; each scan's removal mask
               scored against gt_dynamic after the first 24 (F1 >= 0.60,
               precision >= 0.85, and precision, recall and F1 within
               0.01 of the JAX package's on the same run,
               tools/dynamic_reference.py) and the trajectory's ATE
               (<= 0.68 m), beside the JAX package's round-5 record; K2's
               first call and its first call from each of three fixed
               scans on, at the path's width n_ds = 32768, held against
               the plain version; the perception step's host ms per
               scan (ground, encode+cluster, appearance), cluster_grid's
               sweeps and host reads, port reads and torch syncs per scan,
               the front end's ms per scan, K1/K2 launches, peak memory;
 15. dynamic_window — the same in the window driver (pipelined, W = 8,
               quantized, unroll 8; the row program's windows replay one
               captured graph of 8 ticks),
               held to the JAX package's own window-mode figures within
               0.01 and the outdoor ATE gate; the F1 >= 0.60 / precision
               >= 0.85 gates are reported, not held (the reference's
               appearance test keeps less than half its precision there:
               the pose extrapolated over the result lag misplaces the
               scan);
 16. perception_cuda — on three scans of `dynamic`: estimate_ground,
               encode_scan + cluster_grid, recognize_pd, track_pd,
               dynamic_removal_masks and appearance_dynamic_mask give the
               same bits on two f32 runs, and in f64 equal the CPU port
               (masks and labels; the ground mask outside the patches
               whose plane fit was rank-deficient);
 17. apps    — MultiSessionMerger (the slam phase's keyframes against a
               query session under a known anchor), OnlineRelocalizer (the
               slam sequence's second lap, odometry in an offset frame),
               ObjectUpdater (a box kept, one planted in one session,
               another in the other) and register_fpfh_gnc (two samples
               of tests/test_certifiable.py's scene under a 120-degree
               yaw) on the card: the mirrored JAX tests' gates, two f32
               runs bit-identical, f64 equal to the CPU port within each
               app's printed tolerance (1e-8 m/rad; the merge 1e-4 with
               its loops equal), and each app's host ms; the merge at
               a wider anchor (0.5 rad) and the registration of a
               keyframe scan's halves reported, not gated
               (tools/apps_reference.py runs the JAX package on the same
               inputs);
 18. cli     — the port's CLI end to end (slice 7): the room sequence
               written as a KITTI raw-sync directory (each cloud in its
               scan-end frame) and the bench configuration as a YAML file;
               `run.py mapping --dataset kitti:<dir> --config <yaml>
               --state-log` over all 240 scans (K1 on every updated scan,
               two of its calls held against the plain version; the room
               gate on pos_log.txt; the session and
               fast_lio_time_log.csv read back); its first 40 rows equal
               to SLAMPipeline.process_scan's in this process string for
               string; `online_relo` (LIOConfig() defaults: K2 on every
               pass, two calls held against the plain version; 12 frames,
               initialized, relo frames), `multi_session` and
               `object_update` of the session with itself; the C++ host
               library built and loaded, and the window phases' rows all
               packed by it; seconds of each subcommand, of writing and
               of loading the directory;
 19. spmd_room_window — the SPMD window step (slice 8) at world size 1
               under NCCL in this process: bench_room_window's
               configuration unquantized (a mesh takes the unquantized
               wire), W = 8, unroll 8, the 240 room scans through
               LIOPipeline(mesh=), the steady windows replaying one graph
               with the collectives captured in it, beside the same scans
               without a mesh (`spmd_ref_room_window`, whose gates are
               IF nodes; the mesh step keeps its selects: no conditional
               node, or the phase fails); the trajectories
               within 1e-6 m (bit-identical expected), the room gate, 0
               torch syncs in the steady windows, the graph's kernel,
               K1, NCCL and memcpy nodes a tick and the collectives a
               tick runs, K1 held to plain on a live warmup call and in
               the graph; then one rank's share of a 2- and a 4-rank
               program (override_ndev) timed on 48 scans, not gated;
 20. spmd_two_rank — two ranks sharing the card through
               parallel/launch.py (gloo: collectives staged through the
               host, eager ticks, "graphed": false): the SPMD window step
               over the first 64 room scans, both ranks bit-identical and
               within 2e-3 m of phase 19, K1 at n_ds / 2 held to plain in
               each rank; then the ownership-sharded step over 24 scans,
               both ranks bit-identical, K2 (6 columns) at n_ds / 2 held
               to plain, it and a one-rank run (this process, the NCCL
               mesh) held to the reference test's gate (ATE < 0.15 m, end
               < 0.2 m); a rank that fails, hangs or times out fails the
               smoke;
 21. library_graph — the library calls' device time per call (graph
               replay), after the paths so that the cuBLAS workspace of
               the capturing stream does not count in their peak memory;
 22. one_launch — under torch.profiler, one call of K1 and of K2 in each
               mode runs exactly one device kernel (run last, so that the
               profiler cannot touch the timed paths).

`python chip_smoke.py --only-slam` runs the build and phases 11-13 alone,
`--only-spmd` the build, `bench_room` and phases 19-20,
`--only-perception` the build, phases 14-17 and the slam phase whose
keyframes the apps take, and `--only-cli` the build and phase 18 (with
no window phase to count packed rows); none prints a result line
(development runs).
`--save-app-inputs DIR` keeps the apps phase's sessions and clouds in DIR
for tools/apps_reference.py.

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


def device_kernels(fn, sessions: int = 3) -> list[str]:
    """The names of the device kernels that one call of `fn` runs, from
    torch.profiler's CUDA activities (after a call outside the profiler,
    so that building and setup are not in it).  A session that records no
    device activity at all is taken again, up to `sessions` in all: on the
    H100 a session once returned no CUDA event for a call that had run its
    kernel (the same call's next session saw it).  A call that runs no
    kernel still returns []."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


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


IMU_CELLS = {"hdl64_street_scan": (16, 32768), "vlp16_room_scan": (32, 32768)}
# gyr_cov, acc_cov, b_gyr_cov, b_acc_cov of lio_bench/configs/<config>.json
IMU_COVS = {"hdl64_street_scan": (0.0015636343949698187, 0.003993957088823881,
                                  3.564031869636761e-05,
                                  6.435665935353257e-05),
            "vlp16_room_scan": (0.1, 0.1, 1e-4, 1e-4)}


def _unit(v):
    return v / np.linalg.norm(v)


def imu_stage_case(M: int, n: int, seed: int, n_valid: int | None = None,
                   turn: float = 0.5, last_end_after_first: bool = True,
                   covs=(0.1, 0.1, 1e-4, 1e-4), full_q: bool = False,
                   dtype=None):
    """Seeded inputs of one scan's IMU stage, as core/imu.py:stage takes
    them: a dict of CPU tensors (float64 unless `dtype`).  M IMU rows of
    which the first `n_valid` (default M) are valid, spread so that the
    valid ones span the scan (0.1 s; sample 0 before its begin, the last
    before its end, so the final hop is not empty), the rest padding (t =
    inf, zero rates); a turn of `turn` rad/s about the body z axis at
    ~3 m/s; last_scan_end_t after sample 0 (`last_end_after_first`) or
    before it; n points within ~60 m timed from before the first pose to
    after the scan end, some at exactly a pose's time; a random SPD P;
    Q from `covs` (build_Q's diagonal) or, `full_q`, that plus a random
    SPD part (the kernel takes any Q: a full one shows every block of
    the noise map Fw in Fw Q Fw^T)."""
    import torch

    from better_fastlio2_tpu_torch.core import imu, state

    rng = np.random.default_rng(seed)
    n_valid = M if n_valid is None else n_valid
    h = 0.1 / max(n_valid - 1, 1)
    t = np.full(M, np.inf)
    t[:n_valid] = h * (np.arange(n_valid) - 0.3)
    acc = np.zeros((M, 3))
    gyr = np.zeros((M, 3))
    acc[:n_valid] = (np.array([0.4, -0.2, 9.75])
                     + rng.normal(size=(n_valid, 3)) * 0.05)
    gyr[:n_valid] = (np.array([0.01, -0.02, turn])
                     + rng.normal(size=(n_valid, 3)) * 0.01)
    mask = np.arange(M) < n_valid
    last_end = t[0] + (0.5 * h if last_end_after_first else -0.5 * h)
    q = _unit(rng.normal(size=4))
    off_r = _unit(np.array([1.0, 0.01, -0.02, 0.015]))
    grav = _unit(np.array([0.02, -0.03, -1.0])) * 9.809
    A = rng.normal(size=(23, 23)) * 0.01
    P = (state.init_P(torch.float64).numpy() + A @ A.T)
    Q = imu.build_Q(*covs, dtype=torch.float64).numpy()
    if full_q:
        B = rng.normal(size=(12, 12)) * 0.01
        Q = Q + B @ B.T
    pts = rng.uniform(-60.0, 60.0, size=(n, 3))
    pt_t = rng.uniform(-0.02, 0.12, size=n)
    ties = rng.integers(0, max(n_valid, 1), size=min(n, 8))
    pt_t[:len(ties)] = t[ties]
    case = dict(
        x=state.State(pos=rng.normal(size=3), rot=q, off_r=off_r,
                      off_t=np.array([0.1, -0.05, 0.2]),
                      vel=np.array([3.0, 0.2, 0.05]),
                      bg=rng.normal(size=3) * 1e-3,
                      ba=rng.normal(size=3) * 1e-2, grav=grav),
        P=P, acc=acc, gyr=gyr, t=t, mask=mask,
        Q=Q,
        acc_norm=np.array(9.79), last_scan_end_t=np.array(last_end),
        scan_end_t=np.array(0.1), last_acc_w=rng.normal(size=3) * 0.1,
        last_gyr_b=rng.normal(size=3) * 0.1, pts=pts, pt_t=pt_t)
    case = {k: (state.State(*map(torch.as_tensor, v))
                if isinstance(v, state.State) else torch.as_tensor(v))
            for k, v in case.items()}
    return imu_stage_on(case, dtype=dtype)


def imu_stage_on(case, device=None, dtype=None) -> dict:
    """The case's tensors on `device`, its floating ones as `dtype`."""
    import torch

    def mv(v):
        return v.to(device=device, dtype=None if v.dtype == torch.bool
                    else dtype)

    return {k: (type(v)(*map(mv, v)) if isinstance(v, tuple) else mv(v))
            for k, v in case.items()}


def imu_stage_call(c):
    """core/imu.py:stage on the case's tensors: (x_fin, P_fin, poses,
    pts_body); the kernel where they are on the card."""
    from better_fastlio2_tpu_torch.core import imu

    return imu.stage(c["x"], c["P"], imu.ImuBatch(c["acc"], c["gyr"],
                                                  c["t"], c["mask"]),
                     c["Q"], c["acc_norm"], c["last_scan_end_t"],
                     c["scan_end_t"], c["last_acc_w"], c["last_gyr_b"],
                     c["pts"], c["pt_t"])


def imu_stage_plain(c):
    """The plain version (core/imu.py:propagate, then undistort) on the
    case's tensors, wherever they are."""
    from better_fastlio2_tpu_torch.core import imu

    b = imu.ImuBatch(c["acc"], c["gyr"], c["t"], c["mask"])
    x, P, poses = imu.propagate(c["x"], c["P"], b, c["Q"], c["acc_norm"],
                                c["last_scan_end_t"], c["scan_end_t"],
                                c["last_acc_w"], c["last_gyr_b"])
    return x, P, poses, imu.undistort(x, poses, c["pts"], c["pt_t"])


def imu_stage_tensors(out) -> list:
    """Every tensor of one stage result, in order."""
    x, P, poses, pts = out
    return [*x, P, *poses, pts]


def imu_stage_arrays(out) -> dict:
    """The named float64 CPU arrays of one stage result."""
    x, P, poses, pts = out
    named = {f"x.{k}": v for k, v in x._asdict().items()}
    named.update({f"poses.{k}": v for k, v in poses._asdict().items()})
    named.update(P=P, pts_body=pts)
    return {k: v.detach().double().cpu() for k, v in named.items()}


def compare_imu_stage(got, plain, exact64=None, rtol64: float = 1e-10,
                      k32: float = 4.0) -> dict:
    """Hold one IMU stage result `got` against the plain version's
    `plain` on the same inputs, array by array; raises AssertionError
    beyond the tolerance.  Pose times are held equal (a selection, no
    arithmetic).

    float64 (`exact64` None): every array within rtol64 of its largest
    entry (at least 1): the two compute the same formulas and differ by
    the summation order of their sums and products at ~1e-16 a step.

    float32: `exact64` is the plain version's float64 result on the
    same (f32-representable) inputs.  Each array within k32 times the
    plain f32 version's own distance from it, plus 8 float32 epsilons of
    the array's largest entry: two f32 computations of one function that
    round in other places (another device's or library's orders) each
    lie within their rounding error of the exact result.
    Returns each array's largest difference and its tolerance."""
    import torch

    g, p = imu_stage_arrays(got), imu_stage_arrays(plain)
    e = imu_stage_arrays(exact64) if exact64 is not None else None
    if not torch.equal(g["poses.t"], p["poses.t"]):
        raise AssertionError("pose times differ")
    rep = {}
    for k in g:
        if k == "poses.t":
            continue
        scale = max(1.0, float(p[k].abs().max()) if p[k].numel() else 1.0)
        err = float((g[k] - p[k]).abs().max()) if p[k].numel() else 0.0
        if e is None:
            tol = rtol64 * scale
        else:
            own = float((p[k] - e[k]).abs().max()) if p[k].numel() else 0.0
            tol = k32 * own + 8 * float(np.finfo(np.float32).eps) * scale
        if not err <= tol:
            raise AssertionError(f"{k}: max difference {err:.3e} over its "
                                 f"tolerance {tol:.3e}")
        rep[k] = (err, tol)
    return rep


def phase_build() -> None:
    from better_fastlio2_tpu_torch.ops import _build, kernels
    from better_fastlio2_tpu_torch.utils import device

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
    for name in (*KERNELS, "imu_stage"):
        kernels._launcher(name)  # load; K1 / K2 pick the cluster size
    device._set_condition()  # the conditional nodes' condition kernel
    print(json.dumps({"phase": "build", "sources": _build.SOURCES,
                      "compiled": sorted(reports), "seconds": round(dt, 3),
                      "ptxas": ptxas, "setup": kernels.setup_info}),
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


IMU_TIMED_VALID = 11  # valid IMU rows of a 10 Hz scan at 100 Hz
IMU_FLOPS_PER_STEP = 2 * (2 * 23 ** 3 + 23 * 12 * 12 + 23 * 23 * 12)
IMU_FLOPS_PER_ROW = 150  # bracket, rotation increment, four rotations
IMU_BYTES_PER_ROW = 3 * 4 + 4 + 3 * 4  # point and time in, point out


def phase_imu(floor_us: float) -> dict:
    """The IMU stage kernel (csrc/imu_stage.cu) on the card: held against
    its plain version at both cells' shapes (valid prefixes of M, 1, 2,
    M - 1 rows) within compare_imu_stage's tolerance (fails beyond it),
    the values that differ from the plain version's at all counted by
    array (`values_differing`: the kernel takes the plain version's
    rounding orders on the card, so none are expected),
    two runs bit-identical, and timed at each cell's shape with 11 valid
    rows: `ms` (the wrapper's wall through core/imu.py:stage, events),
    `device_us` (graph replay of 100 calls), the plain version's
    `plain_ms` and `plain_device_us` (one call in a replayed graph: what
    a scan's graph spent on the stage before the kernel), the bound
    (bytes of the rows, operations of the covariance chain and the rows)
    beside them."""
    import torch

    checks = []
    for cell, (M, n) in IMU_CELLS.items():
        for n_valid in (M, 1, 2, M - 1):
            c = imu_stage_case(M, n, seed=M + n_valid, n_valid=n_valid,
                               covs=IMU_COVS[cell],
                               last_end_after_first=n_valid % 2 == 0,
                               full_q=n_valid == M, dtype=torch.float32)
            d = imu_stage_on(c, "cuda")
            got = imu_stage_call(d)
            again = imu_stage_call(d)
            exact = imu_stage_call(imu_stage_on(c, dtype=torch.float64))
            torch.cuda.synchronize()
            if not all(torch.equal(u, v) for u, v in zip(
                    imu_stage_tensors(got), imu_stage_tensors(again))):
                fail(f"imu_stage: two runs differ ({cell}, {n_valid} "
                     "valid rows)")
            plain = imu_stage_plain(d)
            try:
                rep = compare_imu_stage(got, plain, exact)
            except AssertionError as e:
                fail(f"imu_stage disagrees with the plain version ({cell},"
                     f" {n_valid} valid rows): {e}")
            differ = {k: int((u != v).sum()) for (k, u), v in zip(
                imu_stage_arrays(got).items(),
                imu_stage_arrays(plain).values())}
            checks.append({
                "cell": cell, "M": M, "n": n, "n_valid": n_valid,
                "values_differing": {k: v for k, v in differ.items() if v},
                "values": sum(a.numel() for a in imu_stage_arrays(
                    got).values()),
                "max_err_over_tol": max(e / t for e, t in rep.values()),
                "pts_body_err_m": rep["pts_body"][0],
                "P_err": rep["P"][0], "pos_err_m": rep["x.pos"][0]})
    timing = {}
    for cell, (M, n) in IMU_CELLS.items():
        d = imu_stage_on(imu_stage_case(
            M, n, seed=1, n_valid=IMU_TIMED_VALID, covs=IMU_COVS[cell],
            dtype=torch.float32), "cuda")
        call = functools.partial(imu_stage_call, d)
        plain = functools.partial(imu_stage_plain, d)
        bytes_moved = IMU_BYTES_PER_ROW * n + 4 * (23 * 23 * 2 + 144
                                                   + 17 * M + 8 * M)
        bound_ms, bound_by = bound(bytes_moved, IMU_FLOPS_PER_STEP * M
                                   + IMU_FLOPS_PER_ROW * n)
        timing[cell] = {
            "M": M, "n": n, "ms": time_ms(call), "device_us": graph_us(call),
            "plain_ms": time_ms(plain),
            "plain_device_us": graph_us(plain, calls=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": bytes_moved}
    out = {"phase": "imu", "checks": checks, "timing": timing,
           "timed_valid_rows": IMU_TIMED_VALID, "launch_floor_us": floor_us,
           "max_err_over_tol": max(c["max_err_over_tol"] for c in checks)}
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
    device kernel, and it is that kernel (the IMU stage through
    core/imu.py:stage at the cells' n = 32768)."""
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
        "imu_stage": ("imu_stage_kernel", functools.partial(
            imu_stage_call, imu_stage_on(imu_stage_case(
                32, 2 * n, seed=1, dtype=torch.float32), "cuda"))),
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


def if_node_cost(floor_us: float) -> dict:
    """The graph-replayed device time of one CUDA-graph IF node around a
    one-element zero_() (its condition kernel, the node and the body),
    taken and skipped, beside the bare zero_() (`floor_us`): what each IF
    node of a step adds (utils/device.if_node inside a step_capture)."""
    import torch

    from better_fastlio2_tpu_torch.utils import device

    x = torch.ones(1, device="cuda")
    out = {"phase": "if_node_cost", "bare_fill_us": floor_us}
    for taken in (True, False):
        pred = torch.tensor(taken, device="cuda")

        def fn():
            if not torch.cuda.is_current_stream_capturing():
                return x.zero_()  # the warm-up
            with device.if_node(pred, "cost"):
                x.zero_()

        with device.step_capture(torch.cuda.MemPool(), x.device):
            out["taken_us" if taken else "skipped_us"] = graph_us(fn)
    print(json.dumps(out), flush=True)
    return out


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
PREFIX_SCANS = 24  # eager ticks held against the graph replays bit for bit
SMI_EVERY = 40  # per-scan phases: nvidia-smi sampled every so many scans


def reset_launches() -> None:
    """Every kernel wrapper's count set to 0, the graphs' counts of the
    calls made while capturing, and the device counters of the launches
    replays ran."""
    from better_fastlio2_tpu_torch.ops import kernels
    from better_fastlio2_tpu_torch.pipeline import graphs

    for k in graphs.KERNELS:
        getattr(kernels, k).launches = 0
        graphs.captured[k] = 0
    kernels.reset_device_launches()


def launches_ran() -> dict:
    """Each kernel's launches that ran since reset_launches: the wrapper's
    count (it counts where it launches, also into a capturing graph)
    less its calls while a graph captured, which ran nothing, plus the
    launches the replays ran, counted on the device beside each launch
    (a conditional body that did not run counts nothing).  Reads the
    device counters: once at the end of a phase, never per scan."""
    from better_fastlio2_tpu_torch.ops import kernels
    from better_fastlio2_tpu_torch.pipeline import graphs

    return {k: getattr(kernels, k).launches - graphs.captured[k]
            + kernels.device_launches(k) for k in graphs.KERNELS}


def implied_launches(kernel: str, iters: int, refreshed: bool) -> int:
    """The launches of `kernel` a scan's update runs in a replay: K1 once
    a pass (one width) and once more for the refresh's re-solve, K2 once
    a pass."""
    return iters + (kernel == "fused_normal_eqs") * int(refreshed)


PROBE_SPAN = 6  # replays kept after a check is due: the first that ran


class GraphProbe:
    """One hand-written kernel (`kernel`, a name of KERNELS) on a path
    whose ticks run eagerly or as CUDA-graph replays; a context that
    wraps core.measurement's call of the kernel and StepGraph's capture
    and replay.

    * `widths`: the kernel's launches that ran, by the width of their
      input (after `finish()`): every eager call on the host, and every
      replayed one on a device counter of its width that the capture
      bumps beside the call (inside the conditional body the call is in,
      so a body that did not run counts nothing).
    * In each capture the first call of each width inside an ESIKF pass
      body (an IF node, utils.device.open_nodes) also clones its inputs
      and outputs inside the graph, so that every replay that runs the
      body rewrites those buffers (probes), and sets a ran flag of its
      own.  Kept for the plain-version check after the run: the eager
      calls numbered in `keep_eager` (1-based), the first eager call of
      width `keep_width`, and, from each replay numbered in
      `keep_replays` and from the next call after `snap()`, the probes
      of up to PROBE_SPAN replays (their flags zeroed before each), of
      which `checks()` holds the first whose body ran (an eager call
      after snap() is kept alone).
    * After each capture its graph's kernel nodes (found by the kernel's
      handle, conditional bodies included) must equal the kernel's calls
      at capture (`graph_nodes` lists both per capture)."""

    def __init__(self, kernel: str, keep_eager=(), keep_width=None,
                 keep_replays=()):
        from better_fastlio2_tpu_torch.core import measurement
        from better_fastlio2_tpu_torch.pipeline import graphs

        self.kernel, self.real = kernel, getattr(measurement, kernel)
        self.keep_eager, self.keep_width = set(keep_eager), keep_width
        self.keep_replays = set(keep_replays)
        self.widths: dict[int, int] = {}
        self.counters: dict = {}  # width -> device count of replayed calls
        self.eager_calls = self.replays = 0
        # (inputs, kwargs, outputs, ran flag or None when eager, group)
        self.kept: list[tuple] = []
        self.graph_nodes: list[tuple[int, int]] = []
        self.body_checks = 0
        self._pending = None
        self._snap = False
        self._span = self._group = 0
        self._real_capture = graphs.StepGraph.warm_up_and_capture
        self._real_replay = graphs.StepGraph.replay

    def _width(self, args) -> int:
        return (args[0].shape[-1] if self.kernel == "fused_normal_eqs"
                else args[0].shape[0])

    @staticmethod
    def _keep(args, kw, out) -> tuple:
        return ([a.clone() for a in args],
                {k: v for k, v in kw.items() if k != "out"},
                [o.clone() for o in out])

    def snap(self) -> None:
        self._snap = True

    def __call__(self, *args, **kw):
        import torch

        from better_fastlio2_tpu_torch.utils.device import open_nodes

        out = self.real(*args, **kw)
        width = self._width(args)
        if self._pending is not None and torch.cuda.is_current_stream_capturing():
            p = self._pending
            if width not in self.counters:
                fail(f"{self.kernel}: width {width} first called in a "
                     "capture")
            self.counters[width].add_(1)
            if "esikf.pass" in open_nodes() and width not in p["probed"]:
                p["probed"].add(width)
                p["flags"][len(p["probes"])].fill_(True)
                p["probes"].append(self._keep(args, kw, out))
            return out
        self.eager_calls += 1
        self.widths[width] = self.widths.get(width, 0) + 1
        if width not in self.counters:
            self.counters[width] = torch.zeros(
                (), dtype=torch.int64, device=args[0].device)
        if (self._snap or self.eager_calls in self.keep_eager
                or (width == self.keep_width and self.widths[width] == 1)):
            self._snap = False
            self.kept.append((*self._keep(args, kw, out), None, None))
        return out

    def _capture(self, graph, ls, rows):
        import torch

        self._pending = {"probed": set(), "probes": [],
                         "flags": torch.zeros(8, dtype=torch.bool,
                                              device=rows.device)}
        try:
            out = self._real_capture(graph, ls, rows)
        finally:
            graph.probe, self._pending = self._pending, None
        nodes = graph.nodes[self.kernel]
        calls = graph.captured_launches[self.kernel]
        if nodes != calls:
            fail(f"a captured graph holds {nodes} {self.kernel} kernel "
                 f"nodes for {calls} calls at capture")
        self.graph_nodes.append((nodes, calls))
        return out

    def _replay(self, graph, rows):
        p = getattr(graph, "probe", None)
        if (self._snap or self.replays + 1 in self.keep_replays) and p:
            self._snap, self._span = False, PROBE_SPAN
            self._group += 1
        keep = self._span > 0 and p is not None and p["probes"]
        if keep:
            p["flags"].zero_()
        out = self._real_replay(graph, rows)
        self.replays += 1
        if keep:
            self._span -= 1
            for j, (ins, kw, outs) in enumerate(p["probes"]):
                self.kept.append((*self._keep(ins, kw, outs),
                                  p["flags"][j].clone(), self._group))
        return out

    def __enter__(self):
        from better_fastlio2_tpu_torch.core import measurement
        from better_fastlio2_tpu_torch.pipeline import graphs

        probe = self
        setattr(measurement, self.kernel, self)
        graphs.StepGraph.warm_up_and_capture = (
            lambda g, ls, rows: probe._capture(g, ls, rows))
        graphs.StepGraph.replay = lambda g, rows: probe._replay(g, rows)
        return self

    def __exit__(self, *exc):
        from better_fastlio2_tpu_torch.core import measurement
        from better_fastlio2_tpu_torch.pipeline import graphs

        setattr(measurement, self.kernel, self.real)
        graphs.StepGraph.warm_up_and_capture = self._real_capture
        graphs.StepGraph.replay = self._real_replay

    def finish(self) -> dict[int, int]:
        """`widths` with the replayed calls read from the device counters
        (one read each, after the run)."""
        for w, c in self.counters.items():
            self.widths[w] = self.widths.get(w, 0) + int(c)
            c.zero_()
        return self.widths

    def checks(self) -> list[dict]:
        """The kept calls against the plain version: every eager one, and
        from each group of kept replays the first probe (of each width)
        whose body ran.  `body_checks` counts the latter."""
        out, taken = [], set()
        for ins, kw, outs, ran, group in self.kept:
            if ran is not None:
                key = (group, self._width(ins))
                if key in taken or not bool(ran):
                    continue
                taken.add(key)
            if self.kernel == "fused_hth":
                c = compare_k2(ins, kw["extrinsic"], *outs)
            else:
                c = compare_k1(*ins, *outs)
            c["in_conditional_body"] = ran is not None
            out.append(c)
        self.body_checks = sum(c["in_conditional_body"] for c in out)
        return out


SMI_QUERY = "clocks.sm,power.draw,temperature.gpu"


class SmiSampler:
    """nvidia-smi's SM clock (MHz), power draw (W) and temperature (C) at
    chosen moments: each read is a process started then and collected
    later, so that no timed host path waits on it (ROADMAP S6: the two
    modes of device_ms_per_scan)."""

    def __init__(self):
        self._procs: list[tuple] = []

    def start(self, tag) -> None:
        self._procs.append((tag, subprocess.Popen(
            ["nvidia-smi", "-i", first_card(), f"--query-gpu={SMI_QUERY}",
             "--format=csv,noheader,nounits"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)))

    def collect(self) -> list[dict]:
        """The samples taken, in order; every process is waited for."""
        out = []
        for tag, p in self._procs:
            try:
                txt, _ = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                continue
            vals = txt.strip().split(",")
            if p.returncode != 0 or len(vals) != 3:
                continue
            try:
                sm, pw, temp = (float(v) for v in vals)
            except ValueError:
                continue
            out.append({"at": tag, "sm_mhz": sm, "power_w": pw,
                        "temp_c": temp})
        self._procs = []
        return out


def run_main_path(cfg, groups, kernel: str = "fused_normal_eqs",
                  device=None, check_scans=CHECK_SCANS,
                  check_width: int | None = None) -> dict:
    """Drive LIOPipeline per scan over `groups` (on CUDA each scan a
    replay of its program's one-tick graph, captured at the program's
    first scan); return the per-scan record, each kernel's launches that
    ran in the run (counts set to 0 just before; the replays' counted on
    the device and read once after the run) and `kernel`'s by the width
    of their input, each scan's launches (an eager scan's counted on the
    host, a replayed scan's implied by its ESIKF passes and refresh,
    whose sum must equal the device count), the passes and refresh fires
    of the replayed scans, the graph replays, the host syncs per scan
    (the port's to_host reads, and on CUDA every synchronising call
    torch reports), SM clock and power samples, and the re-checks of
    `kernel` (GraphProbe: its first call inside an ESIKF pass body on
    the first replay from each of `check_scans` on that ran the body,
    read from the graph's probes or from the eager call, and its first
    eager call of width `check_width`), compared after the run.  Then,
    on CUDA, the first PREFIX_SCANS scans again with eager ticks
    (graphed=False): their results must equal the replays' bit for
    bit."""
    import torch

    from better_fastlio2_tpu_torch.ops import kernels
    from better_fastlio2_tpu_torch.pipeline import graphs
    from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
    from better_fastlio2_tpu_torch.utils.device import host_syncs

    def host_ran():  # launches made eagerly so far (no device read)
        return {k: getattr(kernels, k).launches - graphs.captured[k]
                for k in KERNELS}

    t_run = time.perf_counter()
    pipe = LIOPipeline(cfg, device=device)
    cuda = pipe.device.type == "cuda"
    smi = SmiSampler() if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gt, scan_ms, syncs, torch_syncs, outs, replays = [], [], [], [], [], []
    launches = {name: [] for name in KERNELS}
    implied = dict.fromkeys(KERNELS, 0)  # the replayed scans' launches
    captures = []  # (scan, program) of each graph captured
    reset_launches()
    host_syncs.reset()
    probe = GraphProbe(kernel, keep_width=check_width)
    with warnings.catch_warnings(record=True) as caught, probe:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for i, g in enumerate(groups):
                if pipe.inited:
                    gt.append(g["gt_pos"])
                if smi is not None and i % SMI_EVERY == 0:
                    smi.start(i)
                l0, r0, g0 = host_ran(), probe.replays, pipe.graph
                s0, w0 = host_syncs.count, len(caught)
                if i in check_scans:
                    probe.snap()
                t0 = time.perf_counter()
                out = pipe.process_scan(
                    g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                    g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
                n_torch = sum("synchroniz" in str(w.message)
                              for w in caught[w0:])
                if cuda:
                    card_sync()
                dt = time.perf_counter() - t0
                if pipe.graph is not None and pipe.graph is not g0:
                    captures.append((i, pipe._graph_of))
                if out is not None:
                    scan_ms.append(1e3 * dt)
                    ran, rep = host_ran(), probe.replays > r0
                    for name in KERNELS:
                        n = ran[name] - l0[name]
                        if rep and n == 0 and cuda:
                            n = implied_launches(name, out["iters"],
                                                 out["refreshed"])
                            implied[name] += n * (name == kernel)
                        launches[name].append(n)
                    syncs.append(host_syncs.count - s0)
                    torch_syncs.append(n_torch)
                    replays.append(probe.replays - r0)
                    outs.append(out)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    totals = launches_ran()
    device_ran = {k: kernels.device_launches(k) for k in KERNELS}
    imu_ran = totals["imu_stage"]
    if cuda and imu_ran != len(outs):
        fail(f"imu_stage: {imu_ran} launches ran for {len(outs)} scans "
             "ticked (one a scan expected)")
    widths = probe.finish()
    if cuda and device_ran[kernel] != implied[kernel]:
        fail(f"{kernel}: the replays ran {device_ran[kernel]} launches "
             f"(counted on the device), their passes and refreshes imply "
             f"{implied[kernel]}")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    reserved = torch.cuda.max_memory_reserved() if cuda else None
    traj = np.array(pipe.trajectory)
    graph = None
    if pipe.graph is not None:
        gr = pipe.graph
        graph = {"of": pipe._graph_of, "capture_s": gr.capture_s,
                 "nodes": gr.nodes["nodes"],
                 "kernel_nodes": gr.nodes["kernel_nodes"],
                 "conditional_nodes": gr.nodes["conditional"],
                 "body_nodes": gr.nodes["body_nodes"],
                 "fused_normal_eqs_nodes": gr.nodes["fused_normal_eqs"],
                 "fused_hth_nodes": gr.nodes["fused_hth"],
                 "imu_stage_nodes": gr.nodes["imu_stage"],
                 "by_type": gr.nodes["by_type"]}
    dmom_built = pipe.ls.map.dmom is not None
    del pipe
    checks = probe.checks()
    if cuda and not probe.body_checks:
        fail(f"{kernel}: no call inside a conditional body was checked")
    prefix = 0
    if cuda:  # the same scans with eager ticks, bit for bit
        eager = LIOPipeline(cfg, device=device, graphed=False)
        for g in groups[:PREFIX_SCANS]:
            eager.process_scan(g["pts"], g["pt_t"], g["imu_acc"],
                               g["imu_gyr"], g["imu_t"], g["scan_beg_abs"],
                               g["scan_end_t"])
        te = np.array(eager.trajectory)
        del eager
        if len(te) < 2 or not np.array_equal(te, traj[:len(te)]):
            d = (float(np.abs(te - traj[:len(te)]).max())
                 if len(te) else None)
            fail(f"the eager ticks of the first {PREFIX_SCANS} scans differ "
                 f"from the graph replays (max {d})")
        prefix = len(te)
    return {"traj": traj, "gt": np.array(gt), "n_scans": len(groups),
            "seconds": time.perf_counter() - t_run, "cuda": cuda,
            "scan_ms": scan_ms, "launches": launches, "syncs": syncs,
            "torch_syncs": torch_syncs, "widths": widths,
            "device_launches": device_ran, "implied_launches": implied,
            "body_checks": probe.body_checks,
            "replays": replays, "captures": captures, "graph": graph,
            "graph_nodes": probe.graph_nodes, "prefix_equal": prefix,
            "smi": smi.collect() if smi is not None else [],
            "outs": outs, "totals": totals, "checks": checks,
            "imu_stage_launches": imu_ran,
            "peak_bytes": peak, "peak_reserved_bytes": reserved,
            "dmom_built": dmom_built}


def run_window_path(name: str, cfg, groups, gate_end: float, gate_ate: float,
                    per_scan: dict, quantized: bool = True, mesh=None,
                    window: int | None = None,
                    warm_probe: list | None = None) -> dict:
    """Drive LIOPipeline as bench.py:388-389 does (pipelined, window W,
    quantized, unroll min(W, 8)) over `groups` and check it.  With
    quantized=False the unquantized wire, with `mesh` the SPMD window
    step over that mesh (LIOPipeline(mesh=...)), `window` W (default:
    WINDOW of the workload in `name`).  `warm_probe`, a list, receives the
    inputs and outputs of K1's first call with live lanes (G != 0; the
    warmup program's, eager).
    The returned dict also holds the trajectory ("traj", not printed).

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
    from better_fastlio2_tpu_torch.io import native
    from better_fastlio2_tpu_torch.ops import kernels
    from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
    from better_fastlio2_tpu_torch.utils.device import host_syncs, open_nodes

    W = window or WINDOW[name.split("_")[1]]
    real = kernels.fused_normal_eqs
    # zeroed probe buffers and a ran flag, one set per tick and width
    spare: list[list] = []
    probes: list[list] = []  # K1 (soa, params, G, mv, ran) of each tick
    seen: set[int] = set()  # widths already met in the current tick
    passes: list[tuple[int, bool]] = []  # each scan's ESIKF passes, refresh

    def spy(soa, params, **kw):
        out = real(soa, params, **kw)
        if (warm_probe is not None and not warm_probe
                and pipe.ls.map.dmom is None  # the warmup program
                and bool(torch.any(out[0] != 0))):
            warm_probe.append((soa.clone(), params.clone(),
                               *(o.clone() for o in out)))
        capturing = torch.cuda.is_current_stream_capturing()
        # a mesh step has no IF node: there its pass 0 is probed
        if (pipe.graph is None or soa.shape[1] in seen
                or (capturing and mesh is None
                    and "esikf.pass" not in open_nodes())):
            return out  # not a steady tick's first call of the width
        seen.add(soa.shape[1])
        call = (soa, params, *out)
        if not capturing:  # eager warm-up
            spare.append([torch.zeros_like(t) for t in call]
                         + [torch.zeros((), dtype=torch.bool,
                                        device=soa.device)])
            return out
        # inside an ESIKF pass body: a replay that runs it overwrites the
        # buffers when its input has a live lane, and sets the flag
        bufs = spare.pop(0)
        live = torch.any(soa != 0)
        for b, t in zip(bufs, call):
            b.copy_(torch.where(live, t, b))
        bufs[-1].logical_or_(live)
        probes.append(bufs)
        return out

    t_run = time.perf_counter()
    pipe = LIOPipeline(cfg, pipelined=True, window=W, quantized=quantized,
                       unroll=min(W, 8), mesh=mesh)
    tick = pipe._tick  # the steady tick the graph captures

    def probed_tick(*args):
        seen.clear()
        return tick(*args)

    pipe._tick = probed_tick
    record = pipe._record

    def recorded(v):
        passes.append((int(v[29]), bool(v[30])))
        return record(v)

    pipe._record = recorded
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    gt, t_steady, n_steady = [], None, 0
    native.pack_quant_bulk.calls = 0
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
    # every scan after the IMU init is packed once, by the C++ packer
    packed = native.pack_quant_bulk.calls
    if quantized and packed != len(groups) - 1:
        fail(f"{name}: the C++ packer packed {packed} of "
             f"{len(groups) - 1} rows")
    peak = torch.cuda.max_memory_allocated()
    graph = pipe.graph
    if graph is None or not n_steady:
        fail(f"{name}: the steady program was never captured and replayed")
    launches = {k: getattr(kernels, k).launches for k in KERNELS}
    k1_device = kernels.device_launches("fused_normal_eqs")
    if launches["fused_hth"] or kernels.device_launches("fused_hth"):
        fail(f"{name}: the path launched fused_hth: {launches}")
    # the first K1 call of each width inside an ESIKF pass body of each
    # tick, rewritten by every replay that ran it, against the plain
    # version: the probes whose body ran
    ran = [bool(p[-1]) for p in probes]
    checks = [compare_k1(*p[:-1]) for p, r in zip(probes, ran) if r]
    widths = {p[0].shape[1] for p in probes}
    if spare or len(probes) != graph.steps * len(widths) or not checks:
        fail(f"{name}: {len(probes)} K1 probes ({len(spare)} unused, "
             f"{len(checks)} ran) in a graph of {graph.steps} ticks")
    by_width = {}
    for c in checks:
        b = by_width.setdefault(c["n"], {"calls": 0, "live": 0,
                                         "max_err_over_tol": 0.0})
        b["calls"] += 1
        b["live"] += c["max_abs_G"] > 0
        b["max_err_over_tol"] = max(b["max_err_over_tol"],
                                    c["max_err_over_tol"])
    if not any(b["live"] for b in by_width.values()):
        fail(f"{name}: K1 never ran on live lanes in a pass body of the "
             f"graph: {by_width}")
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
    coll = graph.captured_collectives
    # the scans of replayed ticks: all but the warmup windows' and the
    # capture window's first `steps`; their passes and refreshes imply K1
    # launches (a padded tick of a flushed window runs its own few)
    n_eager = len(groups) - 1 - n_steady - (W - steps)
    rep = passes[n_eager:]
    implied = sum(implied_launches("fused_normal_eqs", i, f)
                  for i, f in rep)
    pad_ticks = replays * steps - len(rep)
    if mesh is not None:  # the select form: every pass and branch runs
        if k1_device != k1_nodes * replays:
            fail(f"{name}: the replays ran {k1_device} K1 launches, the "
                 f"graph holds {k1_nodes} K1 nodes for {replays} replays")
    elif not implied <= k1_device <= implied + pad_ticks * (
            cfg.ikdtree.max_iteration + 1) * 2:
        fail(f"{name}: the replays ran {k1_device} K1 launches (counted on "
             f"the device), their scans' passes and refreshes imply "
             f"{implied} (+ {pad_ticks} padded ticks)")
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
        "device_ms_groups_smi": device["smi"],
        "device_ms_per_scan_probed": probed["median"],
        "device_ms_groups_probed": probed["groups"],
        "device_ms_groups_probed_smi": probed["smi"],
        "capture_s": capture_s,
        "capture_s_unprobed": pipe.graph.capture_s,
        "graph_nodes_per_step": nodes["nodes"] / steps,
        "graph_kernel_nodes_per_step": nodes["kernel_nodes"] / steps,
        "graph_k1_nodes_per_step": k1_nodes / steps,
        "graph_nccl_kernel_nodes_per_step": nodes["nccl"] / steps,
        "graph_nodes_by_type": nodes["by_type"],
        "collectives_per_step": {
            k: v / steps for k, v in coll.items()},
        "graph_kernel_nodes_per_step_unprobed": (
            pipe.graph.nodes["kernel_nodes"] / steps),
        "graph_conditional_nodes_per_step": nodes["conditional"] / steps,
        "graph_body_nodes_per_step": nodes["body_nodes"] / steps,
        "passes_per_steady_scan_mean": float(np.mean([i for i, _ in rep])),
        "refresh_fires_per_steady_scan_mean": float(np.mean(
            [f for _, f in rep])),
        "k1_launches_per_steady_scan": k1_device / (replays * steps),
        "k1_launches_replayed_implied": implied,
        "k1_launches_python": launches["fused_normal_eqs"],
        # eager calls (the wrapper's count less the capture's calls, which
        # ran nothing) plus the launches the replays ran, counted on the
        # device (read before the timing replays below)
        "k1_launches_executed": (launches["fused_normal_eqs"] - k1_captured
                                 + k1_device),
        "graph_replays": replays, "steady_scans": n_steady,
        "native_packed_rows": packed,
        "port_reads_per_steady_window": reads * W / n_steady,
        "torch_syncs_per_steady_window": 0,
        "sync_debug_mode_steady": "error",
        "max_memory_allocated": peak,
        "ate_m": ate, "end_err_m": end,
        "gate": {"end_err_m": gate_end, "ate_m": gate_ate},
        "k1_graph_checks": by_width,
        "checks": checks,
    }
    if mesh is not None:
        out.update(mesh={"size": mesh.size, "backend": mesh.backend},
                   graphed=True)
    print(json.dumps(out), flush=True)
    out["traj"] = traj
    return out


def window_entry(pipe, g, last_end_rel: float = 0.0):
    """One scan as the pipeline buffers it for a window: the quantized
    (bulk, meta) rows, or the unquantized tuple with this rank's point
    rows."""
    P, T, V = pipe._pad_points(g["pts"], g["pt_t"])
    imu_rows = pipe._pad_imu(g["imu_acc"], g["imu_gyr"], g["imu_t"])
    if pipe.quantized:
        return pipe._pack_quant(P, T, V, *imu_rows, last_end_rel,
                                float(g["scan_end_t"]))
    r = pipe.mesh.rank if pipe.mesh is not None else 0
    rows = slice(r * pipe._n_pts, (r + 1) * pipe._n_pts)
    return (P[rows], T[rows], V[rows], *imu_rows, last_end_rel,
            float(g["scan_end_t"]))


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
        rows = [window_entry(pipe, g) for g in groups[lo:lo + W]]
        wins.append(pipe._pack_window(rows).to("cuda"))
    pipe._run_graph(wins[0])  # warm
    torch.cuda.synchronize()
    group_ms = []
    smi = SmiSampler()
    for k in range(CHAIN_GROUPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            s.record()
            for w in wins:
                pipe._run_graph(w)
            e.record()
            smi.start(k)  # read while the group runs on the card
        finally:
            torch.cuda.set_sync_debug_mode("default")
        e.synchronize()
        group_ms.append(s.elapsed_time(e) / (CHAIN_WINDOWS * W))
    return {"min": float(np.min(group_ms)),
            "median": float(np.median(group_ms)), "groups": group_ms,
            "smi": smi.collect()}


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
    # (the wrappers launch nothing on the CPU, where the smoke rehearses)
    if res["cuda"] and (starved or res["totals"][kernel] < 1):
        fail(f"{name}: {kernel} launched {res['totals'][kernel]} times; "
             f"scans without a launch: {starved[:10]}")
    # the IMU stage runs on every path (checked once a scan in run_main_path)
    others = {k: v for k, v in res["totals"].items()
              if k not in (kernel, "imu_stage")}
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
    iters = [o["iters"] for o in res["outs"]]
    fires = [o["refreshed"] for o in res["outs"]]
    # scan_ms[i] is the (i + 1)-th scan through a step program
    first = program_warmup or WARMUP_SCANS
    steady = res["scan_ms"][first:]
    # on CUDA every scan replays its program's graph but each program's
    # first, which runs eagerly and captures it; a replayed scan makes at
    # most one torch sync, the info readback
    replayed = [j for j, r in enumerate(res["replays"]) if r]
    n_programs = 2 if program_warmup else 1
    if res["cuda"]:
        if (len(replayed) != len(res["replays"]) - n_programs
                or len(res["captures"]) != n_programs
                or max(res["replays"]) != 1):
            fail(f"{name}: {len(replayed)} of {len(res['replays'])} scans "
                 f"replayed a graph, captures {res['captures']}")
        worst = max(res["torch_syncs"][j] for j in replayed)
        if worst > 1:
            fail(f"{name}: a replayed scan made {worst} torch syncs")
    rep_syncs = [res["torch_syncs"][j] for j in replayed[first:]]
    out = {
        "phase": name, "scans": len(traj), "kernel": kernel,
        "seconds": res["seconds"], "graphed": res["cuda"],
        "ms_per_scan_median": float(np.median(steady)),
        "ms_per_scan_p90": float(np.percentile(steady, 90)),
        "launches_total": res["totals"][kernel],
        "launches_per_scan": float(np.mean(per_scan[1:])),
        # the launches the replays ran, counted on the device, and what
        # the replayed scans' passes and refreshes imply (equal)
        "launches_replayed_device": res["device_launches"][kernel],
        "launches_replayed_implied": res["implied_launches"][kernel],
        # the IMU stage kernel: one launch a ticked scan (checked)
        "imu_stage_launches": res["imu_stage_launches"],
        "passes_per_scan_mean": float(np.mean(iters[1:])),
        "refresh_fires_per_scan_mean": float(np.mean(fires[1:])),
        "conditional_nodes_per_tick": (res["graph"] or {}).get(
            "conditional_nodes"),
        "checks_in_conditional_bodies": res["body_checks"],
        "graph_replays": len(replayed),
        "graph_captures": res["captures"],
        "graph": res["graph"],
        "graph_kernel_nodes_vs_calls_at_capture": res["graph_nodes"],
        "eager_prefix_scans_equal": res["prefix_equal"],
        "port_reads_per_scan": float(np.mean(res["syncs"][1:])),
        "torch_syncs_per_scan": float(np.mean(res["torch_syncs"][1:])),
        "torch_syncs_per_steady_scan": (float(np.mean(rep_syncs))
                                        if rep_syncs else None),
        "torch_syncs_per_steady_scan_max": (max(rep_syncs) if rep_syncs
                                            else None),
        "smi": res["smi"],
        "max_memory_allocated": res["peak_bytes"],
        "max_memory_reserved": res["peak_reserved_bytes"],
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
            "passes_per_scan_warmup_mean": float(np.mean(iters[w])),
            "passes_per_scan_steady_mean": float(np.mean(iters[st])),
            "refresh_fires_per_scan_steady_mean": float(np.mean(fires[st])),
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


# bench.py --slam (bench.py:333-383): the room bench shapes with the loop
# gates of :359-363 on the loop-closing outdoor circle
SLAM_WINDOW = 8
SLAM_HANDOFF_SCANS = 41  # init + 5 windows: the graph captured and replayed
SLAM_TIMING_RUNS = 3


def slam_config():
    """bench.py --slam's configuration: bench_config("room") with loop
    closure on (radius 5 m, time gap 10 s, fitness 0.6) and a keyframe
    every metre."""
    cfg = bench_config("room")
    cfg.loop.enable = True
    cfg.loop.search_radius = 5.0
    cfg.loop.search_time_diff = 10.0
    cfg.loop.fitness_score = 0.6
    cfg.mapping.keyframe_adding_dist_threshold = 1.0
    return cfg


def slam_sequence():
    """bench.py --slam's 240 scans: a 7.5 m circle at 3 m/s in the outdoor
    world, 8000 returns a scan at 3 cm noise with a gyro bias walk."""
    from better_fastlio2_tpu_torch.io.synthetic import (OutdoorWorld,
                                                        Trajectory,
                                                        make_lio_sequence)

    return list(make_lio_sequence(
        duration=N_SCANS / 10.0, scan_rate=10.0, imu_rate=100.0,
        n_points=8000, seed=7, noise=0.03, gyr_bias_walk=2e-4,
        traj=Trajectory(t_still=0.7, speed=3.0, yaw_rate=0.4),
        world=OutdoorWorld(seed=7)))


def keyframe_ate(pipe, groups) -> tuple[float, float]:
    """Keyframe ATE of the odometry poses and of the corrected poses
    against ground truth, as bench.py:441-468 computes them."""
    t2gt = {round(g["scan_beg_abs"] + g["scan_end_t"], 6): g["gt_pos"]
            for g in groups}
    gt, odom, corr = [], [], []
    for kf in pipe.keyframes:
        g = t2gt.get(round(kf.t, 6))
        if g is not None:
            gt.append(g)
            odom.append(kf.odom_pose[4:7])
            corr.append(kf.pose[4:7])
    gt = np.asarray(gt) - gt[0]
    odom = np.asarray(odom) - odom[0]
    corr = np.asarray(corr) - corr[0]
    return (float(np.sqrt(np.mean(np.sum((odom - gt) ** 2, axis=1)))),
            float(np.sqrt(np.mean(np.sum((corr - gt) ** 2, axis=1)))))


def loop_verify(pipe, cur_idx: int, cand: int, device, dtype):
    """One loop verification of keyframe cur_idx against cand as the SLAM
    back end makes it (its submaps, the Scan Context gate on f32
    descriptors, point-to-plane ICP from the relative estimate), on
    `device` in `dtype`: (sc distance, shift, ICP pose, fitness)."""
    import torch

    from better_fastlio2_tpu_torch.ops import icp, scancontext as sc
    from better_fastlio2_tpu_torch.utils import se3, so3

    kf, kc = pipe.keyframes[cur_idx], pipe.keyframes[cand]
    cur, cv = pipe._pad_fix(pipe._submap(cur_idx, 0, kf.pose), pipe._CUR_PAD)
    old, ov = pipe._pad_fix(pipe._submap(cand, pipe.cfg.loop.search_num,
                                         kc.pose), pipe._OLD_PAD)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    b, f32 = torch.bool, torch.float32
    dist, shift = sc.sc_distance(
        sc.make_descriptor(t(cur, f32), t(cv, b), pipe.sc_params),
        sc.make_descriptor(t(old, f32), t(ov, b), pipe.sc_params))
    yaw0 = -float(shift) * 2.0 * np.pi / pipe.sc_params.num_sector
    rel = se3.between(t(kc.pose), t(kf.pose))
    init = se3.compose(se3.make(so3.quat_exp(t([0.0, 0.0, yaw0])),
                                t(np.zeros(3))), rel)
    res = icp.icp_point2plane(t(cur), t(cv, b), t(old), t(ov, b),
                              init if abs(yaw0) > 0.3 else rel,
                              max_corr=10.0, iters=25, voxel=1.0)
    return dist, shift, res.pose, res.fitness


def host_ms(fn, runs: int = SLAM_TIMING_RUNS) -> float:
    """Median wall milliseconds of `fn` on the host (after one warm call)."""
    fn()
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


def phase_slam(groups, room_window_ms: float | None) -> tuple[dict, object]:
    """bench.py --slam on the port (SLAMPipeline, async back end on the
    host, the window driver of bench_room_window): the steady windows'
    wall, port reads and torch syncs (sync debug mode "warn"), the
    graph's replays and K1 kernel nodes, the corrections and
    map resets that reached the captured graph, bench.py's gates (a loop
    closed; corrected keyframe ATE <= max(0.25 m, odometry keyframe ATE))
    and the back end's host times.  Returns (line, pipeline)."""
    import torch

    from better_fastlio2_tpu_torch.backend import posegraph as pgm
    from better_fastlio2_tpu_torch.ops import kernels, scancontext as sc
    from better_fastlio2_tpu_torch.pipeline.slam import SLAMPipeline
    from better_fastlio2_tpu_torch.utils.device import host_syncs

    t_run = time.perf_counter()
    pipe = SLAMPipeline(slam_config(), async_backend=True,
                        backend_on_host=True,
                        lio_kwargs=dict(window=SLAM_WINDOW, quantized=True,
                                        unroll=SLAM_WINDOW))
    lio = pipe.lio
    resets, corrections = [], []
    reset, correct = lio.reset_map_from_world_points, pipe._apply_correction

    def counted_reset(pts):
        resets.append((lio.graph is not None, len(pts)))
        return reset(pts)

    def counted_correction(poses, n=None):
        corrections.append(lio.graph is not None)
        return correct(poses, n)

    lio.reset_map_from_world_points = counted_reset
    pipe._apply_correction = counted_correction
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    graph, t_steady, n_steady, n_torch = None, None, 0, 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for g in groups:
            if t_steady is None and lio.graph is not None and not lio._wbuf:
                torch.cuda.synchronize()  # the steady windows start here
                t_steady, host_syncs.count = time.perf_counter(), 0
                graph, w0 = lio.graph, len(caught)
            if t_steady is not None:
                n_steady += 1
                torch.cuda.set_sync_debug_mode("warn")
            try:
                pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"],
                                  g["imu_gyr"], g["imu_t"], g["scan_beg_abs"],
                                  g["scan_end_t"])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t_end, reads = time.perf_counter(), host_syncs.count
        if graph is not None:
            n_torch = sum("synchroniz" in str(w.message)
                          for w in caught[w0:])
    pipe.flush()
    torch.cuda.synchronize()
    pipe.close()
    peak = torch.cuda.max_memory_allocated()
    if graph is None or lio.graph is not graph:
        fail("slam: the steady program was not captured once and kept")
    launches = {k: getattr(kernels, k).launches for k in KERNELS}
    k1_device = kernels.device_launches("fused_normal_eqs")
    if launches["fused_hth"] or kernels.device_launches("fused_hth"):
        fail(f"slam: the path launched fused_hth: {launches}")
    k1_nodes = graph.nodes["fused_normal_eqs"]
    k1_captured = graph.captured_launches["fused_normal_eqs"]
    if k1_nodes != k1_captured or not k1_nodes:
        fail(f"slam: {k1_nodes} K1 kernel nodes for {k1_captured} K1 calls "
             "at capture")
    W, steps = SLAM_WINDOW, graph.steps
    expected = (W - steps) // steps + (-(-n_steady // W)) * (W // steps)
    if graph.replays != expected:
        fail(f"slam: {graph.replays} graph replays, {expected} expected")
    traj = np.array(lio.trajectory)
    if len(traj) != len(groups) - 1 or not np.all(np.isfinite(traj)):
        fail(f"slam: trajectory has {len(traj)} rows or non-finite values")
    if not pipe.loop_pairs:
        fail("slam: no loop closure fired")
    ate_odom, ate_corr = keyframe_ate(pipe, groups)
    if not np.isfinite(ate_corr) or ate_corr > max(0.25, ate_odom):
        fail(f"slam: corrected keyframe ATE {ate_corr:.4f} m worse than "
             f"max(0.25, odometry keyframe ATE {ate_odom:.4f} m)")
    if not any(corrections):
        fail("slam: no correction was applied while the graph held the "
             "state")
    # the back end's host times, on the run's own keyframes and graph
    kf = pipe.keyframes[len(pipe.keyframes) // 2]
    buf, vm = pipe._pad_fix(kf.cloud, pipe._CUR_PAD)
    bt, bv = torch.as_tensor(buf), torch.as_tensor(vm)
    i, j, _ = pipe.loop_pairs[0]
    cpu = torch.device("cpu")
    out = {
        "phase": "slam", "scans": len(groups), "window": W,
        "unroll": SLAM_WINDOW, "graph_steps": steps,
        "seconds": time.perf_counter() - t_run,
        "n_keyframes": len(pipe.keyframes),
        "n_loops": len(pipe.loop_pairs),
        "loop_pairs": [[a, b, f] for a, b, f in pipe.loop_pairs],
        "ate_odom_keyframes_m": ate_odom,
        "ate_corrected_keyframes_m": ate_corr,
        "gate": {"n_loops": 1, "ate_corrected_keyframes_m":
                 max(0.25, ate_odom)},
        "ms_per_scan_steady": 1e3 * (t_end - t_steady) / n_steady,
        "ms_per_scan_steady_bench_room_window": room_window_ms,
        "steady_scans": n_steady,
        "port_reads_per_steady_window": reads * W / n_steady,
        "torch_syncs_per_steady_window": n_torch * W / n_steady,
        "sync_debug_mode_steady": "warn",
        "graph_replays": graph.replays,
        "graph_conditional_nodes_per_step": (graph.nodes["conditional"]
                                             / steps),
        "k1_launches_per_steady_scan": k1_device / (graph.replays * steps),
        # eager calls plus the launches the replays ran (on the device)
        "k1_launches_executed": (launches["fused_normal_eqs"] - k1_captured
                                 + k1_device),
        "corrections": len(corrections),
        "corrections_under_graph": sum(corrections),
        "map_resets": len(resets),
        "map_resets_under_graph": sum(r[0] for r in resets),
        "max_memory_allocated": peak,
        "backend_device": str(pipe.backend_device),
        "backend_host_threads": torch.get_num_threads(),
        "backend_host_ms": {
            "descriptor": host_ms(lambda: sc.make_descriptor(
                bt, bv, pipe.sc_params)),
            "loop_verification": host_ms(lambda: loop_verify(
                pipe, j, i, cpu, torch.float32)),
            "optimize_6x50": host_ms(lambda: pgm.optimize(
                pipe.graph, iters=6, cg_iters=50)),
        },
    }
    print(json.dumps(out), flush=True)
    return out, pipe


def handoff_run(groups, graphed: bool, per_scan: bool = False) -> dict:
    """SLAMPipeline over the room sequence in window mode, or per
    scan (`per_scan`: each scan a replay of its program's one-tick graph,
    the steady graph captured at scan 17), the graph captured and
    replayed, or every tick eager (graphed=False); a +1 m x correction
    forced through _apply_correction after SLAM_HANDOFF_SCANS scans (as
    tests/test_slam_backend.py:175-236 forces it), then SLAM_WINDOW more
    scans.  Per scan, the steady scans before the correction are timed
    (host ms a scan, each ending in the card's synchronize) and their
    torch syncs counted (sync debug "warn")."""
    import torch

    from better_fastlio2_tpu_torch.map import voxel_hash
    from better_fastlio2_tpu_torch.pipeline.slam import SLAMPipeline
    from better_fastlio2_tpu_torch.utils import so3

    cfg = bench_config("room")
    cfg.loop.enable = False
    cfg.mapping.keyframe_adding_dist_threshold = 1.0
    kw = {} if per_scan else dict(window=SLAM_WINDOW, quantized=True,
                                  unroll=SLAM_WINDOW)
    torch.cuda.reset_peak_memory_stats()
    pipe = SLAMPipeline(cfg, lio_kwargs=dict(kw, graphed=graphed))
    lio = pipe.lio
    scan_ms, scan_syncs, fe_syncs = [], [], []
    # the front end's own syncs within a scan (SLAMPipeline around it
    # reads the keyframe data on the host)
    now = {"caught": None, "front_end": 0}
    real_fe = lio.process_scan

    def front_end(*a, **kw):
        c = now["caught"]
        n0 = len(c) if c is not None else 0
        try:
            return real_fe(*a, **kw)
        finally:
            if c is not None:
                now["front_end"] += sum("synchroniz" in str(w.message)
                                        for w in c[n0:])

    lio.process_scan = front_end

    def feed(gs, timed=False):
        for g in gs:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if timed:
                    torch.cuda.set_sync_debug_mode("warn")
                    now.update(caught=caught, front_end=0)
                t0 = time.perf_counter()
                try:
                    pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"],
                                      g["imu_gyr"], g["imu_t"],
                                      g["scan_beg_abs"], g["scan_end_t"])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    now["caught"] = None
                card_sync()
            if timed:
                scan_ms.append(1e3 * (time.perf_counter() - t0))
                scan_syncs.append(sum("synchroniz" in str(w.message)
                                      for w in caught))
                fe_syncs.append(now["front_end"])

    steady = 1 + PLANE_CACHE_WARMUP + 1  # after the steady graph's capture
    if per_scan:
        feed(groups[:steady])
        feed(groups[steady:SLAM_HANDOFF_SCANS], timed=True)
    else:
        feed(groups[:SLAM_HANDOFF_SCANS])
    graph = lio.graph
    if lio._wbuf or (graphed and (graph is None or graph.replays == 0)):
        fail("slam_handoff: the graph was not captured and replayed before "
             "the correction")
    n_rep, pos0 = graph.replays if graphed else 0, lio.ls.x.pos.clone()
    poses = np.stack([kf.pose for kf in pipe.keyframes]).astype(np.float64)
    poses[:, 4] += 1.0
    n_kf = len(pipe.keyframes)
    pipe._apply_correction(poses, n=len(pipe.keyframes))
    torch.cuda.synchronize()
    moved = float((lio.ls.x.pos - pos0)[0])
    if (graphed and lio.ls is not graph.ls) or abs(moved - 1.0) > 1e-3:
        fail(f"slam_handoff: the state moved {moved:.4f} m, not 1 m")
    # the knn hit test of the JAX test, on the first keyframe, whose
    # points the reset inserts first (later ones meet full buckets)
    kf0 = pipe.keyframes[0]
    R = so3.quat_to_matrix(torch.as_tensor(kf0.pose[0:4])).numpy()
    world = (kf0.cloud[:64] @ R.T + kf0.pose[4:7]).astype(np.float32)
    _, d2, ok = voxel_hash.knn(lio.ls.map, torch.as_tensor(world,
                                                           device="cuda"),
                               k=1, max_probe=8)
    hit = float((ok[:, 0] & (d2[:, 0] < 1e-6)).float().mean())
    if hit <= 0.9:
        fail(f"slam_handoff: the map holds {hit:.2f} of the shifted "
             "keyframe cloud (> 0.9 needed)")
    feed(groups[SLAM_HANDOFF_SCANS:SLAM_HANDOFF_SCANS + SLAM_WINDOW])
    pipe.flush()
    if graphed and (lio.graph is not graph or graph.replays <= n_rep):
        fail("slam_handoff: the scans after the correction did not replay "
             "the captured graph")
    traj = np.array(lio.trajectory)
    if len(traj) != SLAM_HANDOFF_SCANS - 1 + SLAM_WINDOW:
        fail(f"slam_handoff: {len(traj)} results")
    out = {"traj": traj,
           "keyframes": n_kf, "moved": moved, "hit": hit,
           "replays": (n_rep, graph.replays) if graphed else None,
           "peak": torch.cuda.max_memory_allocated(),
           "peak_reserved": torch.cuda.max_memory_reserved()}
    del lio.process_scan  # the wrapper (no cycle left through it)
    pipe.close()
    if scan_ms:
        out.update(ms=float(np.median(scan_ms)),
                   syncs=float(np.mean(scan_syncs)),
                   fe_syncs=float(np.mean(fe_syncs)),
                   fe_syncs_max=max(fe_syncs))
    return out


def phase_slam_handoff(groups, per_scan: bool = False) -> dict:
    """The state handoff on the card: the +1 m correction of handoff_run
    under the captured graph must reach it (the same graph replays on,
    `ls` stays the graph's, the map holds the shifted keyframe clouds) and
    give the same trajectory, bit for bit, as the same run with every
    tick eager (a lost state would leave the graph's replays 1 m off).
    The scans after the correction follow the shifted frame within the
    room ATE gate (0.15 m; its end error is reported beside the room's
    0.030 m: the reset map is built from the raw keyframe clouds, as in
    the reference).  per_scan: the front end per scan (`slam_handoff_per_
    scan`, the SLAM front end as users run it without a window), its
    steady scans' ms, the front end's torch syncs (at most one a scan;
    SLAMPipeline's own reads of the keyframe data beside them) and
    peak memory reported."""
    name = "slam_handoff_per_scan" if per_scan else "slam_handoff"
    g = handoff_run(groups, graphed=True, per_scan=per_scan)
    e = handoff_run(groups, graphed=False, per_scan=per_scan)
    if not np.array_equal(g["traj"], e["traj"]):
        d = float(np.abs(g["traj"] - e["traj"]).max()) if (
            g["traj"].shape == e["traj"].shape) else None
        fail(f"{name}: the graph's trajectory differs from the eager "
             f"run's after the correction (max {d})")
    traj = g["traj"]
    gt = np.array([x["gt_pos"] for x in groups[1:len(traj) + 1]])
    est = traj[:, :3] - traj[0, :3]
    ref = gt - gt[0] + [1.0, 0.0, 0.0]
    post = slice(len(traj) - SLAM_WINDOW, len(traj))  # the next scans
    err = np.linalg.norm(est[post] - ref[post], axis=1)
    ate, end = float(np.sqrt(np.mean(err ** 2))), float(err[-1])
    if ate > 0.15 or end > 0.15:
        fail(f"{name}: after the correction ATE {ate:.4f} m, end "
             f"error {end:.4f} m in the shifted frame (<= 0.15)")
    if per_scan and g["fe_syncs_max"] > 1:
        fail(f"{name}: the front end made {g['fe_syncs_max']} torch syncs "
             "in a steady scan")
    out = {"phase": name, "scans_before": SLAM_HANDOFF_SCANS - 1,
           "scans_after": SLAM_WINDOW, "keyframes": g["keyframes"],
           "graphed": True, "graph_replays_before_after": g["replays"],
           "graph_equals_eager": True, "state_moved_m": g["moved"],
           "map_hit_fraction": g["hit"], "ate_shifted_m": ate,
           "end_err_shifted_m": end,
           "max_memory_allocated": g["peak"],
           "max_memory_reserved": g["peak_reserved"],
           "gate": {"ate_m": 0.15, "end_err_m": 0.15, "map_hit": 0.9,
                    "room_end_err_m": 0.030}}
    if per_scan:
        out.update(ms_per_scan_steady=g["ms"],
                   ms_per_scan_steady_eager=e["ms"],
                   torch_syncs_per_steady_scan=g["fe_syncs"],
                   torch_syncs_per_steady_scan_slam=g["syncs"])
    print(json.dumps(out), flush=True)
    return out


def phase_backend_cuda(pipe, device: str = "cuda") -> dict:
    """The back end on the card (backend_on_host=False) on the slam
    phase's keyframes: every keyframe's descriptor, the first loop's
    verification (SC gate + ICP) and optimize(iters=6, cg_iters=50) of
    the final graph.  Run twice on CUDA in the run's f32, each gives the
    same bits; in f64 each matches the CPU port within the CPU parity
    tests' tolerances (descriptors exactly, ICP pose and fitness 1e-8,
    optimize poses 1e-9).  The f32 CUDA-CPU differences are reported."""
    import torch

    from better_fastlio2_tpu_torch.backend import posegraph as pgm
    from better_fastlio2_tpu_torch.ops import scancontext as sc

    dev, cpu = torch.device(device), torch.device("cpu")
    f32, f64 = torch.float32, torch.float64

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    pads = [pipe._pad_fix(kf.cloud, pipe._CUR_PAD) for kf in pipe.keyframes]

    def descs(device, dtype):
        return torch.stack([sc.make_descriptor(
            torch.as_tensor(b, dtype=dtype, device=device),
            torch.as_tensor(v, device=device), pipe.sc_params)
            for b, v in pads]).cpu()

    def graph_on(device, dtype):
        return type(pipe.graph)(*(
            t.to(device=device, dtype=dtype) if t.is_floating_point()
            else t.to(device) for t in pipe.graph))

    def opt(device, dtype):
        return pgm.optimize(graph_on(device, dtype), iters=6,
                            cg_iters=50).poses.cpu()

    i, j, _ = pipe.loop_pairs[0]

    def verify(device, dtype):
        d, s, pose, fit = loop_verify(pipe, j, i, device, dtype)
        return torch.cat([d.reshape(1).double().cpu(),
                          s.reshape(1).double().cpu(),
                          pose.double().cpu(), fit.reshape(1).double().cpu()])

    checks = {}
    for name, fn in (("descriptors", descs), ("loop_verification", verify),
                     ("optimize", opt)):
        a, b = fn(dev, f32), fn(dev, f32)
        if not torch.equal(a, b):
            fail(f"backend_cuda: {name} on CUDA differs between two runs")
        c64, g64 = fn(cpu, f64), fn(dev, f64)
        checks[name] = {"bit_identical_runs": True,
                        "f32_max_abs_diff_cpu": float(
                            (a.double() - fn(cpu, f32).double()).abs().max()),
                        "f64_max_abs_diff_cpu": float(
                            (g64 - c64).abs().max())}
    d = checks["descriptors"]["f64_max_abs_diff_cpu"]
    v = verify(dev, f64) - verify(cpu, f64)
    o = checks["optimize"]["f64_max_abs_diff_cpu"]
    if d != 0.0:
        fail(f"backend_cuda: f64 descriptors differ from the CPU port by {d}")
    if v[1] != 0 or float(v[2:].abs().max()) > 1e-8:
        fail(f"backend_cuda: f64 loop verification differs from the CPU "
             f"port: {v.tolist()}")
    if o > 1e-9:
        fail(f"backend_cuda: f64 optimize differs from the CPU port by {o}")
    out = {"phase": "backend_cuda", "keyframes": len(pads),
           "loop_pair": [i, j], "checks": checks,
           "tolerance": {"descriptors": 0.0, "icp_pose_fitness": 1e-8,
                         "optimize_poses": 1e-9},
           "cuda_ms": {
               "descriptor": host_ms(lambda: (sc.make_descriptor(
                   torch.as_tensor(pads[0][0], device=dev),
                   torch.as_tensor(pads[0][1], device=dev),
                   pipe.sc_params), sync())),
               "loop_verification": host_ms(lambda: (verify(dev, f32))),
               "optimize_6x50": host_ms(lambda: opt(dev, f32))}}
    print(json.dumps(out), flush=True)
    return out


def run_slam_phases(room_groups, room_window_ms, handoff: bool = True):
    """The SLAM slice's phases: slam (bench.py --slam), backend_cuda on its
    keyframes, and slam_handoff on the room sequence.  Returns the slam
    line, its pipeline and its sequence (the apps phase's input)."""
    t0 = time.perf_counter()
    groups = slam_sequence()
    print(json.dumps({"phase": "sequence_slam", "scans": len(groups),
                      "seconds": time.perf_counter() - t0}), flush=True)
    slam, pipe = phase_slam(groups, room_window_ms)
    phase_backend_cuda(pipe)
    if handoff:
        phase_slam_handoff(room_groups)
        phase_slam_handoff(room_groups, per_scan=True)
    return slam, pipe, groups


# run.py mapping --dataset synthetic-outdoor --dynamic (run.py:51-65,
# :97-116, :284-303): the labelled outdoor sequence from a 2 m mount,
# scored over the scans after the appearance test's K = 24 frames
DYN_SCANS = 80
DYN_K = 24
DYN_WINDOW = 8
DYN_GATES = {"f1": 0.60, "precision": 0.85, "ate_m": 0.68}
DYN_JAX_BAND = 0.01  # |port - JAX| on precision, recall and F1
# perception_cuda's scans of `dynamic`; K2 is re-checked on its first call
# from each of them on
DYN_CHECK_SCANS = (30, 50, 70)
DYN_GAP = 5  # perception_cuda's tracked grid, dyn_track_gap scans back
# tools/dynamic_reference.py: the JAX package on the same sequences and
# configurations, f32 on the CPU
JAX_DYNAMIC_REF = {
    "dynamic": {"precision": 0.9065907354677408, "recall": 0.5023860837438424,
                "f1": 0.646509669910606, "ate_m": 0.11048091160792381},
    "dynamic_window": {"precision": 0.43632401017072286,
                       "recall": 0.46228448275862066,
                       "f1": 0.4489292521583137,
                       "ate_m": 0.1228955119985596}}
# In the window driver the reference's own appearance test keeps less than
# half its precision: the removal step extrapolates the scan's pose over a
# result lag of 8-16 scans, and on the sequence's weaving path that
# misplaces the scan's world voxels.  The port reproduces the reference
# there (tests/test_torch_slam_dynamic_window.py), so `dynamic_window` is
# held to the reference's figures within DYN_JAX_BAND and the ATE gate,
# and DYN_GATES' F1 and precision are reported beside them, not held.
# the JAX package's own record on its labelled moving-sensor run,
# ROUND5.md:110, on the CPU (precision, recall, F1)
JAX_ROUND5_DYNAMIC = (0.907, 0.502, 0.647)
# the query session's frame (yaw, t).  The reference verifies an
# inter-session loop by ICP from the graph's relative estimate, without the
# Scan Context yaw, and on these outdoor keyframes that converges only for
# small anchors: the phase reports the merge at (0.5, (3, -2, 0)) without
# a gate and holds the one at APP_ANCHOR to the mirrored test's gates
APP_ANCHOR = (0.15, (1.5, -1.0, 0.0))
APP_ANCHOR_WIDE = (0.5, (3.0, -2.0, 0.0))
APP_QUERY_STRIDE = 6  # every 6th keyframe of `slam` makes the query
RELO_SCANS = (170, 180, 190, 200, 210, 220)  # the second lap of `slam`
RELO_ODOM_FRAME = (0.3, (5.0, 3.0, 0.0))  # the odometry's offset frame
FPFH_YAW, FPFH_T = 2.1, (12.0, -5.0, 0.5)  # 120 degrees and an offset


def dynamic_config():
    """run.py mapping --dynamic on synthetic-outdoor (run.py:97-116):
    LIOConfig() defaults (the row path with extrinsic estimation), loop
    closure off, the 2 m truck mount, the appearance test."""
    from better_fastlio2_tpu_torch.config import LIOConfig

    cfg = LIOConfig()
    cfg.loop.enable = False
    cfg.dynamic_removal = True
    cfg.sensor_height = 2.0
    cfg.ssc_sensor_height = 0.4
    cfg.dyn_track_gap = DYN_GAP
    cfg.dyn_track_mode = "appearance"
    return cfg


def dynamic_sequence():
    """run.py's synthetic-outdoor groups (run.py:51-65): 80 scans of 8000
    returns in the labelled-mover world, the sensor at 2 m."""
    from better_fastlio2_tpu_torch.io.synthetic import (OutdoorWorld,
                                                        Trajectory,
                                                        make_lio_sequence)

    return list(make_lio_sequence(
        duration=DYN_SCANS / 10.0, n_points=8000, seed=0,
        traj=Trajectory(t_still=1.0, speed=2.0, height=2.0),
        world=OutdoorWorld(seed=0), labels=True))


def card_sync() -> None:
    """torch.cuda.synchronize outside sync debug mode: a clock's own wait
    is not counted among the path's syncs."""
    import torch

    if not torch.cuda.is_available():
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(mode)


class StageClock:
    """Host milliseconds of each call of the wrapped functions, the card
    synchronised before and after each (card_sync)."""

    def __init__(self):
        self.ms: dict[str, list[float]] = {}

    def wrap(self, name, fn):
        def timed(*a, **kw):
            card_sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            card_sync()
            self.ms.setdefault(name, []).append(
                1e3 * (time.perf_counter() - t0))
            return out
        return timed


def phase_dynamic(name: str, groups, card: str, lio_kwargs=None,
                  device=None):
    """run.py mapping --dynamic through the port's SLAMPipeline on the card
    (per scan, or in the window driver with lio_kwargs): each scan's
    removal mask scored against gt_dynamic after the first DYN_K scans
    (within DYN_JAX_BAND of the JAX package's figures; per scan also the
    F1 and precision gates), the trajectory's ATE (the outdoor gate), K2's
    calls on the path held against the plain version, the perception
    step's host ms per scan by stage, cluster_grid's sweeps and
    host reads, the port's reads and torch's syncs per scan, the front
    end's ms per scan, K1/K2 launches and peak memory.  Returns (line,
    pipeline)."""
    import torch

    from better_fastlio2_tpu_torch.io.evaluate import pr_rr_f1
    from better_fastlio2_tpu_torch.perception import dynamic as dyn
    from better_fastlio2_tpu_torch.perception import patchwork
    from better_fastlio2_tpu_torch.pipeline.slam import SLAMPipeline
    from better_fastlio2_tpu_torch.utils.device import host_syncs

    t_run = time.perf_counter()
    pipe = SLAMPipeline(dynamic_config(), lio_kwargs=lio_kwargs,
                        device=device)
    cuda = pipe.lio.device.type == "cuda"
    clock = StageClock()
    hooks = [(patchwork, "estimate_ground"), (dyn, "encode_scan"),
             (dyn, "cluster_grid")]
    originals = [getattr(m, n) for m, n in hooks]
    for (m, n), f in zip(hooks, originals):
        setattr(m, n, clock.wrap(n, f))
    pipe._appearance_keep = clock.wrap("appearance_step",
                                       pipe._appearance_keep)
    pipe.lio.process_scan = clock.wrap("front_end", pipe.lio.process_scan)
    # K2 as the path calls it: its first call, and from each of
    # DYN_CHECK_SCANS on its next call that runs (pass 0 of the next
    # graph replay, read from the graph's probes: in window mode a
    # window's ticks run at the window's last scan), held against the
    # plain version after the run
    due = list(DYN_CHECK_SCANS)
    probe = GraphProbe("fused_hth", keep_eager=(1,))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    dyn.cluster_stats.reset()
    host_syncs.reset()
    pred, gt, step_syncs = [], [], []
    t_steady = n_steady = None
    try:
        with warnings.catch_warnings(record=True) as caught, probe:
            warnings.simplefilter("always")
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                for i, g in enumerate(groups):
                    if due and i >= due[0]:
                        due.pop(0)
                        probe.snap()
                    if i == WARMUP_SCANS:  # the front end's graph replays
                        card_sync()
                        t_steady, n_steady = time.perf_counter(), 0
                    w0 = len(caught)
                    pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"],
                                      g["imu_gyr"], g["imu_t"],
                                      g["scan_beg_abs"], g["scan_end_t"])
                    step_syncs.append(sum("synchroniz" in str(w.message)
                                          for w in caught[w0:]))
                    if n_steady is not None:
                        n_steady += 1
                    pred.append(pipe.last_dynamic_mask)
                    gt.append(g["gt_dynamic"])
                card_sync()
                steady_ms = (1e3 * (time.perf_counter() - t_steady)
                             / n_steady if n_steady else None)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
            n_torch = sum(step_syncs)
            reads = host_syncs.count
            pipe.flush()
    finally:
        for (m, n), f in zip(hooks, originals):
            setattr(m, n, f)
    card_sync()
    n = len(groups)
    launches = launches_ran()
    traj = np.array(pipe.lio.trajectory)
    if len(traj) != n - 1 or not np.all(np.isfinite(traj)):
        fail(f"{name}: trajectory has {len(traj)} rows or non-finite values")
    if cuda and (launches["fused_normal_eqs"]
                 or launches["fused_hth"] < n - 1):
        fail(f"{name}: the row path's launches are {launches} over {n} "
             "scans (K2 on every updated scan, K1 never)")
    lio = pipe.lio
    graph = lio.graph
    if cuda and (graph is None or graph.replays < 1):
        fail(f"{name}: the front end never replayed a captured graph")
    replays = graph.replays if graph is not None else 0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    reserved = torch.cuda.max_memory_reserved() if cuda else None
    prefix = (dynamic_prefix(name, groups, traj, lio_kwargs, device)
              if cuda else 0)
    k2_checks = probe.checks()
    if cuda and not probe.body_checks:
        fail(f"{name}: no K2 call inside a conditional body was checked")
    n_ds = pipe.cfg.shapes.n_ds
    if len(k2_checks) != 1 + len(DYN_CHECK_SCANS) or any(
            c["n"] != n_ds for c in k2_checks):
        fail(f"{name}: K2 was re-checked on widths "
             f"{[c['n'] for c in k2_checks]}, not on its first call and "
             f"one call from each of the scans {DYN_CHECK_SCANS} on at the "
             f"path's width n_ds = {n_ds}")
    pr, rr, f1 = pr_rr_f1(np.concatenate(pred[DYN_K:]),
                          np.concatenate(gt[DYN_K:]))
    ate, end = accuracy(traj, np.array([g["gt_pos"] for g in
                                        groups[1:len(traj) + 1]]))
    ref = JAX_DYNAMIC_REF[name]
    got = {"precision": pr, "recall": rr, "f1": f1}
    off_ref = {k: abs(v - ref[k]) for k, v in got.items()}
    target_met = (f1 >= DYN_GATES["f1"]
                 and pr >= DYN_GATES["precision"])
    if (max(off_ref.values()) > DYN_JAX_BAND or ate > DYN_GATES["ate_m"]
            or (not lio_kwargs and not target_met)):
        fail(f"{name}: precision {pr:.4f} recall {rr:.4f} F1 {f1:.4f} ATE "
             f"{ate:.4f} m; the JAX package's {ref} (within "
             f"{DYN_JAX_BAND}), ATE <= {DYN_GATES['ate_m']} m"
             + ("" if lio_kwargs else
                f", F1 >= {DYN_GATES['f1']}, precision >= "
                f"{DYN_GATES['precision']}"))
    # each stage runs once a scan: per-scan sums, their median and mean
    ms = {k: np.asarray(v) for k, v in clock.ms.items()}
    stages = {"ground": ms["estimate_ground"],
              "encode_cluster": ms["encode_scan"] + ms["cluster_grid"],
              "front_end": ms["front_end"]}
    stages["appearance"] = ms["appearance_step"] - stages["encode_cluster"]
    out = {
        "phase": name, "card": card, "scans": n, "scored_from": DYN_K,
        "window": (lio_kwargs or {}).get("window", 1),
        "seconds": time.perf_counter() - t_run,
        "precision": pr, "recall": rr, "f1": f1,
        "ate_m": ate, "end_err_m": end,
        "jax_cpu_f32": ref, "abs_diff_jax": off_ref,
        "gate": {"abs_diff_jax": DYN_JAX_BAND, "ate_m": DYN_GATES["ate_m"],
                 **({} if lio_kwargs else
                    {k: DYN_GATES[k] for k in ("f1", "precision")})},
        "target_f1_precision": {
            "f1": DYN_GATES["f1"], "precision": DYN_GATES["precision"],
            "met": target_met, "held": not lio_kwargs},
        "jax_round5_record_p_r_f1": JAX_ROUND5_DYNAMIC,
        "host_ms_per_scan_median": {k: float(np.median(v))
                                    for k, v in stages.items()},
        "host_ms_per_scan_mean": {k: float(np.mean(v))
                                  for k, v in stages.items()},
        "cluster_grid_calls": dyn.cluster_stats.calls,
        "cluster_sweeps_per_scan": dyn.cluster_stats.sweeps / n,
        "cluster_reads_per_scan": dyn.cluster_stats.reads / n,
        "port_reads_per_scan": reads / n,
        "torch_syncs_per_scan": n_torch / n,
        "torch_syncs_per_steady_scan": float(np.mean(
            step_syncs[WARMUP_SCANS:])),
        "sync_debug_mode": "warn",
        "graphed": cuda, "graph_replays": replays,
        "graph_kernel_nodes_vs_calls_at_capture": probe.graph_nodes,
        "ms_per_scan_steady": steady_ms,
        "eager_prefix_scans_equal": prefix,
        "k1_launches": launches["fused_normal_eqs"],
        "k2_launches": launches["fused_hth"],
        "k2_checks": k2_checks,
        "removed_points": int(sum(int(m.sum()) for m in pred)),
        "max_memory_allocated": peak,
        "max_memory_reserved": reserved,
    }
    print(json.dumps(out), flush=True)
    return out, pipe


def dynamic_prefix(name: str, groups, traj, lio_kwargs, device) -> int:
    """The first PREFIX_SCANS scans of `name` again through SLAMPipeline
    with eager ticks (graphed=False): the front end's results must equal
    the graph replays' bit for bit.  Returns the results compared."""
    from better_fastlio2_tpu_torch.pipeline.slam import SLAMPipeline

    e = SLAMPipeline(dynamic_config(),
                     lio_kwargs={**(lio_kwargs or {}), "graphed": False},
                     device=device)
    try:
        for g in groups[:PREFIX_SCANS]:
            e.process_scan(g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                           g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
        e.flush()
    finally:
        e.close()
    te = np.array(e.lio.trajectory)
    if len(te) < 2 or not np.array_equal(te, traj[:len(te)]):
        fail(f"{name}: the eager ticks of the first {PREFIX_SCANS} scans "
             "differ from the graph replays")
    return len(te)


def _scan_pose(traj, i):
    """The [quat | pos] pose of scan i from LIOPipeline.trajectory rows
    ([pos | quat]; row j is scan j + 1, scan 0 initialises)."""
    r = traj[i - 1]
    return np.concatenate([r[3:7], r[0:3]])


def perception_outputs(groups, traj, i, device, dtype, gm_ref):
    """Every perception function of the removal step on scan i, on
    `device` in `dtype`, on the same inputs: estimate_ground (its mask and
    the ill-posed-patch flag), encode_scan + cluster_grid (the grid),
    recognize_pd, track_pd against the grid DYN_GAP scans back,
    dynamic_removal_masks, appearance_dynamic_mask.  The ground-dependent
    functions take gm_ref (the CPU f64 ground masks), so that each is held
    on its own inputs.  Returns {name: host array}."""
    import torch

    from better_fastlio2_tpu_torch.io.session import _quat_to_matrix
    from better_fastlio2_tpu_torch.perception import dynamic as dyn
    from better_fastlio2_tpu_torch.perception.patchwork import (
        PatchworkParams, estimate_ground)
    from better_fastlio2_tpu_torch.utils import se3

    prm = dyn.SSCParams(sensor_height=0.4)
    pw = PatchworkParams(sensor_height=2.0)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    def grid_of(j):
        p = t(groups[j]["pts"])
        ng = t(~gm_ref[j], torch.bool)
        return dyn.cluster_grid(dyn.encode_scan(p, ng, prm), prm)

    p = t(groups[i]["pts"])
    valid = torch.ones(len(p), dtype=torch.bool, device=device)
    mask, ill = estimate_ground(p, valid, pw, return_ill_posed=True)
    grid, prev = grid_of(i), grid_of(i - DYN_GAP)
    pd = dyn.recognize_pd(grid, prm)
    rel = se3.between(t(_scan_pose(traj, i - DYN_GAP)),
                      t(_scan_pose(traj, i)))
    hd = dyn.track_pd(prev, rel, grid, pd, prm)
    static, _ = dyn.dynamic_removal_masks(p, valid, t(gm_ref[i], torch.bool),
                                          prev, rel, prm)
    # the appearance test on this scan against the world keys of the
    # tracked scan (host numpy on the device's labels)
    band = (~gm_ref[i]) & (np.asarray(groups[i]["pts"])[:, 2] <= 1.0)
    lab = dyn.point_labels(dyn.cluster_grid(dyn.encode_scan(
        p, t(band, torch.bool), prm), prm))

    def keys_of(j):
        pj = _scan_pose(traj, j)
        w = (np.asarray(groups[j]["pts"], np.float64)
             @ _quat_to_matrix(pj[:4]).T + pj[4:7])
        return dyn.world_voxel_keys(w, 0.45)

    keys = keys_of(i)
    d_now = np.linalg.norm(np.asarray(groups[i]["pts"], np.float64), axis=1)
    scored = band & (lab >= 0) & (d_now <= 28.0)
    app = dyn.appearance_dynamic_mask(keys, scored, band, lab,
                                      np.unique(keys_of(i - DYN_GAP)),
                                      0.6, 0.0, 4, 0.6)
    return {"ground": mask.cpu().numpy(), "ill_posed": ill.cpu().numpy(),
            "occ": grid.occ.cpu().numpy(), "labels": grid.labels.cpu().numpy(),
            "pt_voxel": grid.pt_voxel.cpu().numpy(),
            "recognize_pd": pd.cpu().numpy(), "track_pd": hd.cpu().numpy(),
            "dynamic_removal_masks": static.cpu().numpy(),
            "appearance_dynamic_mask": app}


def phase_perception_cuda(groups, traj, card: str, device="cuda") -> dict:
    """The perception functions on the card, on three scans of `dynamic`:
    two f32 runs give the same bits; in f64 each equals the CPU port —
    masks and labels, every bit (the ground mask outside the patches whose
    plane fit was rank-deficient in either run: there the reference's own
    smallest eigenvector is undetermined)."""
    import torch

    from better_fastlio2_tpu_torch.perception.patchwork import (
        PatchworkParams, estimate_ground)

    cpu, dev = torch.device("cpu"), torch.device(device)
    f32, f64 = torch.float32, torch.float64
    pw = PatchworkParams(sensor_height=2.0)
    needed = sorted({j for i in DYN_CHECK_SCANS for j in (i, i - DYN_GAP)})
    gm_ref = {}
    for j in needed:
        p = torch.as_tensor(groups[j]["pts"], dtype=f64)
        gm_ref[j] = estimate_ground(p, torch.ones(len(p), dtype=torch.bool),
                                    pw).numpy()
    checks, ill_pts, ill_diff, ms = {}, 0, 0, {"cuda_f32": [], "cpu_f64": []}
    for i in DYN_CHECK_SCANS:
        outs = {}
        for key, device, dtype in (("a", dev, f32), ("b", dev, f32),
                                   ("g64", dev, f64), ("c64", cpu, f64)):
            card_sync()
            t0 = time.perf_counter()
            outs[key] = perception_outputs(groups, traj, i, device, dtype,
                                           gm_ref)
            card_sync()
            if key in ("a", "c64"):
                ms["cuda_f32" if key == "a" else "cpu_f64"].append(
                    1e3 * (time.perf_counter() - t0))
        for name in outs["a"]:
            if not np.array_equal(outs["a"][name], outs["b"][name]):
                fail(f"perception_cuda: {name} on scan {i} differs between "
                     "two f32 runs on the card")
            g, c = outs["g64"][name], outs["c64"][name]
            if name == "ground":
                ok = ~(outs["g64"]["ill_posed"] | outs["c64"]["ill_posed"])
                ill_pts += int((~ok).sum())
                ill_diff += int((g != c)[~ok].sum())
                g, c = g[ok], c[ok]
            if not np.array_equal(g, c):
                fail(f"perception_cuda: {name} on scan {i} in f64 differs "
                     "from the CPU port")
            checks[name] = {"f32_bit_identical": True,
                            "f64_equal_cpu": True}
    out = {"phase": "perception_cuda", "card": card,
           "scans": list(DYN_CHECK_SCANS), "checks": checks,
           "ground_ill_posed_points": ill_pts,
           "ground_f64_diffs_in_ill_posed_patches": ill_diff,
           "host_ms_per_scan_all_functions": {
               k: float(np.median(v)) for k, v in ms.items()}}
    print(json.dumps(out), flush=True)
    return out


def _yaw(yaw, t):
    """A [quat | pos] pose of a yaw and a translation (numpy f64)."""
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2), *t])


def _host_pose(fn, *poses):
    import torch

    out = fn(*(torch.as_tensor(np.asarray(p, np.float64)) for p in poses))
    return out.numpy()


def asym_scene(rng, n: int = 2400) -> np.ndarray:
    """tests/test_certifiable.py:make_asym_cloud: a structured,
    rotation-asymmetric scene (a floor, two walls of different extent, a
    box)."""
    k = n // 4
    return np.concatenate([
        np.stack([rng.uniform(-10, 10, k), rng.uniform(-6, 6, k),
                  np.zeros(k)], 1),
        np.stack([rng.uniform(-10, 10, k), np.full(k, 6.0),
                  rng.uniform(0, 4, k)], 1),
        np.stack([np.full(k, -10.0), rng.uniform(-6, 6, k),
                  rng.uniform(0, 2, k)], 1),
        np.stack([rng.uniform(2, 4, k), rng.uniform(-2, 0, k),
                  rng.uniform(0, 1.5, k)], 1)])


def _app_sessions(pipe, root, anchor, name="query"):
    """The apps phase's sessions: `central`, the slam phase's keyframes as
    its save_session writes them (once); `name`, every
    APP_QUERY_STRIDE-th keyframe's cloud with fresh 1 cm noise, stored in
    the frame of the known anchor A (poses A^-1 o W).  Returns (central
    dir, query dir, the query keyframes' central-frame poses)."""
    import torch

    from better_fastlio2_tpu_torch.io.session import SessionWriter
    from better_fastlio2_tpu_torch.ops import scancontext as sc
    from better_fastlio2_tpu_torch.utils import se3

    cdir, qdir = os.path.join(root, "central"), os.path.join(root, name)
    if not os.path.isdir(cdir):
        pipe.save_session(cdir)
    rng = np.random.default_rng(12)
    a_inv = _host_pose(se3.inverse, _yaw(*anchor))
    w = SessionWriter(qdir)
    truth, stored = [], []
    for kf in pipe.keyframes[::APP_QUERY_STRIDE]:
        cloud = kf.cloud + rng.normal(scale=0.01, size=kf.cloud.shape)
        desc = sc.make_descriptor(torch.as_tensor(cloud, dtype=torch.float32),
                                  torch.ones(len(cloud), dtype=torch.bool))
        s = _host_pose(se3.compose, a_inv, kf.pose)
        w.add_keyframe(cloud.astype(np.float32), np.zeros(len(cloud)),
                       desc.numpy(), s, t=kf.t)
        truth.append(kf.pose)
        stored.append(s)
    for k in range(1, len(stored)):
        w.add_edge(k - 1, k, _host_pose(se3.between, stored[k - 1],
                                        stored[k]))
    w.save()
    return cdir, qdir, np.stack(truth)


def _run_app(fn, device, dtype):
    """(result, host ms) of one app run on `device` in `dtype`."""
    card_sync()
    t0 = time.perf_counter()
    res = fn(device, dtype)
    card_sync()
    return res, 1e3 * (time.perf_counter() - t0)


def _hold(name, fn, tol_f64: float, card=None, exact=(), spread=False):
    """The apps' device checks: two f32 runs on the card give the same
    bits; the f64 card run equals the CPU port's on the `exact` keys and
    within tol_f64 on the others.  spread=True also runs the CPU port on
    one thread and reports how far its f64 result moves with the thread
    count (the reduction order).  fn(device, dtype) returns a dict of
    arrays (the app's numbers) and the app's own result; returns the f32
    card result and the record."""
    import torch

    cuda, cpu = torch.device(card or "cuda"), torch.device("cpu")
    (a, res), ms_a = _run_app(fn, cuda, "float32")
    (b, _), _ = _run_app(fn, cuda, "float32")
    (g, _), ms_g = _run_app(fn, cuda, "float64")
    (c, _), ms_c = _run_app(fn, cpu, "float64")

    def maxdiff(x, y):
        return max((float(np.max(np.abs(np.asarray(x[k], np.float64)
                                        - np.asarray(y[k], np.float64))))
                    for k in x if k not in exact and np.size(x[k])),
                   default=0.0)

    for key in a:
        if not np.array_equal(a[key], b[key]):
            fail(f"apps: {name} {key} differs between two f32 runs on the "
                 "card")
        if np.shape(g[key]) != np.shape(c[key]) or (
                key in exact and not np.array_equal(g[key], c[key])):
            fail(f"apps: {name} {key} in f64 differs on the card from the "
                 "CPU port")
    diff = maxdiff(g, c)
    if diff > tol_f64:
        fail(f"apps: {name} in f64 differs from the CPU port by {diff} "
             f"(> {tol_f64})")
    rec = {"host_ms_cuda_f32": ms_a, "host_ms_cuda_f64": ms_g,
           "host_ms_cpu_f64": ms_c, "f64_max_abs_diff_cpu": diff,
           "f64_tolerance": tol_f64, "f64_exact": list(exact),
           "f32_bit_identical": True}
    if spread:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            (c1, _), _ = _run_app(fn, cpu, "float64")
        finally:
            torch.set_num_threads(n)
        rec["cpu_f64_threads"] = n
        rec["cpu_f64_1_thread_max_abs_diff"] = maxdiff(c1, c)
    return res, rec


def phase_apps(pipe, groups, card: str, device="cuda",
               keep: str | None = None) -> dict:
    """The applications on the card, each held to the gates of its mirrored
    JAX test, its two f32 runs bit-identical and its f64 run equal to the
    CPU port's within the tolerance it prints (1e-8 m/rad; the merge 1e-4
    with its loops equal): MultiSessionMerger (the slam phase's keyframes
    against a query session under a known anchor; the same at a wider
    anchor reported, not gated), OnlineRelocalizer (the slam sequence's
    second lap, odometry in an offset frame), ObjectUpdater (a box in
    both sessions, one planted in one of them and another in the other)
    and register_fpfh_gnc (two independent samples of the mirrored test's
    structured scene, seen from 1 m above its floor, under a 120-degree
    yaw; the same on a keyframe scan's halves reported, not gated).
    keep: a directory that keeps the sessions, the clouds
    (apps_inputs.npz) and this line (apps.json) for
    tools/apps_reference.py; else a temporary one."""
    import contextlib
    import tempfile

    import torch

    from better_fastlio2_tpu_torch.apps.multi_session import (
        MultiSessionConfig, MultiSessionMerger)
    from better_fastlio2_tpu_torch.apps.object_update import (
        ObjectUpdateConfig, ObjectUpdater)
    from better_fastlio2_tpu_torch.apps.online_relo import (
        OnlineRelocalizer, ReloConfig)
    from better_fastlio2_tpu_torch.io.session import (SessionWriter,
                                                      _quat_to_matrix)
    from better_fastlio2_tpu_torch.ops import certifiable
    from better_fastlio2_tpu_torch.utils import se3, so3

    t_run = time.perf_counter()
    out = {"phase": "apps", "card": card}
    t2g = {round(g["scan_beg_abs"] + g["scan_end_t"], 6): g for g in groups}
    h = 1.5  # the slam sequence's mount: its world frame is gt - (0, 0, h)

    def truth(g):
        q = so3.matrix_to_quat(torch.as_tensor(g["gt_rot"], dtype=torch.float64))
        return np.concatenate([q.numpy(), g["gt_pos"] - [0.0, 0.0, h]])

    if keep:
        os.makedirs(keep, exist_ok=True)
    with (contextlib.nullcontext(keep) if keep
          else tempfile.TemporaryDirectory()) as root:
        cdir, qdir, q_truth = _app_sessions(pipe, root, APP_ANCHOR)

        # -- multi-session merge (tests/test_multisession.py gates) --------
        def merger(qdir):
            def merge(device, dtype):
                m = MultiSessionMerger(cdir, qdir, MultiSessionConfig(
                    sc_dist_thresh=0.5, dtype=dtype), device=device)
                stats = m.run()
                nums = {"poses": m.graph.poses.double().cpu().numpy(),
                        "pairs": np.array(m.sc_pairs + m.rs_pairs,
                                          np.float64),
                        "anchor": m.query_anchor()}
                return nums, (m, stats)
            return merge

        def merge_errors(m, q_truth, anchor):
            poses = m.graph.poses.double().cpu().numpy()
            q_err = np.linalg.norm(poses[m.nc:, 4:7] - q_truth[:, 4:7],
                                   axis=1)
            return float(np.mean(q_err)), float(np.linalg.norm(
                m.query_anchor()[4:7] - np.array(anchor[1])))

        # the merge runs ~11 three-level ICP cascades and three GN solves:
        # a rounding difference of the reduction order (the card's, or the
        # CPU's own thread count) can flip a nearest neighbour and moves
        # the f64 poses by ~1e-6-1e-5 m; the loops found must be the same
        (m, stats), timing = _hold("multi_session", merger(qdir), 1e-4,
                                   device, exact=("pairs",), spread=True)
        q_err, a_err = merge_errors(m, q_truth, APP_ANCHOR)
        if (stats["sc_loops"] + stats["rs_loops"] < 3 or q_err >= 0.3
                or a_err >= 0.3):
            fail(f"apps: multi_session {stats}, query error {q_err:.4f} m, "
                 f"anchor error {a_err:.4f} m (>= 3 loops, < 0.3 m each)")
        _, wdir, w_truth = _app_sessions(pipe, root, APP_ANCHOR_WIDE, "wide")
        (_, (mw, wstats)), ms_w = _run_app(merger(wdir), torch.device(device),
                                           "float32")
        wq, wa = merge_errors(mw, w_truth, APP_ANCHOR_WIDE)
        out["multi_session"] = dict(
            timing, anchor=APP_ANCHOR, central_keyframes=m.nc,
            query_keyframes=m.nq, **stats, query_mean_err_m=q_err,
            anchor_err_m=a_err,
            gate={"loops": 3, "query_mean_err_m": 0.3, "anchor_err_m": 0.3},
            wide_anchor_not_gated=dict(
                wstats, anchor=APP_ANCHOR_WIDE, query_mean_err_m=wq,
                anchor_err_m=wa, host_ms_cuda_f32=ms_w))

        # -- online relocalization (tests/test_online_relo.py gates) ------
        t_odom = _yaw(*RELO_ODOM_FRAME)
        kf_true = [truth(t2g[round(kf.t, 6)]) for kf in pipe.keyframes]
        frames = []
        for s in RELO_SCANS:
            g = groups[s]
            tw = truth(g)
            # the pose the central map implies for this scan: the nearest
            # keyframe's estimate composed with the true relative motion
            k = int(np.argmin([np.linalg.norm(p[4:7] - tw[4:7])
                               for p in kf_true]))
            rel = _host_pose(se3.between, kf_true[k], tw)
            frames.append((np.asarray(g["pts"], np.float64)[::2],
                           _host_pose(se3.compose, t_odom, tw),
                           _host_pose(se3.compose, pipe.keyframes[k].pose,
                                      rel)))

        def relo(device, dtype):
            r = OnlineRelocalizer(cdir, ReloConfig(
                sc_dist_thresh=0.6, search_dis=12.0, dtype=dtype),
                device=device)
            res = [r.process(cloud, odom) for cloud, odom, _ in frames]
            got = [x for x in res if x is not None]
            return ({"answered": np.array([x is not None for x in res]),
                     "poses": np.stack([x["pose"] for x in got])
                     if got else np.zeros((0, 7))}, (r, res))

        (r, res), timing = _hold("online_relo", relo, 1e-8, device,
                                 exact=("answered",))
        # globalRelo may refuse a frame (process returns None until it
        # succeeds, pose_estimator.cpp:152-179): a Scan Context column
        # shift off by a few sectors on a raw scan puts the ICP start
        # outside its basin.  After it, every frame is in relo mode.
        answered = [x is not None for x in res]
        first = answered.index(True) if any(answered) else len(res)
        errs = [float(np.linalg.norm(x["pose"][4:7] - f[2][4:7]))
                for x, f in zip(res, frames) if x is not None]
        modes = [x["mode"] for x in res if x is not None]
        if (not r.initialized or first > 1 or not all(answered[first:])
                or modes[1:] != ["relo"] * (len(modes) - 1)
                or max(errs) >= 0.25):
            fail(f"apps: online_relo answered {answered}, modes {modes}, "
                 f"errors {errs} (initialised by the second frame, then "
                 "every frame in relo mode, < 0.25 m)")
        out["online_relo"] = dict(timing, frames=len(res),
                                  initialised_at_frame=first, modes=modes,
                                  max_err_m=max(errs),
                                  gate={"max_err_m": 0.25,
                                        "initialised_by_frame": 1})

        # -- object update (tests/test_object_update.py gates) -------------
        rng = np.random.default_rng(13)
        kfs = pipe.keyframes[10:13]
        centre = pipe.keyframes[11].pose[4:7]
        kept = centre + [4.0, -3.0, 0.0]  # in both sessions
        planted = centre + [6.0, 3.0, 0.0]  # in the central session only
        added = centre + [-5.0, 4.0, 0.0]  # in the query session only

        def box(c):
            return np.stack([rng.uniform(c[0] - 0.3, c[0] + 0.3, 400),
                             rng.uniform(c[1] - 0.3, c[1] + 0.3, 400),
                             rng.uniform(-h + 0.05, -h + 0.6, 400)], 1)

        for name, extra in (("objc", planted), ("objq", added)):
            w = SessionWriter(os.path.join(root, name))
            b = np.concatenate([box(kept), box(extra)])
            for kf in kfs:
                R = _quat_to_matrix(kf.pose[:4])
                body_box = (b - kf.pose[4:7]) @ R
                cloud = np.concatenate([
                    kf.cloud + rng.normal(scale=0.01, size=kf.cloud.shape),
                    body_box]).astype(np.float32)
                w.add_keyframe(cloud, np.zeros(len(cloud)), np.zeros((20, 60)),
                               kf.pose, t=kf.t)
            w.save()

        def objects(device, dtype):
            u = ObjectUpdater(os.path.join(root, "objc"),
                              os.path.join(root, "objq"),
                              ObjectUpdateConfig(sensor_height=h,
                                                 dtype=dtype), device=device)
            rr = u.run()
            cats = ("fused", "new", "old")
            nums = {k: (np.concatenate(rr[k]) if rr[k] else np.zeros((0, 3)))
                    for k in cats}
            nums["counts"] = np.array(
                [rr["n_central_objects"], rr["n_query_objects"]]
                + [len(c) for k in cats for c in rr[k]])
            return nums, rr

        rr, timing = _hold("object_update", objects, 1e-8, device,
                           exact=("counts",))

        def near(clouds, c):
            return any(np.linalg.norm(cl.mean(0)[:2] - c[:2]) < 1.5
                       for cl in clouds)

        if (rr["n_central_objects"] < 2 or rr["n_query_objects"] < 2
                or not rr["fused"] or not near(rr["new"], added)
                or not near(rr["old"], planted)):
            fail(f"apps: object_update found {rr['n_central_objects']} / "
                 f"{rr['n_query_objects']} objects, {len(rr['fused'])} fused,"
                 f" the added box new: {near(rr['new'], added)}, the planted "
                 f"box old: {near(rr['old'], planted)}")
        out["object_update"] = dict(
            timing, central_objects=rr["n_central_objects"],
            query_objects=rr["n_query_objects"], fused=len(rr["fused"]),
            new=len(rr["new"]), old=len(rr["old"]))

        # -- certifiable registration (tests/test_certifiable.py gates) ---
        # the mirrored test's scene, two independent samples of it under a
        # 120-degree yaw and a large offset, seen from 1 m above its floor:
        # with the viewpoint on the floor's plane the normals' orientation
        # toward it (the sign of n . p ~ 0) flips between neighbours and
        # their theta sits on atan2's branch cut, where rounding alone
        # picks the histogram bin
        T = _yaw(FPFH_YAW, FPFH_T)
        lift = np.array([0.0, 0.0, 1.0])
        tgt = asym_scene(np.random.default_rng(42)) - lift
        src = _host_pose(se3.apply, _host_pose(se3.inverse, T),
                         asym_scene(np.random.default_rng(1234)) - lift)

        def register(src, tgt):
            def run(device, dtype):
                dt = torch.float32 if dtype == "float32" else torch.float64
                st = torch.as_tensor(src, dtype=dt, device=device)
                tt = torch.as_tensor(tgt, dtype=dt, device=device)
                res = certifiable.register_fpfh_gnc(
                    st, torch.ones(len(src), dtype=torch.bool, device=device),
                    tt, torch.ones(len(tgt), dtype=torch.bool, device=device),
                    feature_radius=1.0, noise_bound=0.5)
                return ({"pose": res.pose.double().cpu().numpy(),
                         "inliers": res.inliers.cpu().numpy(),
                         "fitness": res.fitness.double().cpu().numpy()}, res)
            return run

        def errors(res):
            err = _host_pose(se3.between, T, res.pose.double().cpu().numpy())
            return (float(np.linalg.norm(err[4:7])),
                    float(so3.quat_log(torch.as_tensor(err[:4])).norm()),
                    int(res.n_inliers))

        res, timing = _hold("register_fpfh_gnc", register(src, tgt), 1e-8,
                            device, exact=("inliers",))
        t_err, r_err, n_in = errors(res)
        if t_err >= 1.0 or r_err >= 0.15 or n_in <= 15:
            fail(f"apps: register_fpfh_gnc t_err {t_err:.4f} m, r_err "
                 f"{r_err:.4f} rad, {n_in} inliers (< 1.0, < 0.15, > 15)")
        # not gated: the same on two independent halves of a slam
        # keyframe's scan, which the simplified FPFH does not register
        # (most returns lie beyond 20 m, too sparse for 1 m features)
        s = min(range(len(groups)),
                key=lambda j: abs(groups[j]["scan_beg_abs"]
                                  + groups[j]["scan_end_t"]
                                  - pipe.keyframes[20].t))
        pts = np.asarray(groups[s]["pts"], np.float64)
        hsrc = _host_pose(se3.apply, _host_pose(se3.inverse, T), pts[1::2])
        (_, kres), _ = _run_app(register(hsrc, pts[0::2]),
                                torch.device(device), "float32")
        kt, kr, kn = errors(kres)
        out["register_fpfh_gnc"] = dict(
            timing, points=[len(src), len(tgt)], t_err_m=t_err,
            r_err_rad=r_err, n_inliers=n_in,
            gate={"t_err_m": 1.0, "r_err_rad": 0.15, "n_inliers": 15},
            keyframe_scan_not_gated={"points": len(pts) // 2, "t_err_m": kt,
                                     "r_err_rad": kr, "n_inliers": kn})
        if keep:
            np.savez(os.path.join(root, "apps_inputs.npz"),
                     query_truth=q_truth, wide_truth=w_truth,
                     anchor=_yaw(*APP_ANCHOR),
                     wide_anchor=_yaw(*APP_ANCHOR_WIDE), fpfh_T=T,
                     fpfh_src=src, fpfh_tgt=tgt, halves_src=hsrc,
                     halves_tgt=pts[0::2])
    out["seconds"] = time.perf_counter() - t_run
    if keep:
        with open(os.path.join(keep, "apps.json"), "w") as f:
            json.dump(out, f)
    print(json.dumps(out), flush=True)
    return out


def run_perception_phases(card: str, device=None) -> dict:
    """The perception slice's front-end phases: dynamic, dynamic_window and
    perception_cuda on the labelled outdoor sequence."""
    t0 = time.perf_counter()
    groups = dynamic_sequence()
    print(json.dumps({"phase": "sequence_dynamic", "scans": len(groups),
                      "seconds": time.perf_counter() - t0}), flush=True)
    dyn, pipe = phase_dynamic("dynamic", groups, card, device=device)
    traj = np.array(pipe.lio.trajectory)
    del pipe
    dyn_w, pipe = phase_dynamic(
        "dynamic_window", groups, card,
        lio_kwargs=dict(window=DYN_WINDOW, quantized=True,
                        unroll=DYN_WINDOW), device=device)
    del pipe
    phase_perception_cuda(groups, traj, card, device or "cuda")
    return {"dynamic": dyn, "dynamic_window": dyn_w}


# run.py from a KITTI raw-sync directory (slice 7): the room sequence
# written in KITTI's byte layout, mapped through the port's CLI with the
# bench configuration from a YAML file, then the other three subcommands
# on the session it wrote
CLI_BASE_NS = 1_600_000_000 * 10 ** 9  # epoch of the written stamps, ns
CLI_SLICES = 32  # the time slices SyntheticWorld.scan samples a sweep in
CLI_SAME_ROWS = 40  # pos_log rows the in-process run must reproduce
CLI_RELO_SCANS = 12
# the mapping run's K1 calls held to the plain version: its first (on a
# map of one scan, eager), then pass 0 of graph replay 9 (a warmup scan)
# and of replay 120 (a steady one); online_relo's K2: its first (the
# first scan's update on an empty map, which the update gate selects
# away: an all-false mask, exactly 0) and pass 0 of replay 4
CLI_K1_CHECK = {"keep_eager": (1,), "keep_replays": (9, 120)}
CLI_K2_CHECK = {"keep_eager": (1,), "keep_replays": (4,)}


def kitti_stamp(t_ns: int) -> str:
    """One timestamps.txt line for epoch nanoseconds, in local time as the
    KITTI loader reads it back."""
    from datetime import datetime

    sec, ns = divmod(int(t_ns), 10 ** 9)
    return (datetime.fromtimestamp(sec).strftime("%Y-%m-%d %H:%M:%S")
            + f".{ns:09d}")


def write_kitti_dir(root: str, groups, traj=None) -> None:
    """Write `groups` as a KITTI raw-sync directory in its byte layout
    (tests/test_disk_e2e.py): velodyne_points/data/%010d.bin of f32
    x y z reflectance rows, timestamps.txt with each scan's END stamp,
    and one 30-field OXTS row per IMU sample (acceleration in fields
    14:17, angular rate in 20:23, kitti2bag.py:39-44), each sample once.
    With `traj`, the sequence's Trajectory, every cloud is first moved
    into its scan-end frame: KITTI's clouds come deskewed, and the loader
    stamps every point at the scan end (io/kitti.py)."""
    velo = os.path.join(root, "velodyne_points", "data")
    oxts = os.path.join(root, "oxts", "data")
    os.makedirs(velo)
    os.makedirs(oxts)
    imu = {}  # microseconds -> (acc, gyr)
    with open(os.path.join(root, "velodyne_points", "timestamps.txt"),
              "w") as f:
        for k, g in enumerate(groups):
            pts = np.array(g["pts"], np.float64)
            t0, dur = float(g["scan_beg_abs"]), float(g["scan_end_t"])
            if traj is not None:
                sl = np.minimum((np.asarray(g["pt_t"]) / dur
                                 * CLI_SLICES).astype(int), CLI_SLICES - 1)
                R1, p1 = traj.rot(t0 + dur), traj.pos(t0 + dur)
                for s in np.unique(sl):
                    m = sl == s
                    tm = t0 + (s + 0.5) * dur / CLI_SLICES
                    world = pts[m] @ traj.rot(tm).T + traj.pos(tm)
                    pts[m] = (world - p1) @ R1
            rows = np.zeros((len(pts), 4), np.float32)
            rows[:, :3] = pts
            rows.tofile(os.path.join(velo, f"{k:010d}.bin"))
            f.write(kitti_stamp(CLI_BASE_NS + round((t0 + dur) * 1e9))
                    + "\n")
            for j, t in enumerate(g["imu_t"]):
                imu.setdefault(round((t0 + float(t)) * 1e6),
                               (g["imu_acc"][j], g["imu_gyr"][j]))
    with open(os.path.join(root, "oxts", "timestamps.txt"), "w") as f:
        for j, us in enumerate(sorted(imu)):
            row = np.zeros(30)
            row[14:17], row[20:23] = imu[us]
            with open(os.path.join(oxts, f"{j:010d}.txt"), "w") as o:
                o.write(" ".join(f"{v:.9f}" for v in row) + "\n")
            f.write(kitti_stamp(CLI_BASE_NS + us * 1000) + "\n")


def write_config_yaml(path: str, cfg) -> None:
    """Write `cfg` as a YAML file of the reference's layout (the keys
    LIOConfig.from_dict reads), and fail unless it loads back equal."""
    import yaml

    from better_fastlio2_tpu_torch.config import load_yaml

    pre, mp, kd, sh = cfg.preprocess, cfg.mapping, cfg.ikdtree, cfg.shapes
    d = {
        "dtype": cfg.dtype,
        "preprocess": {k: getattr(pre, k) for k in (
            "lidar_type", "livox_type", "blind", "scan_line", "scan_rate",
            "point_filter_num", "time_unit", "feature_extract_enable")},
        "mapping": {
            **{k: getattr(mp, k) for k in (
                "gyr_cov", "acc_cov", "b_gyr_cov", "b_acc_cov", "det_range",
                "fov_degree", "extrinsic_est_en", "cube_len")},
            "mappingSurfLeafSize": mp.surf_leaf_size,
            "keyframeAddingDistThreshold": mp.keyframe_adding_dist_threshold,
            "keyframeAddingAngleThreshold":
                mp.keyframe_adding_angle_threshold,
            "extrinsic_T": list(mp.extrinsic_T),
            "extrinsic_R": list(mp.extrinsic_R)},
        "ikdtree": {
            **{k: getattr(kd, k) for k in (
                "max_iteration", "kd_step", "filter_size_map_min",
                "single_association", "plane_cache", "plane_cache_warmup",
                "mom_cap", "fused_solve", "mom_dense", "early_converge")},
            "recontructKdTree": kd.recontruct_kdtree},
        "shapes": {
            **{k: getattr(sh, k) for k in (
                "n_raw", "n_ds", "n_imu", "map_capacity_log2", "map_bucket",
                "map_max_probe", "knn_chunk", "knn_neighbors",
                "knn_max_live", "insert_claim_budget", "insert_dense_budget",
                "insert_mom_budget", "solve_compact", "map_dense_z_clip",
                "ds_drop_high_z", "assoc_cells")},
            "map_dense_log2": (list(sh.map_dense_log2)
                               if sh.map_dense_log2 is not None else None)},
    }
    with open(path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=False)
    back = load_yaml(path)
    if repr(back) != repr(cfg):
        fail(f"cli: {path} does not load back as the configuration written:"
             f"\n{back}\n{cfg}")


def _cli(argv: list[str]) -> tuple[dict, float]:
    """run.main(argv) in this process: its last line of standard output as
    JSON, and its seconds (the card synchronised at both ends)."""
    import contextlib
    import io

    from better_fastlio2_tpu_torch import run

    buf = io.StringIO()
    card_sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run.main(argv)
    card_sync()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    if not lines:
        fail(f"cli: {argv[0]} printed nothing")
    return json.loads(lines[-1]), seconds


def _read_rows(path: str) -> list[str]:
    with open(path) as f:
        return f.readlines()


def phase_cli(groups, card: str, native_rows: dict | None,
              device: str = "cuda") -> dict:
    """`run.py mapping` from a KITTI directory, the port's CLI end to end
    (slice 7), on `device`:

    1. the room sequence written as a KITTI raw-sync directory (each cloud
       in its scan-end frame, write_kitti_dir) and bench_config("room") as
       a YAML file; their seconds, and the loader's to read it all back;
    2. `mapping --dataset kitti:<dir> --config <yaml> --output S
       --state-log`, each scan a replay of its program's one-tick CUDA
       graph but each program's first: K1 on every updated scan, its
       calls CLI_K1_CHECK held against the plain version (the replays'
       from the graph's probes, on live lanes), K2 never; the torch syncs
       a scan (sync debug "warn") and the peak memory; the
       room gate on pos_log.txt against ground truth (each row describes
       the scan before the one whose stamp it carries: the SLAM front end
       is pipelined, and the reference's CLI writes it so too); the
       session read back; fast_lio_time_log.csv one row a scan, the
       median steady ms/scan from its totals;
    3. the first CLI_SAME_ROWS rows again from SLAMPipeline.process_scan
       on the loader's groups in this process with eager ticks
       (graphed=False), equal string for string;
    4. `online_relo --prior S --max-scans 12` with LIOConfig() defaults
       (the row path with extrinsic estimation): K2 on every pass, its
       calls CLI_K2_CHECK held against the plain version (graph replays
       as in 2); K1 never;
       initialized, at least
       one relo frame, 12 finite poses written;
    5. `multi_session --central S --query S`: at least one Scan Context
       loop, the merged session twice S's keyframes;
    6. `object_update --central S --query S`: every query object fused
       with its own copy, none new or old;
    7. the native library built and loaded (io.native.available()); the
       window phases' rows all packed by it (`native_rows`, None when the
       window phases did not run)."""
    import shutil
    import tempfile

    import torch

    from better_fastlio2_tpu_torch.config import load_yaml
    from better_fastlio2_tpu_torch.io import native
    from better_fastlio2_tpu_torch.io.kitti import KittiRawSequence
    from better_fastlio2_tpu_torch.io.pcd import read_pcd
    from better_fastlio2_tpu_torch.io.session import SessionReader
    from better_fastlio2_tpu_torch.io.synthetic import Trajectory
    from better_fastlio2_tpu_torch.pipeline.slam import SLAMPipeline
    from better_fastlio2_tpu_torch.run import format_row
    from better_fastlio2_tpu_torch.utils.timing import CSV_HEADER

    if not native.available():
        fail("cli: the native host library did not build or load")
    if native_rows is not None and set(native_rows.values()) == {0}:
        fail(f"cli: the window phases packed no row natively: {native_rows}")
    cuda = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="bflio2_cli_")
    try:
        data, sess = os.path.join(tmp, "kitti"), os.path.join(tmp, "session")
        cfg_path = os.path.join(tmp, "bench_room.yaml")
        t0 = time.perf_counter()
        write_kitti_dir(data, groups, Trajectory(t_still=0.7, speed=3.0))
        write_config_yaml(cfg_path, bench_config("room"))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = list(KittiRawSequence(data).groups())  # the CLI's defaults
        load_s = time.perf_counter() - t0
        if len(loaded) != len(groups):
            fail(f"cli: the loader read {len(loaded)} of {len(groups)} scans")

        # 2. mapping
        reset_launches()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with warnings.catch_warnings(record=True) as caught, GraphProbe(
                "fused_normal_eqs", **CLI_K1_CHECK) as k1:
            warnings.simplefilter("always")
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                summary, map_s = _cli([
                    "mapping", "--dataset", f"kitti:{data}", "--config",
                    cfg_path, "--output", sess, "--state-log", "--device",
                    device])
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
        map_syncs = sum("synchroniz" in str(w.message) for w in caught)
        map_peak = torch.cuda.max_memory_allocated() if cuda else None
        map_reserved = torch.cuda.max_memory_reserved() if cuda else None
        launches = launches_ran()
        k1_checks = k1.checks()
        n_k1_checks = 1 + (len(CLI_K1_CHECK["keep_replays"]) if cuda else 0)
        if cuda and k1.body_checks != n_k1_checks - 1:
            fail(f"cli: {k1.body_checks} K1 calls checked inside a "
                 "conditional body")
        updated = len(groups) - 1  # every scan but the IMU init's
        if summary["scans"] != len(groups):
            fail(f"cli: mapping ran {summary['scans']} of {len(groups)} "
                 "scans")
        # every scan but each program's first replays its graph
        if cuda and (launches["fused_normal_eqs"] < updated
                     or launches["fused_hth"] or k1.replays != updated - 2
                     or len(k1_checks) != n_k1_checks
                     or not all(c["max_abs_G"] > 0 for c in k1_checks[1:])):
            fail(f"cli: mapping launched {launches} in {updated} updated "
                 f"scans, {k1.replays} graph replays ({len(k1_checks)} K1 "
                 "calls checked)")
        rows = _read_rows(os.path.join(sess, "pos_log.txt"))
        if len(rows) != updated - 1:
            fail(f"cli: pos_log.txt has {len(rows)} rows for {updated} "
                 "updated scans (the last one's result is still pending)")
        est = np.array([[float(v) for v in r.split()] for r in rows])
        gt = np.array([g["gt_pos"] for g in groups[1:1 + len(rows)]])
        if not np.all(np.isfinite(est)):
            fail("cli: pos_log.txt has non-finite values")
        ate, end = accuracy(est[:, 1:4], gt)
        if end > 0.030 or ate > 0.15:
            fail(f"cli accuracy gate: end error {end:.4f} m (<= 0.030), ATE"
                 f" {ate:.4f} m (<= 0.15)")
        reader = SessionReader(sess)
        poses = np.asarray(reader.poses)
        if (reader.num_keyframes != summary["keyframes"]
                or reader.num_keyframes < 2
                or not np.all(np.isfinite(poses))):
            fail(f"cli: the session read back has {reader.num_keyframes} "
                 f"keyframes (the CLI made {summary['keyframes']})")
        log = _read_rows(os.path.join(sess, "fast_lio_time_log.csv"))
        if log[0] != CSV_HEADER or len(log) != 1 + len(groups):
            fail(f"cli: fast_lio_time_log.csv has {len(log) - 1} rows, "
                 f"header {log[0]!r}")
        total_ms = [1e3 * float(r.split(",")[1]) for r in log[1:]]
        steady_ms = total_ms[PLANE_CACHE_WARMUP + 1:]

        # 3. the same scans in this process, without the CLI and with
        # eager ticks: the CLI's graph replays equal them bit for bit
        cfg = load_yaml(cfg_path)
        cfg.loop.enable = False  # as `mapping` without --loop
        pipe = SLAMPipeline(cfg, device=device,
                            lio_kwargs={"graphed": False})
        same = []
        try:
            for g in loaded[:CLI_SAME_ROWS + 2]:
                out = pipe.process_scan(
                    g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                    g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
                if out is not None:
                    same.append(format_row(g["scan_beg_abs"], *out["pos"],
                                           *out["quat"]))
        finally:
            pipe.close()
        del pipe
        if len(same) != CLI_SAME_ROWS or same != rows[:CLI_SAME_ROWS]:
            bad = next((i for i, (a, b) in enumerate(zip(same, rows))
                        if a != b), None)
            fail(f"cli: the in-process run's {len(same)} rows differ from "
                 f"the CLI's at row {bad}")

        # 4. online_relo with LIOConfig() defaults: the row path
        relo_dir = os.path.join(tmp, "relo")
        reset_launches()
        with GraphProbe("fused_hth", **CLI_K2_CHECK) as k2:
            relo, relo_s = _cli([
                "online_relo", "--prior", sess, "--dataset", f"kitti:{data}",
                "--max-scans", str(CLI_RELO_SCANS), "--output", relo_dir,
                "--device", device])
        relo_launches = launches_ran()
        k2_checks = k2.checks()
        n_k2_checks = 1 + (len(CLI_K2_CHECK["keep_replays"]) if cuda else 0)
        if cuda and k2.body_checks != n_k2_checks - 1:
            fail(f"cli: {k2.body_checks} K2 calls checked inside a "
                 "conditional body")
        relo_rows = np.array([[float(v) for v in r.split()] for r in
                              _read_rows(os.path.join(relo_dir,
                                                      "relo_pose.txt"))])
        if (not relo["initialized"] or relo["relo_frames"] < 1
                or relo["frames"] != CLI_RELO_SCANS
                or relo_rows.shape != (CLI_RELO_SCANS, 7)
                or not np.all(np.isfinite(relo_rows))):
            fail(f"cli: online_relo {relo}, relo_pose.txt "
                 f"{relo_rows.shape}")
        if cuda and (relo_launches["fused_hth"] < CLI_RELO_SCANS
                     or relo_launches["fused_normal_eqs"]
                     or k2.replays < CLI_RELO_SCANS - 1
                     or len(k2_checks) != n_k2_checks
                     or not all(c["n_valid"] > 0 for c in k2_checks[1:])):
            fail(f"cli: online_relo launched {relo_launches}, "
                 f"{k2.replays} graph replays, {len(k2_checks)} K2 calls "
                 "checked")

        # 5. multi_session of S with itself
        ms_dir = os.path.join(tmp, "merged")
        ms, ms_s = _cli(["multi_session", "--central", sess, "--query", sess,
                         "--output", ms_dir, "--device", device])
        merged = SessionReader(os.path.join(ms_dir, "merged_session"))
        merged_map, _ = read_pcd(os.path.join(ms_dir, "aft_map2.pcd"))
        if (ms["sc_loops"] < 1
                or merged.num_keyframes != 2 * reader.num_keyframes
                or not len(merged_map)):
            fail(f"cli: multi_session {ms}, merged session "
                 f"{merged.num_keyframes} keyframes, map {len(merged_map)}")

        # 6. object_update of S with itself
        ou_dir = os.path.join(tmp, "objects")
        ou, ou_s = _cli(["object_update", "--central", sess, "--query", sess,
                         "--output", ou_dir, "--device", device])
        n_pts = {k: len(read_pcd(os.path.join(ou_dir, f"objects_{k}.pcd"))[0])
                 for k in ("fused", "new", "old")}
        if (ou["n_central_objects"] != ou["n_query_objects"]
                or ou["fused"] != ou["n_query_objects"]
                or ou["new"] or ou["old"] or n_pts["new"] or n_pts["old"]):
            fail(f"cli: object_update {ou}, points {n_pts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {
        "phase": "cli", "scans": len(groups), "device": device,
        "seconds": time.perf_counter() - t_phase,
        "summary": summary, "seconds_mapping": map_s,
        "ms_per_scan_median_steady": float(np.median(steady_ms)),
        "ms_per_scan_median_warmup": float(np.median(
            total_ms[1:PLANE_CACHE_WARMUP + 1])),
        "write_s": write_s, "load_s": load_s,
        "ate_m": ate, "end_err_m": end,
        "gate": {"end_err_m": 0.030, "ate_m": 0.15},
        "pos_log_rows": len(rows), "rows_equal_in_process": len(same),
        "rows_equal_in_process_eager": len(same),
        "keyframes": reader.num_keyframes,
        "graphed": cuda, "graph_replays": k1.replays,
        "torch_syncs_per_scan_mapping": map_syncs / len(groups),
        "max_memory_allocated_mapping": map_peak,
        "max_memory_reserved_mapping": map_reserved,
        "graph_kernel_nodes_vs_calls_at_capture": k1.graph_nodes,
        "k1_launches": launches["fused_normal_eqs"],
        "k1_launches_per_updated_scan": launches["fused_normal_eqs"]
        / updated,
        "k1_checks": k1_checks,
        "online_relo": {**relo, "seconds": relo_s,
                        "graph_replays": k2.replays,
                        "k2_launches": relo_launches["fused_hth"],
                        "k2_checks": k2_checks},
        "multi_session": {**ms, "seconds": ms_s,
                          "merged_keyframes": merged.num_keyframes},
        "object_update": {**ou, "seconds": ou_s, "points": n_pts},
        "native": {"available": True, "library": native.LIB_PATH,
                   "window_rows_packed": native_rows},
        "card": card,
    }
    print(json.dumps(out), flush=True)
    return out


# ---- slice 8: the SPMD window step over torch.distributed ----------------

SPMD_WINDOW = 8  # bench.py's room window, unquantized under a mesh
OVERRIDE_NDEV = (2, 4)  # one rank's share of a D-rank program, timed
OVERRIDE_SCANS = 48
TWO_RANK_SCANS = 64  # init + 15 warmup scans (two windows) + 6 windows
SHARDED_SCANS = 25  # init + 24 ticks of the ownership-sharded step
TWO_RANK_TOL_M = 2e-3  # tests/test_spmd_step.py:91
SHARDED_GATE = {"ate_m": 0.15, "end_err_m": 0.2}  # tests/test_sharded.py


def nccl_mesh():
    """A one-rank NCCL group in this process on its card, and its mesh;
    NCCL's absence or a failed init fails the smoke."""
    import socket

    from better_fastlio2_tpu_torch.parallel.collectives import make_mesh
    from better_fastlio2_tpu_torch.parallel.distributed import \
        init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda",
                         timeout_s=300.0)
        return make_mesh(device="cuda")
    except Exception as e:  # reported, and the smoke fails
        fail(f"spmd_room_window: the NCCL group did not start: {e!r}")


def _clone_state(a):
    import torch

    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple):
        return type(a)(*(_clone_state(x) for x in a))
    return a


def override_device_ms(cfg, pipe, groups, ndev: int) -> dict:
    """Device ms per scan of one rank's share of an ndev-rank SPMD window
    program (make_spmd_window_step_fn(override_ndev=ndev), the
    reference's scaling hook) on this one-rank mesh: captured as a CUDA
    graph of SPMD_WINDOW ticks from a copy of the pipeline's final state,
    then the windows of the last OVERRIDE_SCANS scans replayed back to
    back with CUDA events around them (median of 5 groups; the first
    window warms up and captures).  Its outputs are 1/ndev-partial: it
    is timed, not gated."""
    import torch

    from better_fastlio2_tpu_torch.parallel.sharded import \
        make_spmd_window_step_fn
    from better_fastlio2_tpu_torch.pipeline import graphs, lio

    W = SPMD_WINDOW
    ls = _clone_state(pipe.ls)
    wstep = make_spmd_window_step_fn(cfg, pipe.mesh, W, ls, unroll=W,
                                     override_ndev=ndev)
    view = functools.partial(lio._view_window, n_raw=pipe._n_pts,
                             n_imu=cfg.shapes.n_imu, quantized=False)
    sg = graphs.StepGraph(wstep, view, W, pipe._acc_t)
    n_win = OVERRIDE_SCANS // W
    wins = [pipe._pack_window([window_entry(pipe, g) for g in
                               groups[len(groups) - (n_win - c) * W:][:W]]
                              ).to("cuda") for c in range(n_win)]
    sg.warm_up_and_capture(ls, wins[0])
    torch.cuda.synchronize()
    group_ms = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for w in wins[1:]:
            sg.replay(w)
        e.record()
        e.synchronize()
        group_ms.append(s.elapsed_time(e) / ((n_win - 1) * W))
    out = {"override_ndev": ndev, "scans": OVERRIDE_SCANS,
           "device_ms_per_scan": float(np.median(group_ms)),
           "device_ms_groups": group_ms,
           "k1_nodes_per_step": sg.nodes["fused_normal_eqs"] / W,
           "kernel_nodes_per_step": sg.nodes["kernel_nodes"] / W}
    del sg
    return out


def phase_spmd_room_window(groups, bench_room: dict, mesh) -> dict:
    """The SPMD window step at world size 1 under NCCL (slice 8):
    bench_config("room") at bench.py's full shapes, W = 8 unquantized,
    unroll 8, all room scans, through LIOPipeline(mesh=) and, beside it,
    through the window pipeline without a mesh (both run_window_path: the
    steady windows replay one captured CUDA graph under sync debug
    "error", K1's calls inside it held against the plain version, K1 on
    an eager warmup call too).  The two trajectories equal (one rank:
    the collectives are identities), held to 1e-6 m; the room gate; the
    graph's nodes per tick with K1's and NCCL's apart and the
    collectives each tick runs; then one rank's share of a 2- and a
    4-rank program timed (override_ndev)."""
    import torch

    cfg = bench_config("room")
    ref = run_window_path("spmd_ref_room_window", cfg, groups, 0.030, 0.15,
                          bench_room, quantized=False, window=SPMD_WINDOW)
    ref_traj = ref.pop("traj")
    warm = []  # K1's first call, the warmup program's, against plain
    res = run_window_path("spmd_room_window", cfg, groups, 0.030, 0.15,
                          bench_room, quantized=False, mesh=mesh,
                          window=SPMD_WINDOW, warm_probe=warm)
    traj = res.pop("traj")
    n_loc = cfg.shapes.n_ds // mesh.size
    if not warm or warm[0][0].shape[1] != n_loc:
        fail(f"spmd_room_window: no live K1 call of the warmup program at "
             f"the rank's width {n_loc}")
    warm_check = compare_k1(*warm[0])
    if traj.shape != ref_traj.shape:
        fail(f"spmd_room_window: {traj.shape} rows against the non-mesh "
             f"run's {ref_traj.shape}")
    diff = float(np.abs(traj[:, :3] - ref_traj[:, :3]).max())
    if diff > 1e-6:
        fail(f"spmd_room_window: {diff:.3e} m from the non-mesh window "
             "pipeline (> 1e-6 m)")
    if res["graph_nccl_kernel_nodes_per_step"] + res["graph_nodes_by_type"].get(
            "memcpy", 0) == 0 and not any(res["collectives_per_step"].values()):
        fail("spmd_room_window: the captured graph ran no collective")
    # the mesh step keeps its selects; the same step without a mesh
    # captures its gates as IF nodes
    if (res["graph_conditional_nodes_per_step"]
            or not ref["graph_conditional_nodes_per_step"]):
        fail(f"spmd_room_window: {res['graph_conditional_nodes_per_step']} "
             "conditional nodes a tick with the mesh, "
             f"{ref['graph_conditional_nodes_per_step']} without")
    # the pipeline of this phase is gone; a fresh one for the overrides
    from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline

    pipe = LIOPipeline(cfg, pipelined=True, window=SPMD_WINDOW,
                       unroll=SPMD_WINDOW, mesh=mesh)
    for g in groups[:len(groups) - OVERRIDE_SCANS]:
        pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                          g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
    pipe.flush()
    overrides = [override_device_ms(cfg, pipe, groups, d)
                 for d in OVERRIDE_NDEV]
    del pipe
    torch.cuda.empty_cache()
    out = {
        "phase": "spmd_room_window_summary",
        "mesh": {"size": mesh.size, "backend": mesh.backend},
        "traj_max_diff_vs_non_mesh_m": diff,
        "ms_per_scan_steady": res["ms_per_scan_steady"],
        "ms_per_scan_steady_non_mesh": ref["ms_per_scan_steady"],
        "device_ms_per_scan": res["device_ms_per_scan"],
        "device_ms_per_scan_non_mesh": ref["device_ms_per_scan"],
        "graph_kernel_nodes_per_step": res[
            "graph_kernel_nodes_per_step_unprobed"],
        "graph_kernel_nodes_per_step_non_mesh": ref[
            "graph_kernel_nodes_per_step_unprobed"],
        "graph_k1_nodes_per_step": res["graph_k1_nodes_per_step"],
        "graph_nccl_kernel_nodes_per_step": res[
            "graph_nccl_kernel_nodes_per_step"],
        "graph_nodes_by_type": res["graph_nodes_by_type"],
        "graph_nodes_by_type_non_mesh": ref["graph_nodes_by_type"],
        "graph_conditional_nodes_per_step_non_mesh": ref[
            "graph_conditional_nodes_per_step"],
        "collectives_per_step": res["collectives_per_step"],
        "torch_syncs_per_steady_window": res[
            "torch_syncs_per_steady_window"],
        "max_memory_allocated": res["max_memory_allocated"],
        "ate_m": res["ate_m"], "end_err_m": res["end_err_m"],
        "k1_warmup_check": warm_check,
        "override_ndev": overrides,
    }
    print(json.dumps(out), flush=True)
    return {"spmd": res, "ref": ref, "traj": traj,
            "checks": res["checks"] + [warm_check], "summary": out}


def _launch(argv: list[str], out_path: str, timeout: float) -> dict:
    """parallel/launch.py with `argv` in a subprocess (its ranks share
    this card through gloo); a rank that fails, hangs or times out fails
    the smoke."""
    cmd = [sys.executable, "-m", "better_fastlio2_tpu_torch.parallel.launch",
           *argv, "--device", "cuda", "--backend", "gloo",
           "--timeout", str(timeout - 30), "--out", out_path]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout, cwd=os.path.dirname(
                                 os.path.abspath(__file__)))
    except subprocess.TimeoutExpired:
        fail(f"spmd_two_rank: {' '.join(argv)} ran past {timeout} s")
    if res.returncode != 0:
        fail(f"spmd_two_rank: {' '.join(argv)} exited {res.returncode}:\n"
             f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    with open(out_path) as f:
        return json.load(f)


def _rank_checks(name: str, report: dict, kernel: str, width: int) -> list:
    """Each rank's recorded kernel call, held against the plain version
    in that rank: within tolerance and at the rank's width."""
    checks = []
    for r in report["ranks"]:
        (c,) = r["checks"]
        if (c["name"] != kernel or not c.get("ok") or c.get("n") != width
                or not c.get("max_abs_out")):
            fail(f"{name}: rank {r['rank']}'s {kernel} check {c} (width "
                 f"{width} expected)")
        checks.append(c)
    return checks


def phase_spmd_two_rank(spmd_traj: np.ndarray, mesh) -> dict:
    """Two ranks on the one card through parallel/launch.py, gloo on CUDA
    tensors (staged through the host: the ticks run eagerly, no graph):
    the SPMD window step over the first TWO_RANK_SCANS room scans at the
    full shapes (16 warmup, then W = 8): both ranks' trajectories and
    dense moment tables bit-identical, the trajectory within 2e-3 m of
    the world-size-1 run, K1 at width n_ds / 2 held against its plain
    version on one call per rank.  Then the ownership-sharded step over
    SHARDED_SCANS scans: K2 (6 columns) at the rank's width against its
    plain version, both ranks' poses bit-identical, and the trajectory,
    and that of a one-rank run of the same step (in this process, on the
    one-rank NCCL mesh), held to the gate of the reference's own test of
    this step (tests/test_sharded.py:193-194: ATE < 0.15 m, end error
    < 0.2 m).  The two runs' difference is printed, not held to
    2e-3 m: each rank downsamples its own raw shard, so a voxel that
    straddles the shards gives one centroid per rank, and the two runs
    associate different batches (the reference's design, :357-367)."""
    import argparse
    import tempfile

    import torch

    from better_fastlio2_tpu_torch import config as tcfg
    from better_fastlio2_tpu_torch.io import synthetic
    from better_fastlio2_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="spmd_two_rank_")
    spmd = _launch(["--nprocs", "2", "--spmd", "--workload", "room",
                    "--n-scans", str(TWO_RANK_SCANS), "--window",
                    str(SPMD_WINDOW), "--check-kernels"],
                   os.path.join(tmp, "spmd.json"), 600)
    r0, r1 = spmd["ranks"]
    t_r0, t_r1 = np.asarray(r0["traj"]), np.asarray(r1["traj"])
    if not (np.array_equal(t_r0, t_r1)
            and r0["dmom_sha256"] == r1["dmom_sha256"]):
        fail("spmd_two_rank: the two ranks' trajectories or dense moment "
             "tables differ")
    if r0["graphed"] or t_r0.shape != (TWO_RANK_SCANS - 1, 7):
        fail(f"spmd_two_rank: graphed={r0['graphed']} (a gloo mesh runs "
             f"eagerly), {t_r0.shape} rows")
    diff = float(np.abs(t_r0[:, :3] - spmd_traj[:len(t_r0), :3]).max())
    if diff > TWO_RANK_TOL_M:
        fail(f"spmd_two_rank: {diff:.3e} m from the world-size-1 run "
             f"(> {TWO_RANK_TOL_M} m)")
    n_loc = launch.ROOM["shapes"]["n_ds"] // 2
    k1_checks = _rank_checks("spmd_two_rank", spmd, "fused_normal_eqs",
                             n_loc)
    t_spmd = time.perf_counter() - t0
    # the ownership-sharded step, two ranks, then one rank here
    sh2 = _launch(["--nprocs", "2", "--workload", "room", "--n-scans",
                   str(SHARDED_SCANS), "--check-kernels"],
                  os.path.join(tmp, "sharded.json"), 600)
    s0, s1 = sh2["ranks"]
    if not np.array_equal(np.asarray(s0["traj"]), np.asarray(s1["traj"])):
        fail("sharded_step: the two ranks' poses differ")
    k2_checks = _rank_checks("sharded_step", sh2, "fused_hth", n_loc)
    cfg = launch.workload_config(tcfg, "room", False, "float32")
    groups = launch.workload_sequence(synthetic, "room", SHARDED_SCANS,
                                      spmd=False)
    args = argparse.Namespace(check_kernels=False)
    one = launch._run_sharded(args, cfg, groups, mesh)
    one.pop("tables")
    torch.cuda.empty_cache()
    d_sh = float(np.abs(np.asarray(s0["traj"])[:, :3]
                        - np.asarray(one["traj"])[:, :3]).max())
    gt = np.array([g["gt_pos"] for g in groups[1:]])
    acc_sh = {}
    for k, t in (("two_ranks", s0["traj"]), ("one_rank", one["traj"])):
        ate, end = accuracy(np.asarray(t), gt)
        if not (end < SHARDED_GATE["end_err_m"]
                and ate < SHARDED_GATE["ate_m"]):
            fail(f"sharded_step ({k}) accuracy gate: end error {end:.4f} "
                 f"m, ATE {ate:.4f} m (gate {SHARDED_GATE})")
        acc_sh[k] = {"ate_m": ate, "end_err_m": end}
    out = {
        "phase": "spmd_two_rank", "ranks": 2, "backend": spmd["backend"],
        "device": spmd["device"], "graphed": False,
        "scans": TWO_RANK_SCANS, "window": SPMD_WINDOW,
        "traj_max_diff_vs_world_size_1_m": diff,
        "rank_seconds": [r["seconds"] for r in spmd["ranks"]],
        "k1_launches_by_rank": [r["launches"]["fused_normal_eqs"]
                                for r in spmd["ranks"]],
        "k1_checks": k1_checks, "seconds": t_spmd,
        "sharded_step": {
            "scans": SHARDED_SCANS, "pos_max_diff_vs_one_rank_m": d_sh,
            "accuracy": acc_sh, "gate": SHARDED_GATE,
            "k2_launches_by_rank": [r["launches"]["fused_hth"]
                                    for r in sh2["ranks"]],
            "k2_launches_one_rank": one["launches"]["fused_hth"],
            "live_voxels_by_rank": [r["live_voxels"] for r in sh2["ranks"]],
            "rank_seconds": [r["seconds"] for r in sh2["ranks"]],
            "k2_checks": k2_checks},
        "seconds_total": time.perf_counter() - t0,
    }
    if min(out["k1_launches_by_rank"]) < 1 or min(
            out["sharded_step"]["k2_launches_by_rank"]) < 1:
        fail(f"spmd_two_rank: a rank launched no kernel: {out}")
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
    args = sys.argv[1:]
    keep = (args[args.index("--save-app-inputs") + 1]
            if "--save-app-inputs" in args else None)
    phase_build()
    if "--only-slam" in sys.argv[1:]:
        # a development run of the slice-5 phases alone: no result lines
        print(card, flush=True)
        run_slam_phases(make_bench_sequence("room", N_SCANS), None)
        return
    if "--only-cli" in sys.argv[1:]:
        # a development run of the slice-7 phase alone: no result lines
        print(card, flush=True)
        phase_cli(make_bench_sequence("room", N_SCANS), card, None)
        return
    if "--only-spmd" in sys.argv[1:]:
        # a development run of the slice-8 phases alone (the bench_room
        # phase first, for its per-scan time): no result lines
        print(card, flush=True)
        groups = make_bench_sequence("room", N_SCANS)
        bench_room = summarize(
            "bench_room", run_main_path(bench_config("room"), groups),
            "fused_normal_eqs", 0.030, 0.15,
            program_warmup=PLANE_CACHE_WARMUP)
        mesh = nccl_mesh()
        spmd = phase_spmd_room_window(groups, bench_room, mesh)
        phase_spmd_two_rank(spmd["traj"], mesh)
        torch.distributed.destroy_process_group()
        return
    if "--only-perception" in sys.argv[1:]:
        # a development run of the slice-6 phases alone (slam runs for the
        # apps phase's keyframes): no result lines
        print(card, flush=True)
        run_perception_phases(card)
        _, pipe, sgroups = run_slam_phases(None, None, handoff=False)
        phase_apps(pipe, sgroups, card, keep=keep)
        return
    floor_us = launch_floor_us()
    if_node_cost(floor_us)
    k1 = phase_kernels(floor_us)
    k2 = phase_k2(floor_us)
    imu_k = phase_imu(floor_us)
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
    slam, slam_pipe, slam_groups = run_slam_phases(
        groups, room_w["ms_per_scan_steady"])
    perception = run_perception_phases(card)
    phase_apps(slam_pipe, slam_groups, card, keep=keep)
    del slam_pipe, slam_groups
    cli = phase_cli(groups, card, {p["phase"]: p["native_packed_rows"]
                                   for p in (room_w, outdoor_w)})
    mesh = nccl_mesh()
    spmd = phase_spmd_room_window(groups, bench_room, mesh)
    two = phase_spmd_two_rank(spmd["traj"], mesh)
    torch.distributed.destroy_process_group()
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
                        for p in (room_w, outdoor_w, slam)})
    k1_by_phase.update({k: p["k1_launches"] for k, p in perception.items()})
    k1_by_phase["cli"] = cli["k1_launches"]
    k1_by_phase.update({
        "spmd_ref_room_window": spmd["ref"]["k1_launches_executed"],
        "spmd_room_window": spmd["spmd"]["k1_launches_executed"],
        "spmd_two_rank": sum(two["k1_launches_by_rank"])})
    k1_err = max([k1_err] + [c["max_abs_err"] for c in cli["k1_checks"]
                             + spmd["checks"] + spmd["ref"]["checks"]
                             + two["k1_checks"]])
    k2_by_phase = {p["phase"]: p["launches_total"] for p in (row, row_ext)}
    k2_by_phase.update({k: p["k2_launches"] for k, p in perception.items()})
    k2_by_phase["cli"] = cli["online_relo"]["k2_launches"]
    k2_by_phase["sharded_step"] = sum(
        two["sharded_step"]["k2_launches_by_rank"])
    k2_err = max(c["max_abs_err"] for c in
                 k2["checks"] + row["checks"] + row_ext["checks"]
                 + [c for p in perception.values() for c in p["k2_checks"]]
                 + cli["online_relo"]["k2_checks"]
                 + two["sharded_step"]["k2_checks"])
    k2_t = k2["timing"]["ext"]
    imu_by_phase = {p["phase"]: p["imu_stage_launches"]
                    for p in (main_out, row, row_ext, bench_room,
                              bench_outdoor)}
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
        # calls checked that ran inside a CUDA-graph conditional body
        "checks_in_conditional_bodies": sum(
            p["checks_in_conditional_bodies"]
            for p in (main_out, bench_room, bench_outdoor)),
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
        "launches": sum(k2_by_phase.values()),
        "launches_by_phase": k2_by_phase,
        "checks_in_conditional_bodies": sum(
            p["checks_in_conditional_bodies"] for p in (row, row_ext)),
        "max_abs_err": k2_err,
        "ms": k2_t["ms"],
        "device_us": k2_t["device_us"],
        "plain_ms": k2_t["plain_ms"],
        "bound_ms": k2_t["bound_ms"],
        "bound_by": k2_t["bound_by"],
        "library_ms": k2_t["library_ms"],
        "library_device_us": lib["k2_library_device_us"]["ext"],
        "launch_floor_us": floor_us,
    }, {
        "name": "imu_stage",
        "route": "cuda",
        "source": "better_fastlio2_tpu_torch/csrc/imu_stage.cu",
        "replaces": None,  # the port's own: the JAX package's is plain XLA
        "launches_by_phase": imu_by_phase,
        "max_err_over_tol": imu_k["max_err_over_tol"],
        "timing": imu_k["timing"],
        "launch_floor_us": floor_us,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
