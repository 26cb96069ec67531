#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build   — compile every kernel of the port from its sources (nvcc,
               sm_90a), one compiler per source, all started together;
  2. kernels — hold each kernel against its plain PyTorch version on the
               card at the main path's shapes (and ragged ones), and time
               both with CUDA events (median of >= 50 runs after warmup);
  3. main    — run LIOPipeline, the port's entry point, over 240 scans of
               the room benchmark sequence at the full bench shapes, count
               the kernel launches and host syncs of that run, re-check the
               kernel on three of its scans, and gate the trajectory on the
               room accuracy gate of bench.py (end error <= 0.030 m,
               ATE <= 0.15 m).

Output: the card's name and power limit, one line per phase, one
{"kernels": [...]} line, and last {"ok": true, "device": {...}}.  Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N_SCANS = 240
WARMUP_SCANS = 20
CHECK_SCANS = (60, 130, 200)  # scans whose kernel inputs are re-checked
TIMING_RUNS = 100
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores
K1_FLOPS_PER_LANE = 140  # transform, residual, gate, rows, 36 FMAs, voxel test


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


def time_ms(fn, runs: int = TIMING_RUNS, warmup: int = 10) -> float:
    """Median device time of one call, CUDA events around each call."""
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


def phase_build() -> None:
    from better_fastlio2_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    dt = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "sources": _build.SOURCES,
                      "compiled": built, "seconds": round(dt, 3)}),
          flush=True)


def phase_kernels() -> dict:
    import torch

    from better_fastlio2_tpu_torch.ops import kernels

    checks = []
    for n, seed in ((16384, 1), (10240 + 37, 2), (1, 3)):
        soa, params = random_soa(n, seed)
        soa, params = soa.cuda(), params.cuda()
        G, mv = kernels.fused_normal_eqs(soa, params)
        torch.cuda.synchronize()
        checks.append(compare_k1(soa, params, G, mv))
    zero = torch.zeros(kernels.SOA_CH, 4096, device="cuda")
    G0, mv0 = kernels.fused_normal_eqs(zero, params)
    torch.cuda.synchronize()
    if int(torch.count_nonzero(G0)) != 0 or float(mv0) != 0.0:
        fail("K1 on an all-zero buffer is not exactly zero")

    n = 16384  # n_ds at the room bench shapes
    soa, params = random_soa(n, 1)
    soa, params = soa.cuda(), params.cuda()
    ms = time_ms(lambda: kernels.fused_normal_eqs(soa, params))
    plain_ms = time_ms(lambda: kernels.fused_normal_eqs_reference(soa,
                                                                  params))
    # the 13 live channels of the buffer (13-15 are padding the kernel
    # never reads), the pose, and G plus n_moved written
    bytes_moved = 13 * n * 4 + params.numel() * 4 + (64 + 1) * 4
    bound_ms = 1e3 * max(bytes_moved / PEAK_BYTES_PER_S,
                         K1_FLOPS_PER_LANE * n / PEAK_F32_PER_S)
    out = {"phase": "kernels", "checks": checks, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "timed_n": n,
           "timing_runs": TIMING_RUNS}
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


def run_main_path(cfg, groups, device=None, check_scans=CHECK_SCANS) -> dict:
    """Drive LIOPipeline over `groups`; return the per-scan record, the
    kernel's launch count over the run (counts set to 0 just before) and
    its re-checks on `check_scans` (inputs captured as the path made them,
    compared after the run)."""
    import torch

    from better_fastlio2_tpu_torch.core import measurement
    from better_fastlio2_tpu_torch.ops import kernels
    from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
    from better_fastlio2_tpu_torch.utils.device import host_syncs

    k1 = kernels.fused_normal_eqs
    captured = []

    def spy(soa, params):  # records the path's own K1 inputs and outputs
        G, mv = k1(soa, params)
        captured.append((soa.clone(), params.clone(), G.clone(), mv.clone()))
        return G, mv

    pipe = LIOPipeline(cfg, device=device)
    cuda = pipe.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gt, scan_ms, launches, syncs, outs = [], [], [], [], []
    k1.launches = 0
    host_syncs.reset()
    for i, g in enumerate(groups):
        if pipe.inited:
            gt.append(g["gt_pos"])
        l0, s0 = k1.launches, host_syncs.count
        measurement.fused_normal_eqs = spy if i in check_scans else k1
        t0 = time.perf_counter()
        try:
            out = pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"],
                                    g["imu_gyr"], g["imu_t"],
                                    g["scan_beg_abs"], g["scan_end_t"])
            if cuda:
                torch.cuda.synchronize()
        finally:
            measurement.fused_normal_eqs = k1
        dt = time.perf_counter() - t0
        if out is not None:
            scan_ms.append(1e3 * dt)
            launches.append(k1.launches - l0)
            syncs.append(host_syncs.count - s0)
            outs.append(out)
    total_launches = k1.launches
    peak = torch.cuda.max_memory_allocated() if cuda else None
    checks = [compare_k1(*c) for c in captured]
    return {"traj": np.array(pipe.trajectory), "gt": np.array(gt),
            "scan_ms": scan_ms, "launches": launches, "syncs": syncs,
            "outs": outs, "total_launches": total_launches,
            "checks": checks, "peak_bytes": peak}


def accuracy(traj: np.ndarray, gt: np.ndarray) -> tuple[float, float]:
    """ATE and end error as bench.py computes them: displacements from the
    first tracked scan."""
    n = min(len(traj), len(gt))
    est = traj[:n, :3] - traj[0, :3]
    ref = gt[:n] - gt[0]
    err = np.linalg.norm(est - ref, axis=1)
    return float(np.sqrt(np.mean(err ** 2))), float(err[-1])


def phase_main() -> dict:
    from better_fastlio2_tpu_torch.io.synthetic import make_bench_sequence

    t0 = time.perf_counter()
    groups = make_bench_sequence("room", N_SCANS)
    gen_s = time.perf_counter() - t0
    res = run_main_path(room_config(), groups)
    traj = res["traj"]
    if len(traj) != N_SCANS - 1 or not np.all(np.isfinite(traj)):
        fail(f"trajectory has {len(traj)} rows or non-finite values")
    # every scan but the first (which only builds the map) runs the update
    starved = [i for i, n in enumerate(res["launches"][1:], 1) if n < 1]
    if starved or res["total_launches"] < 1:
        fail(f"K1 launched {res['total_launches']} times; scans without a "
             f"launch: {starved[:10]}")
    if len(res["checks"]) < len(CHECK_SCANS):
        fail("the path's K1 inputs were not captured on every check scan")
    ate, end = accuracy(traj, res["gt"])
    if end > 0.030 or ate > 0.15:
        fail(f"room accuracy gate: end error {end:.4f} m (<= 0.030), ATE "
             f"{ate:.4f} m (<= 0.15)")
    n_ds = [o["n_ds"] for o in res["outs"]]
    n_eff = [o["n_eff"] for o in res["outs"]]
    steady = res["scan_ms"][WARMUP_SCANS:]
    out = {
        "phase": "main", "scans": len(traj), "sequence_gen_s": gen_s,
        "ms_per_scan_median": float(np.median(steady)),
        "ms_per_scan_p90": float(np.percentile(steady, 90)),
        "launches_total": res["total_launches"],
        "launches_per_scan": float(np.mean(res["launches"][1:])),
        "host_syncs_per_scan": float(np.mean(res["syncs"][1:])),
        "max_memory_allocated": res["peak_bytes"],
        "ate_m": ate, "end_err_m": end,
        "n_ds_mean": float(np.mean(n_ds)), "n_ds_min": int(np.min(n_ds)),
        "n_ds_max": int(np.max(n_ds)), "n_eff_mean": float(np.mean(n_eff)),
        "map_voxels_final": res["outs"][-1]["map_voxels"],
        "k1_checks": res["checks"],
    }
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    # the smoke runs on one card: make it the only one CUDA sees
    os.environ["CUDA_VISIBLE_DEVICES"] = first_card()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    try:
        import better_fastlio2_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from here: {e}")
    card = card_line()
    phase_build()
    kern = phase_kernels()
    main_out = phase_main()
    max_err = max([c["max_abs_err"] for c in kern["checks"]]
                  + [c["max_abs_err"] for c in main_out["k1_checks"]])
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_normal_eqs",
        "route": "cuda",
        "source": "better_fastlio2_tpu_torch/csrc/fused_normal_eqs.cu",
        "replaces": "better_fastlio2_tpu/ops/pallas_kernels.py:147",
        "launches": main_out["launches_total"],
        "max_abs_err": max_err,
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
