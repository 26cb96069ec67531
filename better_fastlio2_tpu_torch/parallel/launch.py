"""Run the port's multi-device programs on D ranks.

The counterpart of tools/multihost_run.py: the ranks join one
torch.distributed group over a TCP coordinator (parallel.distributed.
init_distributed: gloo on the CPU, NCCL on CUDA unless --backend says
gloo) and run one of two programs on the same synthetic scans:

  --spmd   the SPMD window pipeline, LIOPipeline(mesh=...): map and filter
           state replicated, the per-point work shared by rows;
  default  the ownership-sharded tick, make_sharded_step_fn: the map split
           across the ranks by a voxel hash, 5-NN merge for the first
           scans, then the psum'd moment planes.

Spawned (one command; each rank a process, joined with a timeout, all of
them stopped when one fails or the timeout passes):

    python -m better_fastlio2_tpu_torch.parallel.launch --nprocs 2 \\
        --device cpu --spmd --n-scans 24 --out out.json

By hand, one command per process (a multi-host run):

    python -m better_fastlio2_tpu_torch.parallel.launch --process-id 0 \\
        --num-processes 2 --coordinator 127.0.0.1:29500 --device cpu ...

Rank 0 writes --out: one JSON object with each rank's trajectory (f64
positions and quaternions, as the pipeline returns them), the checksums
of its map tables, its kernel launches and, with --check-kernels, the
first K1 (SPMD) or K2 (sharded tick) call of the run held against the
kernel's plain version.  --save DIR keeps each rank's tables as
rank<r>.npz.  Workloads: "small" (the shapes and sequences of
tests/test_spmd_step.py and tests/test_sharded.py; a rank's table holds
2^14 slots, the 8-device reference's aggregate at 2 ranks) and "room"
(the bench configuration of the room benchmark at its full shapes).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import sys
import time

import numpy as np

# ---- workloads: one config for either package's config module ----

SMALL_SPMD = dict(
    shapes=dict(n_raw=4096, n_ds=2048, n_imu=32, map_capacity_log2=14,
                map_bucket=4, map_max_probe=8, knn_chunk=2048,
                map_dense_log2=(8, 8, 5), map_dense_z_clip=True,
                insert_mom_budget=2048),
    mapping=dict(gyr_cov=0.1, acc_cov=0.1, b_gyr_cov=1e-4, b_acc_cov=1e-4,
                 det_range=20.0, cube_len=400.0, surf_leaf_size=0.4,
                 extrinsic_est_en=False),
    ikdtree=dict(max_iteration=3, filter_size_map_min=0.4, plane_cache=True,
                 plane_cache_warmup=12, mom_dense=True,
                 single_association=True, early_converge=True),
)
SMALL_SHARDED = dict(  # map_capacity_log2: each rank's table
    shapes=dict(n_raw=4096, n_ds=4096, n_imu=32, map_capacity_log2=14,
                map_bucket=4, map_max_probe=8, knn_chunk=2048),
    mapping=dict(det_range=60.0, cube_len=400.0, surf_leaf_size=0.4,
                 extrinsic_est_en=False),
    ikdtree=dict(max_iteration=3, filter_size_map_min=0.4, plane_cache=True),
)
ROOM = dict(  # chip_smoke.bench_config("room"), bench.py:249-309
    shapes=dict(n_raw=1 << 15, n_ds=1 << 14, n_imu=16, map_capacity_log2=20,
                map_bucket=4, map_max_probe=6, knn_chunk=1 << 14,
                map_dense_log2=(8, 8, 7), knn_max_live=12,
                insert_claim_budget=2048, insert_dense_budget=2048,
                insert_mom_budget=4096),
    mapping=dict(det_range=60.0, cube_len=400.0, surf_leaf_size=0.5,
                 extrinsic_est_en=False),
    ikdtree=dict(max_iteration=4, filter_size_map_min=0.5,
                 single_association=True, plane_cache=True,
                 plane_cache_warmup=16, fused_solve=True, mom_dense=True,
                 early_converge=True),
)
WORKLOADS = {("small", True): SMALL_SPMD, ("small", False): SMALL_SHARDED,
             ("room", True): ROOM, ("room", False): ROOM}
WARMUP_KNN_SCANS = 12  # the sharded tick's 5-NN scans (tests/test_sharded.py)


def workload_config(mod, workload: str, spmd: bool, dtype: str):
    """The LIOConfig of a workload, built with the config module `mod`
    (this package's or the JAX package's: the fields are the same)."""
    spec = WORKLOADS[(workload, spmd)]
    cfg = mod.LIOConfig()
    cfg.dtype = dtype
    cfg.shapes = mod.ShapesConfig(**spec["shapes"])
    cfg.mapping = mod.MappingConfig(**spec["mapping"])
    cfg.ikdtree = mod.IkdtreeConfig(**spec["ikdtree"])
    return cfg


def workload_sequence(syn, workload: str, n_scans: int, spmd: bool = True):
    """The scans of a workload, from the synthetic module `syn`: n_scans
    measurement groups (the first initialises the IMU).  "small" takes
    the sequence of tests/test_spmd_step.py (spmd) or of
    tests/test_sharded.py (the sharded tick)."""
    if workload == "room":
        return syn.make_bench_sequence("room", n_scans)
    n_points, t_still, speed = (3000, 1.0, 2.0) if spmd else (3500, 1.2, 1.5)
    groups = syn.make_lio_sequence(
        duration=n_scans / 10.0, scan_rate=10.0, imu_rate=100.0,
        n_points=n_points, seed=3, noise=0.004,
        traj=syn.Trajectory(t_still=t_still, speed=speed))
    return groups[:n_scans]


# ---- one rank ------------------------------------------------------------


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class _KernelProbe:
    """Records the first call of a kernel wrapper that a module calls by
    name whose output is not all zeros (a call with live rows; inputs and
    outputs copied), to hold against the plain version after the run.
    Each call until then reads its output on the host."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.call = None

    def __enter__(self):
        import torch

        def spy(*args, **kw):
            out = self.real(*args, **kw)
            if self.call is None and bool(torch.any(out[0] != 0)):
                self.call = ([a.clone() for a in args], dict(kw),
                             [o.clone() for o in out])
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def check(self) -> dict:
        """max_abs_err and its share of the kernel's tolerance (ok: every
        entry within it) of the recorded call; the plain version on the
        CPU is the kernel's own path, which only the card can differ
        from."""
        from ..ops import kernels

        if self.call is None:
            return {"name": self.name, "calls": 0, "ok": False}
        args, kw, out = self.call
        if self.name == "fused_normal_eqs":
            (G_r, mv_r), (tol_G, slack, _) = (
                kernels.fused_normal_eqs_reference(*args),
                kernels.fused_normal_eqs_tolerance(*args))
            pairs, width = [(out[0], G_r, tol_G)], args[0].shape[1]
            moved_ok = abs(float(out[1]) - float(mv_r)) <= slack
        else:
            ref = kernels.fused_hth_reference(*args, **kw)
            tol = kernels.fused_hth_tolerance(*args, **kw)
            pairs, width = list(zip(out, ref, tol)), args[0].shape[0]
            moved_ok = True
        err, over, ok = 0.0, 0.0, moved_ok
        scale = float(out[0].abs().max())
        for o, r, t in pairs:
            d = (o.double() - r.double()).abs()
            err = max(err, float(d.max()))
            over = max(over, float((d / t.clamp(min=1e-300)).max()))
            ok = ok and bool((d <= t).all())
        return {"name": self.name, "n": int(width), "max_abs_err": err,
                "max_abs_out": scale, "max_err_over_tol": over, "ok": ok,
                "device": str(args[0].device)}


def _run_spmd(args, cfg, groups, mesh) -> dict:
    """LIOPipeline(mesh=...) over the scans; each rank feeds every scan."""
    import torch

    from ..core import measurement
    from ..ops import kernels
    from ..pipeline.lio import LIOPipeline

    pipe = LIOPipeline(cfg, window=args.window, unroll=args.window,
                       mesh=mesh)
    kernels.fused_normal_eqs.launches = 0
    with _KernelProbe(measurement, "fused_normal_eqs") as probe:
        for g in groups:
            pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"],
                              g["imu_gyr"], g["imu_t"], g["scan_beg_abs"],
                              g["scan_end_t"])
        pipe.flush()
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
    m = pipe.ls.map
    out = {"traj": np.asarray(pipe.trajectory, np.float64).tolist(),
           "pos": pipe.ls.x.pos.double().cpu().numpy().tolist(),
           "dmom_sha256": _digest(m.dmom),
           "dmom_sum": (float(m.dmom.double().sum()) if m.dmom is not None
                        else None),
           "graphed": pipe.graph is not None,
           "launches": {"fused_normal_eqs": kernels.fused_normal_eqs.launches},
           "tables": {"dmom": m.dmom, "mom": m.mom, "key": m.key}}
    if args.check_kernels:
        out["checks"] = [probe.check()]
    return out


def _run_sharded(args, cfg, groups, mesh) -> dict:
    """make_sharded_step_fn over the scans (5-NN merge for the first
    WARMUP_KNN_SCANS), each rank holding its share of the map."""
    import torch

    from ..core import imu
    from ..ops import kernels
    from ..utils import so3
    from . import sharded

    dt = torch.float64 if cfg.dtype == "float64" else torch.float32
    npdt = np.float64 if cfg.dtype == "float64" else np.float32
    dev = mesh.device
    sh = cfg.shapes
    step = sharded.make_sharded_step_fn(cfg, mesh)
    m = sharded.make_sharded_map(
        mesh, capacity_log2_per_dev=sh.map_capacity_log2,
        bucket=sh.map_bucket, voxel_size=cfg.ikdtree.filter_size_map_min,
        dtype=dt, moments=True)
    g0 = groups[0]

    def t(a, dtype=dt):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    x, P, acc_norm = imu.imu_init(
        t(g0["imu_acc"]), t(g0["imu_gyr"]),
        torch.ones(len(g0["imu_acc"]), dtype=torch.bool, device=dev),
        so3.quat_identity(dt, dev), torch.zeros(3, dtype=dt, device=dev), dt)
    n_raw, m_imu, D = sh.n_raw, sh.n_imu, mesh.size
    rows = slice(mesh.rank * n_raw // D, (mesh.rank + 1) * n_raw // D)
    last_end = g0["scan_beg_abs"] + g0["scan_end_t"]
    half = cfg.mapping.cube_len / 2.0
    cube_lo, cube_hi = t(np.full(3, -half)), t(np.full(3, half))
    tail = torch.zeros((2, 3), dtype=dt, device=dev)
    traj = []
    kernels.fused_hth.launches = 0
    with _KernelProbe(sharded, "fused_hth") as probe:
        for gi, g in enumerate(groups[1:]):
            n = min(len(g["pts"]), n_raw)
            Pp = np.zeros((n_raw, 3), npdt)
            Tt = np.zeros(n_raw, npdt)
            Vv = np.zeros(n_raw, bool)
            Pp[:n], Tt[:n], Vv[:n] = g["pts"][:n], g["pt_t"][:n], True
            k = min(len(g["imu_acc"]), m_imu)
            A = np.zeros((m_imu, 3), npdt)
            G = np.zeros((m_imu, 3), npdt)
            Ti = np.full(m_imu, np.inf, npdt)
            Mk = np.zeros(m_imu, bool)
            A[:k], G[:k], Ti[:k], Mk[:k] = (g["imu_acc"][:k],
                                            g["imu_gyr"][:k],
                                            g["imu_t"][:k], True)
            batch = imu.ImuBatch(acc=t(A), gyr=t(G), t=t(Ti),
                                 mask=t(Mk, torch.bool))
            ler = last_end - g["scan_beg_abs"]
            last_end = g["scan_beg_abs"] + g["scan_end_t"]
            x, P, m, tail = step(
                x, P, m, t(Pp[rows]), t(Tt[rows]), t(Vv[rows], torch.bool),
                batch, t(ler), t(g["scan_end_t"]), acc_norm, cube_lo,
                cube_hi, tail[0], tail[1], gi < WARMUP_KNN_SCANS)
            traj.append(torch.cat([x.pos, x.rot]).double().cpu().numpy())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    live = int(((m.key & (1 << 30)) != 0).sum())
    out = {"traj": np.asarray(traj).tolist(),
           "pos": x.pos.double().cpu().numpy().tolist(),
           "table_sha256": _digest(m.key, m.count, m.points, m.mom),
           "live_voxels": live,
           "launches": {"fused_hth": kernels.fused_hth.launches},
           "tables": {"key": m.key, "count": m.count, "points": m.points,
                      "mom": m.mom}}
    if args.check_kernels:
        out["checks"] = [probe.check()]
    return out


def rank_main(rank: int, args) -> None:
    """One rank: join the group, make the mesh, run the program, report
    to rank 0, which writes --out."""
    import torch
    import torch.distributed as dist

    from .. import config as tcfg
    from ..io import synthetic
    from .collectives import make_mesh
    from .distributed import init_distributed

    # one intra-op thread a rank: ranks of the CPU tests run beside
    # several test workers
    torch.set_num_threads(1)
    device = torch.device(args.device)
    init_distributed(args.coordinator, args.num_processes, rank,
                     device=device, timeout_s=args.timeout,
                     backend=args.backend)
    try:
        mesh = make_mesh(device=device)
        cfg = workload_config(tcfg, args.workload, args.spmd, args.dtype)
        groups = workload_sequence(synthetic, args.workload, args.n_scans,
                                   args.spmd)
        t0 = time.perf_counter()
        res = (_run_spmd if args.spmd else _run_sharded)(args, cfg, groups,
                                                          mesh)
        res.update(rank=rank, seconds=time.perf_counter() - t0)
        tables = res.pop("tables")
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            np.savez(os.path.join(args.save, f"rank{rank}.npz"),
                     traj=np.asarray(res["traj"]),
                     **{k: v.cpu().numpy() for k, v in tables.items()
                        if v is not None})
        reports = [None] * mesh.size
        dist.all_gather_object(reports, res)
        if rank == 0 and args.out:
            with open(args.out, "w") as f:
                json.dump({"world_size": mesh.size, "backend": mesh.backend,
                           "device": str(mesh.device),
                           "workload": args.workload, "spmd": args.spmd,
                           "dtype": args.dtype, "ranks": reports}, f)
        print(json.dumps({"rank": rank, "scans": len(res["traj"]),
                          "seconds": res["seconds"],
                          "launches": res["launches"]}), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args) -> int:
    """Start --nprocs ranks as spawned processes on a local coordinator
    and wait for them, at most --timeout seconds in all; when one fails
    or time runs out the others are stopped.  Returns the exit code."""
    import torch.multiprocessing as mp

    args.num_processes = args.nprocs
    args.coordinator = args.coordinator or f"127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, args), daemon=False)
             for r in range(args.nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + args.timeout
    code = 0
    while any(p.is_alive() for p in procs):
        if time.monotonic() > deadline:
            print(f"launch: ranks still running after {args.timeout} s",
                  file=sys.stderr)
            code = 124
            break
        failed = [p for p in procs if p.exitcode not in (None, 0)]
        if failed:
            print(f"launch: rank {procs.index(failed[0])} exited with "
                  f"{failed[0].exitcode}", file=sys.stderr)
            code = 1
            break
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()
    if code == 0 and any(p.exitcode != 0 for p in procs):
        code = 1
    return code


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nprocs", type=int, default=None,
                    help="spawn this many ranks here")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (by-hand mode)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (spawned: a free local port)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cuda, gloo on the cpu")
    ap.add_argument("--spmd", action="store_true",
                    help="the SPMD window pipeline (else the "
                         "ownership-sharded tick)")
    ap.add_argument("--workload", choices=("small", "room"), default="small")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--n-scans", type=int, default=24)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--check-kernels", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds: the ranks' join and each collective")
    ap.add_argument("--out", default=None)
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)
    if (args.nprocs is None) == (args.process_id is None):
        ap.error("give --nprocs (spawn) or --process-id (by hand)")
    if args.process_id is not None and not (args.num_processes
                                            and args.coordinator):
        ap.error("--process-id needs --num-processes and --coordinator")
    if args.backend is None:
        args.backend = "nccl" if args.device.startswith("cuda") else "gloo"
    if args.backend == "nccl" and not args.device.startswith("cuda"):
        ap.error("NCCL runs on cuda")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.nprocs is not None:
        return spawn(args)
    rank_main(args.process_id, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
