"""Run a function on D gloo ranks of the port for a test.

`run_ranks(fn, nprocs, *args)` spawns `nprocs` processes (start method
"spawn"), joins them to one gloo group on a free local port through
parallel.distributed.init_distributed, makes the CPU mesh and calls
fn(mesh, *args) on each; it returns the ranks' results in rank order.
`fn` must live in a module the children can import (this one, which
imports no JAX).  Each rank runs one torch thread; a rank that raises
fails the call with its traceback, and the whole run is bounded by
`timeout` seconds (every rank is stopped then).

`launch(argv)` runs parallel/launch.py in a subprocess and returns the
JSON its rank 0 wrote.

The worker functions below are the ranks' side of the multi-device test
files (tests/test_torch_{collectives,spmd_step,sharded,slab_migration,
sharded_gn}.py): each takes numpy inputs and returns numpy outputs.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, nprocs, port, fn, args, queue):
    try:
        import torch
        import torch.distributed as dist

        from better_fastlio2_tpu_torch.parallel.collectives import make_mesh
        from better_fastlio2_tpu_torch.parallel.distributed import \
            init_distributed

        torch.set_num_threads(1)
        init_distributed(f"127.0.0.1:{port}", nprocs, rank, device="cpu",
                         timeout_s=120.0)
        try:
            out = fn(make_mesh(device="cpu"), *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:  # reported to the parent, which fails the test
        queue.put((rank, None, traceback.format_exc()))


def run_ranks(fn, nprocs: int, *args, timeout: float = 240.0) -> list:
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, nprocs, port, fn, args, q))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    outs: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(outs) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{nprocs} ranks ran past {timeout} s")
            try:
                rank, out, err = q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died with exit code "
                                       f"{dead[0].exitcode}")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            outs[rank] = out
    finally:
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
    return [outs[r] for r in range(nprocs)]


def launch(argv: list[str], out_path, timeout: float = 300.0) -> dict:
    """python -m better_fastlio2_tpu_torch.parallel.launch *argv --out
    out_path; returns the JSON written (asserting the run succeeded)."""
    res = subprocess.run(
        [sys.executable, "-m", "better_fastlio2_tpu_torch.parallel.launch",
         *argv, "--out", str(out_path)],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    with open(out_path) as f:
        return json.load(f)


# ---- rank workers ----------------------------------------------------------


def w_collectives(mesh):
    """psum, all_gather and ppermute of rank-dependent values."""
    import torch

    from better_fastlio2_tpu_torch.parallel import collectives as c

    r, D = mesh.rank, mesh.size
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3) * (r + 1)
    ring = [(i, (i + 1) % D) for i in range(D)]
    return {
        "psum_f64": c.psum(x, mesh).numpy(),
        "psum_i32": c.psum(torch.tensor(r + 3, dtype=torch.int32),
                           mesh).numpy(),
        "gather_f32": c.all_gather(x.float() + r, mesh).numpy(),
        "gather_i16": c.all_gather(torch.full((3, 2), r - 7,
                                              dtype=torch.int16),
                                   mesh).numpy(),
        "gather_bool": c.all_gather(torch.tensor([r % 2 == 0, True]),
                                    mesh).numpy(),
        "gather_scalar": c.all_gather(torch.tensor(10.0 * r), mesh).numpy(),
        "ppermute_ring": c.ppermute(x, mesh, ring).numpy(),
        "ppermute_bool": c.ppermute(torch.tensor([r == 0, r == 1]), mesh,
                                    ring).numpy(),
        # only rank 0 sends: the others receive zeros
        "ppermute_partial": c.ppermute(x + 1.0, mesh,
                                       [(0, D - 1)]).numpy(),
        "axis_index": c.axis_index(mesh),
        "calls": dict(c.calls),
    }


def w_insert_dense(mesh, cases):
    """insert_dense_moments in mesh mode on each case's (dmom0, dshape,
    voxel, batch, valid, mom_cap, budget, pre_sliced)."""
    import torch

    from better_fastlio2_tpu_torch.map import voxel_hash as vh

    out = []
    for dmom0, dshape, voxel, batch, valid, cap, budget, pre in cases:
        dmom = torch.as_tensor(dmom0).clone()
        pts, val = torch.as_tensor(batch), torch.as_tensor(valid)
        if pre:  # this rank's rows of a pre-sliced batch
            n = pts.shape[0] // mesh.size
            pts, val = (pts[mesh.rank * n:(mesh.rank + 1) * n],
                        val[mesh.rank * n:(mesh.rank + 1) * n])
        vs = torch.tensor(voxel, dtype=dmom.dtype)
        d, n_new = vh.insert_dense_moments(
            dmom, tuple(dshape), vs, pts, val, mom_cap=cap,
            mom_budget=budget, mesh=mesh, spmd_pre_sliced=pre)
        if pre:  # a second pass: the cell is owned now, rows accumulate
            d, _ = vh.insert_dense_moments(
                d, tuple(dshape), vs, pts, val, mom_cap=cap,
                mom_budget=budget, mesh=mesh, spmd_pre_sliced=pre)
        out.append((d.numpy(), int(n_new)))
    return out


def _map_from(m_np, voxel, dtype):
    import torch

    from better_fastlio2_tpu_torch.map import voxel_hash as vh

    return vh.VoxelHashMap(
        key=torch.as_tensor(m_np["key"]), count=torch.as_tensor(m_np["count"]),
        points=torch.as_tensor(m_np["points"]), dense=None,
        voxel_size=torch.tensor(voxel, dtype=dtype),
        mom=(torch.as_tensor(m_np["mom"]) if m_np.get("mom") is not None
             else None))


def _tables(m) -> dict:
    """Copies of the map's tables (the inserts update them in place)."""
    return {"key": m.key.numpy().copy(), "count": m.count.numpy().copy(),
            "points": m.points.numpy().copy(),
            "mom": m.mom.numpy().copy() if m.mom is not None else None}


def w_sharded_map(mesh, pts, q, pts_b, cap_log2):
    """The ownership-sharded map: insert, kNN, a second insert."""
    import torch

    from better_fastlio2_tpu_torch.parallel import sharded

    ms = sharded.make_sharded_map(mesh, capacity_log2_per_dev=cap_log2,
                                  bucket=4, voxel_size=0.5)
    ins = sharded.sharded_map_insert(mesh)
    ms = ins(ms, torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool))
    t1 = _tables(ms)
    nb, d2, ok = sharded.sharded_map_knn(mesh, k=5)(ms, torch.as_tensor(q))
    ms = ins(ms, torch.as_tensor(pts_b),
             torch.ones(len(pts_b), dtype=torch.bool))
    return {"tables": t1, "knn": (nb.numpy(), d2.numpy(), ok.numpy()),
            "tables2": _tables(ms)}


def w_row_reduce(mesh, h_x, h, mask, x_np, P, m_np, pts, valid):
    """sharded_hth_reduce and sharded_update_step on this rank's rows
    (contiguous row shards, as the reference's P(axis))."""
    import torch

    from better_fastlio2_tpu_torch.core.state import State
    from better_fastlio2_tpu_torch.parallel import sharded

    def mine(a):
        n = len(a) // mesh.size
        return torch.as_tensor(a[mesh.rank * n:(mesh.rank + 1) * n])

    HtH, Hth = sharded.sharded_hth_reduce(mesh)(mine(h_x), mine(h),
                                                mine(mask))
    x = State(*(torch.as_tensor(v) for v in x_np))
    m = _map_from(m_np, float(m_np["voxel"]), torch.float64)
    dx, n = sharded.sharded_update_step(mesh)(x, torch.as_tensor(P), m,
                                              mine(pts), mine(valid))
    return HtH.numpy(), Hth.numpy(), dx.numpy(), float(n)


def w_slab(mesh, pts, slab_log2, max_rows, cap_log2):
    """Slab-owned insert at shift 0, then ring migration to shift 1 until
    nothing is left."""
    import torch

    from better_fastlio2_tpu_torch.parallel import sharded

    ms = sharded.make_sharded_map(mesh, capacity_log2_per_dev=cap_log2,
                                  bucket=4, voxel_size=0.5, moments=True)
    ms = sharded.sharded_slab_insert(mesh, slab_log2=slab_log2)(
        ms, 0, torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool))
    before = _tables(ms)
    mig = sharded.sharded_slab_migrate(mesh, slab_log2=slab_log2,
                                       max_rows=max_rows)
    steps = []
    for _ in range(40):  # a capped buffer: step until drained
        ms, n_left, bts, n_lost = mig(ms, 1)
        steps.append((int(n_left), int(bts), int(n_lost)))
        if int(n_left) == 0:
            break
    return {"before": before, "after": _tables(ms), "steps": steps}


def w_posegraph(mesh, poses, bw_i, bw_j, bw_meas, bw_w, v, prior_w,
                cg_iters, gn_steps, gn_cg_iters):
    """sharded_posegraph_hvp and one sharded_gn_step (cg_iters) on this
    rank's factors (contiguous shards), then gn_steps steps of the GN
    (gn_cg_iters) from the same poses."""
    import torch

    from better_fastlio2_tpu_torch.parallel import sharded

    def mine(a):
        n = len(a) // mesh.size
        return torch.as_tensor(a[mesh.rank * n:(mesh.rank + 1) * n])

    f = [mine(a) for a in (bw_i, bw_j, bw_meas, bw_w)]
    P = torch.as_tensor(poses)
    hv = sharded.sharded_posegraph_hvp(mesh)(P, *f, torch.as_tensor(v))
    one = sharded.sharded_gn_step(mesh, cg_iters=cg_iters)(P, *f, prior_w)
    step = sharded.sharded_gn_step(mesh, cg_iters=gn_cg_iters)
    for _ in range(gn_steps):
        P = step(P, *f, prior_w)
    return hv.numpy(), one.numpy(), P.numpy()


def w_spmd_wstep(mesh, n_scans, window, override_ndev):
    """LIOPipeline(mesh=) over the scans; the state before its last window
    (a steady one) copied, and that window run again from the copy by
    make_spmd_window_step_fn (with override_ndev: one rank's share of an
    override_ndev-rank program).  Returns both windows' info rows."""
    import torch

    from better_fastlio2_tpu_torch import config as tcfg
    from better_fastlio2_tpu_torch.io import synthetic
    from better_fastlio2_tpu_torch.parallel import launch, sharded
    from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline

    cfg = launch.workload_config(tcfg, "small", True, "float64")
    groups = launch.workload_sequence(synthetic, "small", n_scans)
    pipe = LIOPipeline(cfg, window=window, mesh=mesh)
    wins, states = [], []
    pack = pipe._pack_window

    def recording_pack(buf):
        wins.append(pack(buf))
        states.append(type(pipe.ls)(*(_clone(a) for a in pipe.ls)))
        return wins[-1]

    pipe._pack_window = recording_pack
    for g in groups:
        pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                          g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
    pipe.flush()
    assert states[-1].map.dmom is not None  # the last window is steady
    wstep = sharded.make_spmd_window_step_fn(
        cfg, mesh, window, states[-1], override_ndev=override_ndev)
    ls, infos = wstep(states[-1], pipe._view(wins[-1]),
                      torch.tensor(pipe.acc_norm, dtype=torch.float64))
    return (np.asarray(pipe.trajectory)[-window:], infos.numpy(),
            pipe.ls.map.dmom.numpy(), ls.map.dmom.numpy())


def _clone(a):
    import torch

    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple):
        return type(a)(*(_clone(x) for x in a))
    return a
