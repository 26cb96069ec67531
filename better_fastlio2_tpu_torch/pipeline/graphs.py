"""Capture and replay of a sync-free step as a CUDA graph.

The JAX reference runs each per-scan program as one jitted device program
(pipeline/lio.py:_make_step_core) and a window of W scans as one program
(a lax.scan of the tick, make_window_step_fn).  On a directly attached GPU
their counterpart is a CUDA graph of the step: the graph holds `steps`
consecutive ticks (one per scan in per-scan mode), captured once and
replayed, so a scan costs no host launches and no host reads.  Only a
step that reads nothing on the host can be captured (lio.make_step_fn
marks it `sync_free`); utils.device.to_host raises if a read slips in.

PyTorch's idiom, as torch.cuda.graphs documents it:
* a private memory pool holds every intermediate of the captured ticks;
* static buffers: the (steps, R) packed inputs the ticks read
  (`static_in`; a replay takes the next rows in one copy, non-blocking
  from pinned host memory), the (steps, 32) info rows they write
  (`static_info`), and the filter state (`ls`): the ticks start from its
  tensors and the last one's state is copied back into them with copy_,
  so that the replays chain.  The map tables are the pipeline's own
  tensors: a table the step updates in place needs no copy, one it
  replaces (the FoV crop) is copied back.  A state replaced between
  scans or windows (a map rebuild or reset, the SLAM back end's pose
  feedback) is copied into these same tensors (`load_state`);
* collectives of a mesh step (NCCL) are captured with it: the mesh's
  communicator exists before the capture (parallel.collectives.make_mesh),
  and the capture's "thread_local" error mode leaves NCCL's watchdog
  thread free to query its events;
* warm-up before capture on the capturing side stream.  The warm-up
  ticks are real scans (the program's first scan, or the first `steps`
  of the first steady window), run eagerly through the same tick;
  nothing is run twice and no throwaway tick touches the map.

The gates of a non-mesh step (the ESIKF pass loop, the refresh, the
compaction, the width of the solve, the row form's re-association) are
captured as CUDA-graph conditional (IF) nodes (utils.device.cond): a
replay runs only the passes and branches its device predicates pick, as
the reference's compiled While and Conditional ops do.  A mesh step keeps
their select form.  The hand-written kernels count the launches a replay
runs on the device (ops/kernels.device_counter, bumped beside each launch
inside the graph, so a skipped body counts nothing).

Capture failures raise; nothing falls back to eager execution.  The
cyclic garbage collector is held during capture: freeing another, dead
graph there would invalidate the capture.  The capture's error mode is
"thread_local": the SLAM back end's worker threads may run torch ops
while the front end captures.
"""

from __future__ import annotations

import ctypes
import gc
import time

import torch

from ..ops import kernels
from ..parallel import collectives
from ..utils import device as devmod
from ..utils.tree import tree_clone, tree_tensors

__all__ = ["StepGraph", "graph_steps", "KERNELS", "captured"]

_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL
# the hand-written kernels a step may launch, counted in the graph by the
# handles of their device functions
KERNELS = ("fused_normal_eqs", "fused_hth", "imu_stage")
# each kernel's wrapper calls made while a StepGraph captured (they launch
# nothing then): the launches that ran are the wrappers' counts less
# these, plus the replays' (ops/kernels.device_launches)
captured = dict.fromkeys(KERNELS, 0)


def graph_steps(window: int, unroll: int) -> int:
    """Ticks per graph: the largest divisor of `window` that is at most
    `unroll`, so that a window is a whole number of replays."""
    return max(d for d in range(1, min(window, max(unroll, 1)) + 1)
               if window % d == 0)


def _static_copy(ls):
    """The state the graph reads and writes: a fresh copy of every leaf
    but the map tables, which the steady step updates in place and which
    stay the pipeline's own tensors."""
    return ls._replace(**{f: tree_clone(getattr(ls, f))
                          for f in ls._fields if f != "map"})


def _leaf_pairs(dst, src, path="ls"):
    """(dst, src) tensor leaves of two state trees, raising where their
    structure, shapes or dtypes differ."""
    if isinstance(dst, torch.Tensor) or isinstance(src, torch.Tensor):
        if not (isinstance(dst, torch.Tensor) and isinstance(src, torch.Tensor)
                and dst.shape == src.shape and dst.dtype == src.dtype
                and dst.device == src.device):
            raise ValueError(
                f"state replacement at {path}: the graph holds "
                f"{_describe(dst)}, the new state {_describe(src)}")
        return [(dst, src)]
    if isinstance(dst, tuple) and isinstance(src, tuple):
        if len(dst) != len(src):
            raise ValueError(f"state replacement at {path}: structure differs")
        names = getattr(dst, "_fields", range(len(dst)))
        return [p for n, d, s in zip(names, dst, src)
                for p in _leaf_pairs(d, s, f"{path}.{n}")]
    if dst is None and src is None:
        return []
    raise ValueError(f"state replacement at {path}: the graph holds "
                     f"{_describe(dst)}, the new state {_describe(src)}")


def _describe(a) -> str:
    if isinstance(a, torch.Tensor):
        return f"{tuple(a.shape)} {a.dtype} on {a.device}"
    return repr(a)


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
               5: "empty", 6: "wait_event", 7: "event_record",
               8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
               11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def _kernel_name(cuda, p: _KernelNodeParams) -> str:
    """The device function name of a kernel node (its CUfunction's, or
    its CUkernel's when the node holds no function)."""
    name = ctypes.c_char_p()
    if p.func:
        err = cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func))
    else:
        err = cuda.cuKernelGetName(ctypes.byref(name),
                                   ctypes.c_void_p(p.kern))
    if err != 0:
        raise RuntimeError(f"cuFuncGetName / cuKernelGetName failed ({err})")
    return name.value.decode()


def _graph_nodes(cuda, g: int) -> list[int]:
    """The nodes of one CUgraph (cuGraphGetNodes)."""
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(ctypes.c_void_p(g), None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(ctypes.c_void_p(g), nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    return list(nodes)


def _node_counts(graph: torch.cuda.CUDAGraph, bodies=()) -> dict:
    """Nodes of the captured graph through the CUDA API of libcuda (the
    graph must have been made with keep_graph=True), its conditional
    nodes' bodies (`bodies`, the body graphs its capture opened,
    utils.device.bodies) included: all nodes, by type, kernel nodes,
    conditional nodes (`conditional`), the nodes inside bodies
    (`body_nodes`), K1's, K2's and the IMU stage's kernel nodes
    (`fused_normal_eqs`, `fused_hth`, `imu_stage`: those whose function or
    kernel handle is the kernel's),
    NCCL's (`nccl`: kernel nodes whose function name starts with "nccl",
    the collectives a mesh step captured; NCCL may also add memcpy nodes,
    counted under their type) and the step trace's (`trace`: the stamp
    and readout kernels of csrc/trace_stamp.cu, none unless traced)."""
    handles = {k: getattr(kernels, f"{k}_handles")() for k in KERNELS}
    cuda = ctypes.CDLL("libcuda.so.1")
    top = _graph_nodes(cuda, graph.raw_cuda_graph())
    inner = [n for b in bodies for n in _graph_nodes(cuda, b)]
    n_nccl = n_trace = 0
    n_k = dict.fromkeys(KERNELS, 0)
    by_type: dict[str, int] = {}
    for node in top + inner:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                   ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        t = _NODE_TYPES.get(kind.value, str(kind.value))
        by_type[t] = by_type.get(t, 0) + 1
        if kind.value != _KERNEL_NODE:
            continue
        p = _KernelNodeParams()
        if cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                              ctypes.byref(p)) != 0:
            raise RuntimeError("cuGraphKernelNodeGetParams failed")
        mine = [k for k, h in handles.items() if {p.func, p.kern} & h]
        if mine:
            n_k[mine[0]] += 1
            continue
        name = _kernel_name(cuda, p)
        if name.startswith("nccl"):
            n_nccl += 1
        elif "trace_stamp" in name or "trace_readout" in name:
            n_trace += 1
    if by_type.get("conditional", 0) != len(bodies):
        raise RuntimeError(f"{by_type.get('conditional', 0)} conditional "
                           f"nodes for {len(bodies)} bodies captured")
    return {"nodes": len(top) + len(inner),
            "kernel_nodes": by_type.get("kernel", 0),
            "conditional": by_type.get("conditional", 0),
            "body_nodes": len(inner), **n_k, "nccl": n_nccl,
            "trace": n_trace, "by_type": by_type}


class StepGraph:
    """`steps` ticks of a sync-free step captured as one CUDA graph.

    wstep(ls, w, acc_norm) -> (ls, infos (steps, 32)) runs `steps` scans
    (lio._window_fn of the tick); view(buf) turns a (steps, R) packed
    input buffer into the stacked inputs (WindowInputs or
    QuantWindowInputs of views) it reads.  After `warm_up_and_capture`,
    `replay(rows)` runs the ticks on the next `steps` packed rows and
    returns the static info rows; the state lives in `ls`.  `replays`
    counts the graph launches.
    """

    def __init__(self, wstep, view, steps: int, acc_norm: torch.Tensor):
        self.wstep, self.view = wstep, view
        self.steps = steps
        self.acc_norm = acc_norm
        self.stream = torch.cuda.Stream(device=acc_norm.device)
        self.graph = None
        self.body_pool = None  # torch.cuda.MemPool of the IF node bodies
        self.ls = None
        self.static_in = None
        self.static_info = None
        self.capture_s = None
        # {"nodes", "kernel_nodes", "conditional", "body_nodes",
        #  "fused_normal_eqs", "fused_hth", "imu_stage", ...}, bodies
        #  included
        self.nodes = None
        self.captured_launches = None  # hand-written kernel launches
        self.captured_collectives = None  # mesh collectives at capture
        self.replays = 0

    def _run(self, ls, rows):
        return self.wstep(ls, self.view(rows), self.acc_norm)

    def warm_up_and_capture(self, ls, rows: torch.Tensor):
        """Run the ticks of `rows` (real scans) eagerly on the capture
        stream, then capture the graph from the state they leave.
        Returns (ls, infos (steps, 32)) of the eager ticks."""
        cur = torch.cuda.current_stream()
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            ls, infos = self._run(ls, rows)
            self.ls = _static_copy(ls)
            self.static_in = torch.empty_like(rows)
            self.static_info = torch.empty_like(infos)
        cur.wait_stream(self.stream)
        torch.cuda.synchronize()
        for k in KERNELS:  # the device counters exist before the capture
            kernels.device_counter(k, self.acc_norm.device)
        devmod.bodies.clear()
        # the conditional bodies' memory: a pool of the graph's own, kept
        # as long as the graph
        self.body_pool = torch.cuda.MemPool()
        before = {k: getattr(kernels, k).launches for k in KERNELS}
        coll0 = dict(collectives.calls)
        t0 = time.perf_counter()
        # keep the cudaGraph_t after instantiation, to count its nodes
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # a dead graph that the cyclic collector frees mid-capture (its
        # destructor is not allowed while a stream captures) would
        # invalidate this capture: collect first, then hold the collector
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with devmod.step_capture(self.body_pool,
                                            self.acc_norm.device), \
                    torch.cuda.graph(graph, stream=self.stream,
                                     capture_error_mode="thread_local"):
                out, infos_g = self._run(self.ls, self.static_in)
                self.static_info.copy_(infos_g)
                for dst, src in zip(tree_tensors(self.ls), tree_tensors(out)):
                    if dst is not src:
                        dst.copy_(src)
        finally:
            if gc_on:
                gc.enable()
        graph.instantiate()
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.captured_launches = {k: getattr(kernels, k).launches - v
                                  for k, v in before.items()}
        self.captured_collectives = {k: collectives.calls[k] - v
                                     for k, v in coll0.items()}
        self.graph = graph
        self.nodes = _node_counts(graph, devmod.bodies)
        devmod.bodies.clear()
        for k, v in self.captured_launches.items():
            captured[k] += v
        return self.ls, infos

    def load_state(self, ls) -> None:
        """Copy every tensor leaf of the state `ls` into the graph's own
        (the static leaves and the map tables the kernels read by
        address) on the current stream, where the next replay runs.
        Shapes are fixed by the configuration; a mismatch raises.  Leaves
        that already are the graph's tensors are left alone."""
        pairs = _leaf_pairs(self.ls, ls)
        with torch.no_grad():
            for dst, src in pairs:
                if dst is not src:
                    dst.copy_(src)

    def replay(self, rows: torch.Tensor) -> torch.Tensor:
        """The ticks of `rows` ((steps, R) packed, on the device or in
        pinned host memory): one copy into the static input (a
        non-blocking host-to-device copy from pinned memory), one graph
        launch.  Returns the static (steps, 32) info rows (overwritten by
        the next replay)."""
        self.static_in.copy_(rows, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return self.static_info
