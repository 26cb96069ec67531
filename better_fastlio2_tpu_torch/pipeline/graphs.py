"""Capture and replay of the sync-free steady step as a CUDA graph.

The JAX reference runs a window of W scans as one jitted device program
(a lax.scan of the tick, pipeline/lio.py:make_window_step_fn).  On a
directly attached GPU its counterpart is a CUDA graph of the step: the
graph holds `steps` consecutive ticks, captured once and replayed W/steps
times per window, so a steady scan costs no host launches and no host
reads.  Only a step that reads nothing on the host can be captured: the
dense-moment steady program of the fused solve (lio.make_step_fn marks it
`sync_free`); utils.device.to_host raises if a read slips in.

PyTorch's idiom, as torch.cuda.graphs documents it:
* a private memory pool holds every intermediate of the captured ticks;
* static buffers: the (steps, R) packed inputs the ticks read
  (`static_in`), the (steps, 32) info rows they write (`static_info`), and
  the filter state (`ls`): the ticks start from its tensors and the last
  one's state is copied back into them with copy_, so that the replays
  chain.  The map tables the steady program touches (the dense moment
  table) are updated in place and need no copy.  A state replaced between
  windows (a map rebuild or reset, the SLAM back end's pose feedback) is
  copied into these same tensors (`load_state`);
* collectives of a mesh step (NCCL) are captured with it: the mesh's
  communicator exists before the capture (parallel.collectives.make_mesh),
  and the capture's "thread_local" error mode leaves NCCL's watchdog
  thread free to query its events;
* warm-up before capture on the capturing side stream.  The warm-up
  ticks are real scans (the first `steps` of the first steady window),
  run eagerly through the same tick; nothing is run twice and no
  throwaway tick touches the map.

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
from ..utils.tree import tree_tensors

__all__ = ["StepGraph", "graph_steps"]

_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL


def graph_steps(window: int, unroll: int) -> int:
    """Ticks per graph: the largest divisor of `window` that is at most
    `unroll`, so that a window is a whole number of replays."""
    return max(d for d in range(1, min(window, max(unroll, 1)) + 1)
               if window % d == 0)


def _static_copy(ls):
    """The state the graph reads and writes: a fresh copy of every leaf
    but the map tables, which the steady step updates in place and which
    stay the pipeline's own tensors."""
    return ls._replace(**{f: _clone_tree(getattr(ls, f))
                          for f in ls._fields if f != "map"})


def _clone_tree(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    return type(a)(*(_clone_tree(x) for x in a))


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


def _node_counts(graph: torch.cuda.CUDAGraph) -> dict:
    """Nodes of the captured graph through the CUDA API of libcuda (the
    graph must have been made with keep_graph=True): all nodes, by type,
    kernel nodes, K1's kernel nodes (`fused_normal_eqs`: those whose
    function or kernel handle is K1's) and NCCL's (`nccl`: kernel nodes
    whose function name starts with "nccl", the collectives a mesh step
    captured; NCCL may also add memcpy nodes, counted under their type)."""
    k1 = kernels.fused_normal_eqs_handles()
    cuda = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    n_k1 = n_nccl = 0
    by_type: dict[str, int] = {}
    for node in nodes:
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
        if {p.func, p.kern} & k1:
            n_k1 += 1
        elif _kernel_name(cuda, p).startswith("nccl"):
            n_nccl += 1
    return {"nodes": n.value, "kernel_nodes": by_type.get("kernel", 0),
            "fused_normal_eqs": n_k1, "nccl": n_nccl, "by_type": by_type}


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
        self.ls = None
        self.static_in = None
        self.static_info = None
        self.capture_s = None
        # {"nodes", "kernel_nodes", "fused_normal_eqs"} of the graph
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
        before = {k: getattr(kernels, k).launches
                  for k in ("fused_normal_eqs", "fused_hth")}
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
            with torch.cuda.graph(graph, stream=self.stream,
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
        self.nodes = _node_counts(graph)
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
        """The ticks of `rows` ((steps, R) packed, on the device): one
        device-to-device copy into the static input, one graph launch.
        Returns the static (steps, 32) info rows (overwritten by the next
        replay)."""
        self.static_in.copy_(rows)
        self.graph.replay()
        self.replays += 1
        return self.static_info
