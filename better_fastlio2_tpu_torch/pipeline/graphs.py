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
  table) are updated in place and need no copy;
* warm-up before capture on the capturing side stream.  The warm-up
  ticks are real scans (the first `steps` of the first steady window),
  run eagerly through the same tick; nothing is run twice and no
  throwaway tick touches the map.

Capture failures raise; nothing falls back to eager execution.  The
cyclic garbage collector is held during capture: freeing another, dead
graph there would invalidate the capture.
"""

from __future__ import annotations

import ctypes
import gc
import time

import torch

from ..ops import kernels
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


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def _node_counts(graph: torch.cuda.CUDAGraph) -> dict:
    """Nodes of the captured graph through the CUDA API of libcuda (the
    graph must have been made with keep_graph=True): all nodes, kernel
    nodes, and K1's kernel nodes (`fused_normal_eqs`: those whose
    function or kernel handle is K1's)."""
    k1 = kernels.fused_normal_eqs_handles()
    cuda = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    n_kernel = n_k1 = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                   ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value != _KERNEL_NODE:
            continue
        n_kernel += 1
        p = _KernelNodeParams()
        if cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                              ctypes.byref(p)) != 0:
            raise RuntimeError("cuGraphKernelNodeGetParams failed")
        n_k1 += bool({p.func, p.kern} & k1)
    return {"nodes": n.value, "kernel_nodes": n_kernel,
            "fused_normal_eqs": n_k1}


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
            with torch.cuda.graph(graph, stream=self.stream):
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
        self.graph = graph
        self.nodes = _node_counts(graph)
        return self.ls, infos

    def replay(self, rows: torch.Tensor) -> torch.Tensor:
        """The ticks of `rows` ((steps, R) packed, on the device): one
        device-to-device copy into the static input, one graph launch.
        Returns the static (steps, 32) info rows (overwritten by the next
        replay)."""
        self.static_in.copy_(rows)
        self.graph.replay()
        self.replays += 1
        return self.static_info
