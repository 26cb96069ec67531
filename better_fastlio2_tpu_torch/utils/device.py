"""Device selection and the count of device->host synchronisations.

Every place where the port reads a device value on the host (a branch the
JAX reference took with lax.cond / while_loop inside one program) goes
through `to_host` (or, for a result copied back without waiting,
`readback_wait`), so a run can report how many synchronisations a scan
costs.  Both raise while the current CUDA stream is capturing a graph: a
host read inside a captured step is an error, never a silent count.
The step programs read nothing (device predication and fixed predicated
rounds), which is what lets pipeline/graphs.py capture them.

`cond` is the port's lax.cond with an identity false branch.  Outside a
capture (the CPU, eager ticks on the card) and in a mesh step it is a
device select, both branches run; inside the capture of a non-mesh step
it is a CUDA-graph conditional (IF) node, so that a replay runs the true
branch only when the predicate holds on the device, as the reference's
compiled program does.  The form follows from the mode alone.  The node
is built through the CUDA driver API (`if_node`): torch 2.11 has no
binding for conditional nodes.  While the step is traced (utils/trace.py)
both forms count the bodies taken under the node's name: the IF node's
condition kernel adds its condition, the select form its predicate.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import trace
from .tree import tree_clone, tree_copy_, tree_where

__all__ = ["resolve_device", "to_host", "nonzero_static",
           "host_syncs", "HostReadInCapture", "Readback", "readback_async",
           "readback_wait", "cond", "conditional", "if_node", "open_nodes",
           "bodies", "step_capture", "in_step_capture", "node_epoch"]


class HostReadInCapture(RuntimeError):
    """A device->host read was asked for while a CUDA graph was being
    captured (the read would end the capture)."""


class _SyncCounter(threading.local):
    """Integer count of the device->host reads made through to_host, one
    count per thread (the SLAM back end's worker threads keep their own,
    so the front end's count is the feed thread's alone)."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0


host_syncs = _SyncCounter()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when no GPU is present and none was named — the
    port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is absent")
    return dev


def _refuse_in_capture(what: str) -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise HostReadInCapture(
            f"{what}: a device->host read inside a CUDA graph capture; the "
            "captured step must be free of host reads")


def to_host(t: torch.Tensor):
    """Read a tensor on the host as a Python scalar or (nested) list,
    counting one synchronisation.  Raises HostReadInCapture under graph
    capture."""
    _refuse_in_capture("to_host")
    host_syncs.count += 1
    return t.item() if t.numel() == 1 and t.dim() == 0 else t.tolist()


class Readback(NamedTuple):
    """A device->host copy in flight: the host tensor (pinned) and the
    CUDA event recorded after the copy (None on the CPU)."""

    host: torch.Tensor
    event: object


def readback_async(t: torch.Tensor) -> Readback:
    """Start reading `t` back without waiting: on CUDA a non-blocking copy
    into fresh pinned host memory and an event after it on the current
    stream; a CPU tensor is its own readback."""
    if t.device.type != "cuda":
        return Readback(t, None)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return Readback(host, event)


def readback_wait(rb: Readback) -> np.ndarray:
    """Wait for a readback_async copy (one device->host read, counted;
    raises HostReadInCapture under graph capture) and return its values."""
    _refuse_in_capture("readback_wait")
    host_syncs.count += 1
    if rb.event is not None:
        rb.event.synchronize()
    return rb.host.numpy()


def nonzero_static(mask: torch.Tensor, size: int,
                   fill_value: int) -> torch.Tensor:
    """jnp.nonzero(mask, size=size, fill_value=fill_value)[0] without a
    host read: the first `size` true indices of a 1-D mask, ascending,
    padded with fill_value, as a (size,) int64 tensor.  Each true entry's
    rank comes from a cumsum; the entries ranked below `size` scatter to
    their rank, every other lane to a sink slot that is cut off."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    dst = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), fill_value, dtype=torch.int64,
                     device=mask.device)
    out.index_put_((dst,), torch.arange(n, device=mask.device))
    return out[:size]


# the IF nodes open in the current capture, innermost last (their names),
# and the body graph (CUgraph handle) of every IF node captured since a
# capture cleared the list: pipeline/graphs.py counts their nodes
_open: list[str] = []
bodies: list[int] = []
_pools: list = []  # the body memory pool of each step_capture
_side: dict = {}  # (device index, depth) -> the stream bodies capture on
# (made once in the process, never destroyed)
_MAX_DEPTH = 4
_cu = None
_set_cond = None
_epoch = 0  # IF node bodies opened and closed in the process


def open_nodes() -> tuple[str, ...]:
    """The names of the IF nodes whose bodies are being captured now,
    outermost first (empty outside a body)."""
    return tuple(_open)


def node_epoch() -> int:
    """The count of IF node bodies opened and closed so far: two points
    of a capture with the same count lie in one body."""
    return _epoch


def conditional(pred, mesh=None) -> bool:
    """Whether a gate on `pred` takes the conditional-node form: inside
    the capture of a non-mesh step, with `pred` a device tensor.  A mesh
    step keeps the select form (its collectives must run on every rank
    the same number of times)."""
    return (mesh is None and isinstance(pred, torch.Tensor)
            and pred.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


class _CondParams(ctypes.Structure):
    """CUDA_CONDITIONAL_NODE_PARAMS of cuda.h."""

    _fields_ = [("handle", ctypes.c_uint64), ("type", ctypes.c_int),
                ("size", ctypes.c_uint),
                ("phGraph_out", ctypes.POINTER(ctypes.c_void_p)),
                ("ctx", ctypes.c_void_p)]


class _NodeParams(ctypes.Structure):
    """CUgraphNodeParams of cuda.h (256 bytes): the node type, then a
    232-byte union, here its conditional member."""

    _fields_ = [("type", ctypes.c_int), ("reserved0", ctypes.c_int * 3),
                ("conditional", _CondParams),
                ("pad", ctypes.c_byte * (232 - ctypes.sizeof(_CondParams))),
                ("reserved2", ctypes.c_longlong)]


_CU_GRAPH_NODE_TYPE_CONDITIONAL = 13
_CU_GRAPH_COND_TYPE_IF = 0
_CU_STREAM_SET_CAPTURE_DEPENDENCIES = 1
_CU_STREAM_CAPTURE_MODE_THREAD_LOCAL = 1
_CU_STREAM_CAPTURE_STATUS_ACTIVE = 1
_CU_STREAM_NON_BLOCKING = 1


def _driver():
    """libcuda with the signatures of the calls that build an IF node."""
    global _cu
    if _cu is None:
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        cu = ctypes.CDLL("libcuda.so.1")
        sigs = {
            "cuStreamGetCaptureInfo_v2": [vp, ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_uint64),
                                          ctypes.POINTER(vp),
                                          ctypes.POINTER(ctypes.POINTER(vp)),
                                          ctypes.POINTER(sz)],
            "cuCtxGetCurrent": [ctypes.POINTER(vp)],
            "cuGraphConditionalHandleCreate": [
                ctypes.POINTER(ctypes.c_uint64), vp, vp, ctypes.c_uint,
                ctypes.c_uint],
            "cuGraphAddNode": [ctypes.POINTER(vp), vp, ctypes.POINTER(vp),
                               sz, ctypes.POINTER(_NodeParams)],
            "cuStreamUpdateCaptureDependencies": [vp, ctypes.POINTER(vp), sz,
                                                  ctypes.c_uint],
            "cuStreamBeginCaptureToGraph": [vp, vp, vp, vp, sz, ctypes.c_int],
            "cuStreamEndCapture": [vp, ctypes.POINTER(vp)],
            "cuStreamIsCapturing": [vp, ctypes.POINTER(ctypes.c_int)],
            "cuStreamCreate": [ctypes.POINTER(vp), ctypes.c_uint],
        }
        for name, args in sigs.items():
            fn = getattr(cu, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        _cu = cu
    return _cu


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed (CUDA driver error {err})")


def _capture_info(cu, stream):
    """(graph, dependencies, count) of the capture `stream` is in."""
    status, cid = ctypes.c_int(), ctypes.c_uint64()
    graph, n = ctypes.c_void_p(), ctypes.c_size_t()
    deps = ctypes.POINTER(ctypes.c_void_p)()
    _check(cu.cuStreamGetCaptureInfo_v2(stream, ctypes.byref(status),
                                        ctypes.byref(cid),
                                        ctypes.byref(graph),
                                        ctypes.byref(deps), ctypes.byref(n)),
           "cuStreamGetCaptureInfo")
    if status.value != _CU_STREAM_CAPTURE_STATUS_ACTIVE:
        raise RuntimeError("an IF node outside an active stream capture")
    return graph, deps, n


def _set_condition():
    """The launch function of csrc/graph_conditional.cu."""
    global _set_cond
    if _set_cond is None:
        from ..ops import _build

        fn = _build.load("graph_conditional").graph_conditional_set
        fn.argtypes = [ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _set_cond = fn
    return _set_cond


def in_step_capture() -> bool:
    """Whether the current stream captures inside a step_capture: where
    the kernels count their launches on the device."""
    return bool(_pools) and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def step_capture(pool, device: torch.device):
    """Around the CUDA graph capture of a step (entered before the capture
    begins): IF nodes may open in it, their bodies capture on streams made
    here and allocate from `pool` (a torch.cuda.MemPool that the caller
    keeps alive as long as the graph), and the kernels count the launches
    it captures on the device (ops/kernels.device_counter)."""
    idx = torch.device(device).index or 0
    for depth in range(_MAX_DEPTH):
        if (idx, depth) not in _side:
            # a stream of its own, never one of torch's pooled streams
            # (torch.cuda.Stream() hands those out round-robin: a later
            # capture stream would be one of them)
            h = ctypes.c_void_p()
            with torch.cuda.device(idx):
                _check(_driver().cuStreamCreate(ctypes.byref(h),
                                                _CU_STREAM_NON_BLOCKING),
                       "cuStreamCreate")
            _side[idx, depth] = torch.cuda.ExternalStream(h.value,
                                                          device=idx)
    _set_condition()
    _pools.append(pool)
    try:
        yield
    finally:
        _pools.pop()


@contextlib.contextmanager
def if_node(pred: torch.Tensor, name: str = "cond"):
    """Capture the block as the body of a CUDA-graph IF node on `pred` (a
    () bool CUDA tensor): each replay runs the body only when `pred` holds
    then.  Through the driver API: a conditional handle in the graph the
    current stream captures into, a kernel (csrc/graph_conditional.cu)
    that sets the condition from `pred`, the IF node after it, and the
    block captured on a stream of its own (the current stream inside the
    block) into the node's body graph, allocating from the pool of the
    enclosing step_capture.  While the step is traced, the condition
    kernel also adds the condition to the trace's counter of `name`.
    Raises when the capture was not opened with step_capture, nests
    deeper than _MAX_DEPTH or the driver refuses; nothing falls back to a
    select."""
    if (pred.dtype != torch.bool or pred.dim() != 0
            or pred.device.type != "cuda"):
        raise ValueError(f"if_node {name!r}: the predicate must be a () bool "
                         f"CUDA tensor, got {tuple(pred.shape)} {pred.dtype} "
                         f"on {pred.device}")
    if not _pools:
        raise RuntimeError(f"if_node {name!r}: the capture was not opened "
                           "with utils.device.step_capture")
    depth = len(_open)
    if depth >= _MAX_DEPTH:
        raise RuntimeError(f"if_node {name!r}: IF nodes nested deeper than "
                           f"{_MAX_DEPTH}")
    cu = _driver()
    dev = pred.device
    stream = torch.cuda.current_stream(dev)
    hs = ctypes.c_void_p(stream.cuda_stream)
    graph, _, _ = _capture_info(cu, hs)
    ctx = ctypes.c_void_p()
    _check(cu.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    handle = ctypes.c_uint64()
    _check(cu.cuGraphConditionalHandleCreate(ctypes.byref(handle), graph,
                                             ctx, 0, 0),
           "cuGraphConditionalHandleCreate")
    _check(_set_condition()(handle.value, pred.data_ptr(), 0,
                            trace.counter_ptr(name) or None,
                            stream.cuda_stream), "the condition kernel")
    graph, deps, n = _capture_info(cu, hs)
    params = _NodeParams()
    params.type = _CU_GRAPH_NODE_TYPE_CONDITIONAL
    params.conditional.handle = handle.value
    params.conditional.type = _CU_GRAPH_COND_TYPE_IF
    params.conditional.size = 1
    params.conditional.ctx = ctx
    node = ctypes.c_void_p()
    _check(cu.cuGraphAddNode(ctypes.byref(node), graph, deps, n,
                             ctypes.byref(params)), "cuGraphAddNode")
    body = params.conditional.phGraph_out[0]
    _check(cu.cuStreamUpdateCaptureDependencies(
        hs, ctypes.byref(node), 1, _CU_STREAM_SET_CAPTURE_DEPENDENCIES),
        "cuStreamUpdateCaptureDependencies")
    side = _side[dev.index or 0, depth]
    hside = ctypes.c_void_p(side.cuda_stream)
    busy = ctypes.c_int()
    _check(cu.cuStreamIsCapturing(hside, ctypes.byref(busy)),
           "cuStreamIsCapturing")
    if busy.value:
        raise RuntimeError(f"if_node {name!r}: the body stream of depth "
                           f"{depth} is already capturing (open: {_open})")
    _check(cu.cuStreamBeginCaptureToGraph(
        hside, ctypes.c_void_p(body), None, None, 0,
        _CU_STREAM_CAPTURE_MODE_THREAD_LOCAL),
        f"cuStreamBeginCaptureToGraph ({name!r}, depth {depth})")
    global _epoch
    bodies.append(body)
    _open.append(name)
    _epoch += 1
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.cuda.stream(side))
            if depth == 0:
                stack.enter_context(torch.cuda.use_mem_pool(_pools[-1], dev))
            yield
    finally:
        _open.pop()
        _epoch += 1
        out = ctypes.c_void_p()
        _check(cu.cuStreamEndCapture(hside, ctypes.byref(out)),
               "cuStreamEndCapture")


def cond(pred, true_fn, operand, *, mesh=None, name: str = "cond",
         inplace: bool = False):
    """lax.cond(pred, true_fn, lambda a: a, operand) on a tree of tensors.

    A Python bool `pred` picks the branch on the host.  Otherwise, on the
    CPU, outside a capture and in a mesh step (`mesh` given), the select
    tree_where(pred, true_fn(operand), operand); inside the capture of a
    non-mesh step, an IF node: the result's tensors are made before the
    node (clones of `operand`, or with `inplace` the operand's own
    tensors, which the caller then gives up), and the body copies
    true_fn's result into them.  Both forms give the same bits, and the
    same counts of bodies taken while the step is traced."""
    if isinstance(pred, bool):
        return true_fn(operand) if pred else operand
    if not conditional(pred, mesh):
        tr = trace.active()
        if tr is None:
            return tree_where(pred, true_fn(operand), operand)
        with tr.taken(name, pred):
            taken = true_fn(operand)
        return tree_where(pred, taken, operand)
    out = operand if inplace else tree_clone(operand)
    with if_node(pred, name):
        tree_copy_(out, true_fn(operand))
    return out
