"""Multi-process bootstrap and asynchronous back-end execution.

Port of better_fastlio2_tpu/parallel/distributed.py (SURVEY.md §2.6):

* `init_distributed` is the counterpart of the reference's
  jax.distributed bootstrap (P5/P6, the ROS TCPROS transport between
  nodes): each process joins one torch.distributed process group over a
  TCP coordinator, NCCL on CUDA and gloo on the CPU; parallel/sharded.py's
  collectives then run over it.
* `AsyncBackend` (P4, the reference's 1 Hz loop-closure std::thread,
  laserMapping.cpp:2216): pose-graph optimization runs without blocking
  the front end.  JAX's asynchronous dispatch made the optimizer's call
  return at once; a torch CPU op blocks its caller, so here one worker
  thread runs the submitted snapshot (one job in flight) and the feed
  thread polls.
"""

from __future__ import annotations

import datetime
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..backend.posegraph import optimize
from ..utils.device import resolve_device

__all__ = ["init_distributed", "AsyncBackend", "DEFAULT_TIMEOUT_S"]

DEFAULT_TIMEOUT_S = 300.0  # a rank that never joins fails the group


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     backend: str | None = None) -> bool:
    """Join this process to the default torch.distributed process group
    (no-op returning False when `coordinator` is None, as in the
    reference).

    coordinator "host:port" is rank 0's TCP store (`tcp://host:port`);
    num_processes the world size, process_id this process's rank.  The
    backend follows the device the ranks compute on (resolve_device:
    cuda unless named): NCCL for CUDA, bound to this process's current
    card so the communicator is made at once, gloo for the CPU;
    backend="gloo" on CUDA lets several ranks share one card (NCCL takes
    a card per rank; parallel/collectives.py stages gloo's CUDA tensors
    through the host).  Every collective of the group fails after
    `timeout_s` instead of hanging.  Returns True once joined."""
    if coordinator is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs num_processes and "
                         "process_id with a coordinator")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        torch.cuda.set_device(idx)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA, not {dev}")
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this torch build")
        kw = {"backend": "nccl", "device_id": torch.device("cuda", idx)}
    elif backend == "gloo":
        kw = {"backend": "gloo"}
    else:
        raise ValueError(f"unknown backend {backend!r}")
    dist.init_process_group(
        init_method=f"tcp://{coordinator}", world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


class AsyncBackend:
    """Non-blocking pose-graph optimization on a designated device (cuda
    unless `device` names another; raises with no GPU and no device).

        ab = AsyncBackend()
        ab.submit(graph, tag=n)   # after adding a loop factor
        ...
        res = ab.poll()           # each scan; None until ready
        if res is not None:
            poses, tag = res      # apply the correction

    `submit` moves the graph snapshot to the back end's device and hands
    it to a worker thread; the front end keeps dispatching its own work.
    """

    def __init__(self, device=None, iters: int = 6, cg_iters: int = 50):
        self.device = resolve_device(device)
        self.iters = iters
        self.cg_iters = cg_iters
        self._thread: threading.Thread | None = None
        self._out = None
        self._err: Exception | None = None
        self._tag = None

    @property
    def busy(self) -> bool:
        return self._thread is not None

    def _run(self, graph) -> None:
        try:
            with torch.no_grad():
                poses = optimize(graph, iters=self.iters,
                                 cg_iters=self.cg_iters).poses
            self._out = poses.cpu().numpy()
        except Exception as e:  # handed to the consumer, raised there
            self._err = e

    def submit(self, graph, tag=None) -> bool:
        """Start optimizing a graph snapshot; returns False if an
        optimization is already in flight (the reference's thread also
        processes one loop batch at a time).  `tag` (e.g. the keyframe
        count at snapshot time) comes back with the result, so the
        consumer can apply a stale result correctly."""
        if self._thread is not None:
            return False
        g = type(graph)(*(t.to(self.device) for t in graph))
        self._out, self._err, self._tag = None, None, tag
        self._thread = threading.Thread(target=self._run, args=(g,),
                                        daemon=True)
        self._thread.start()
        return True

    def _take(self):
        self._thread.join()
        self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        out, tag = self._out, self._tag
        self._out = self._tag = None
        return np.asarray(out), tag

    def poll(self):
        """(optimized poses (numpy), tag) once ready, else None."""
        if self._thread is None or self._thread.is_alive():
            return None
        return self._take()

    def wait(self):
        """Block for the in-flight optimization (flush / shutdown path);
        returns (poses, tag) or None."""
        if self._thread is None:
            return None
        return self._take()
