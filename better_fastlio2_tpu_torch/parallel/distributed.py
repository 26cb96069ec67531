"""Asynchronous back-end execution.

Port of the `AsyncBackend` of better_fastlio2_tpu/parallel/distributed.py
(the reference's 1 Hz loop-closure std::thread, laserMapping.cpp:2216,
SURVEY.md §2.6 P4): pose-graph optimization runs without blocking the
front end.  JAX's asynchronous dispatch made the optimizer's call return
at once; a torch CPU op blocks its caller, so here one worker thread runs
the submitted snapshot (one job in flight) and the feed thread polls.
`init_distributed` comes with the multi-device work (ROADMAP item 14).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..backend.posegraph import optimize

__all__ = ["AsyncBackend"]


class AsyncBackend:
    """Non-blocking pose-graph optimization on a designated device.

        ab = AsyncBackend(device="cpu")
        ab.submit(graph, tag=n)   # after adding a loop factor
        ...
        res = ab.poll()           # each scan; None until ready
        if res is not None:
            poses, tag = res      # apply the correction

    `submit` moves the graph snapshot to the back end's device and hands
    it to a worker thread; the front end keeps dispatching its own work.
    """

    def __init__(self, device="cpu", iters: int = 6, cg_iters: int = 50):
        self.device = torch.device(device)
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
