"""Device selection and the count of device->host synchronisations.

Every place where the port reads a device value on the host (a branch the
JAX reference took with lax.cond / while_loop inside one program) goes
through `to_host` (or, for a result copied back without waiting,
`readback_wait`), so a run can report how many synchronisations a scan
costs.  Both raise while the current CUDA stream is capturing a graph: a
host read inside a captured step is an error, never a silent count.
The step programs read nothing (device predication and fixed predicated
rounds), which is what lets pipeline/graphs.py capture them.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["resolve_device", "to_host", "nonzero_static",
           "host_syncs", "HostReadInCapture", "Readback", "readback_async",
           "readback_wait"]


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
