"""Device selection and the count of device->host synchronisations.

Every place where the port reads a device value on the host (a branch the
JAX reference took with lax.cond / while_loop inside one program) goes
through `to_host`, so a run can report how many synchronisations a scan
costs.  Removing them (device predication, CUDA graphs) is later work.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "to_host", "nonzero", "host_syncs"]


class _SyncCounter:
    """Plain integer count of device->host reads made through to_host."""

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


def to_host(t: torch.Tensor):
    """Read a tensor on the host as a Python scalar or (nested) list,
    counting one synchronisation."""
    host_syncs.count += 1
    return t.item() if t.numel() == 1 and t.dim() == 0 else t.tolist()


def nonzero(mask: torch.Tensor) -> torch.Tensor:
    """Ascending indices of the true entries of a 1-D mask; the result's
    size is data-dependent, so this counts one synchronisation."""
    host_syncs.count += 1
    return torch.nonzero(mask).squeeze(1)
