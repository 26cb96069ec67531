"""Device selection and the count of device->host synchronisations.

Every place where the port reads a device value on the host (a branch the
JAX reference took with lax.cond / while_loop inside one program) goes
through `to_host`, so a run can report how many synchronisations a scan
costs.  Removing them (device predication, CUDA graphs) is later work.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "to_host", "nonzero", "nonzero_static",
           "host_syncs"]


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
