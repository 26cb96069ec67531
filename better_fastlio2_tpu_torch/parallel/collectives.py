"""The "mesh" of the port and its collectives over torch.distributed.

The JAX package runs its multi-device programs under `jax.shard_map` over
a `jax.sharding.Mesh`, with `lax.psum`, `lax.all_gather`,
`lax.axis_index` and `lax.ppermute` inside.  Here every rank is one
process holding its own tensors, and the mesh is the process group: a
`Mesh` holds the group, this process's rank, the group size, the axis
name and the device the rank computes on.  The four collectives are thin
calls into torch.distributed:

    psum(t, mesh)              all_reduce (SUM) of a copy of t
    all_gather(t, mesh)        the ranks' t concatenated on axis 0 in rank
                               order (the reference's device order)
    axis_index(mesh)           this rank (a host int)
    ppermute(t, mesh, perm)    t sent along the (src, dst) pairs of perm
                               with one batch_isend_irecv; zeros where
                               nothing arrives

Rules every caller keeps:
* A collective runs the same number of times, in the same order, on every
  rank: no collective sits behind a rank-dependent branch or inside a
  rank-local host loop, and every host read that steers control flow
  reads a value that is the same on every rank (a psum'd count, or
  replicated arithmetic).  A rank that skips one deadlocks the group
  until the group's timeout.
* At size 1 psum and all_gather still run their collective (the
  reference's one-device mesh runs "the production program plus identity
  collectives"): the one-rank NCCL run prices what the collectives cost
  inside a captured CUDA graph.  A (r, r) pair of ppermute is a local
  copy (point-to-point to oneself is not defined).
* NCCL collectives are captured into CUDA graphs (`Mesh.capturable`);
  make_mesh runs one eager all-reduce so the communicator exists before
  any capture.  gloo moves CUDA tensors through host memory, so here a
  gloo collective on a CUDA tensor stages through a host copy, which
  synchronises the device: a gloo mesh on CUDA runs its ticks eagerly.

`calls` counts the collectives called, by kind (chip_smoke.py reads the
count of a captured tick).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["Mesh", "make_mesh", "psum", "all_gather", "axis_index",
           "ppermute", "calls"]

calls = {"psum": 0, "all_gather": 0, "ppermute": 0}

# all_gather_single took all_gather_into_tensor's place (same signature)
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


@dataclass(frozen=True)
class Mesh:
    """One mesh axis over a torch.distributed process group."""

    group: object  # the ProcessGroup
    rank: int  # this process's rank in the group
    size: int  # ranks in the group
    axis: str  # the reference's axis name ("dp")
    device: torch.device  # where this rank's tensors live
    backend: str  # "nccl" or "gloo"

    @property
    def capturable(self) -> bool:
        """Whether the collectives can be captured in a CUDA graph: NCCL's
        can; gloo's stage through the host."""
        return self.backend == "nccl"


def make_mesh(group=None, axis: str = "dp", device=None) -> Mesh:
    """The Mesh of `group` (default: the default process group, which
    parallel.distributed.init_distributed creates) on `device` (cuda
    unless named).  Runs one eager all-reduce, so the communicator exists
    before a CUDA graph captures a collective."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.init_distributed first")
    g = group if group is not None else dist.group.WORLD
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:  # as its tensors report it
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend(g))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group computes on CUDA, not {dev}")
    mesh = Mesh(group=g, rank=dist.get_rank(g), size=dist.get_world_size(g),
                axis=axis, device=dev, backend=backend)
    psum(torch.zeros(1, device=dev), mesh)
    return mesh


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """lax.psum: the sum of `t` over the ranks (a new tensor)."""
    calls["psum"] += 1
    if _staged(mesh, t):
        h = t.detach().to("cpu", copy=True)
        dist.all_reduce(h, group=mesh.group)
        return h.to(t.device)
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.group)
    return out


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """lax.all_gather(...).reshape(-1, ...): the ranks' `t` (a scalar
    counts as one row) concatenated on axis 0 in rank order.  The bytes
    travel as uint8, so every dtype gathers the same way on every
    backend (gloo has no int16)."""
    calls["all_gather"] += 1
    src = t.reshape((1,) + tuple(t.shape)) if t.dim() == 0 else t
    src = src.contiguous()
    rows = tuple(src.shape)
    byt = src.reshape(-1).view(torch.uint8)
    if _staged(mesh, t):
        byt = byt.cpu()
    out = byt.new_empty((mesh.size * byt.shape[0],))
    _gather_into(out, byt, group=mesh.group)
    out = out.to(t.device).view(t.dtype)
    return out.reshape((mesh.size * rows[0],) + rows[1:])


def axis_index(mesh: Mesh) -> int:
    """lax.axis_index: this rank."""
    return mesh.rank


def ppermute(t: torch.Tensor, mesh: Mesh,
             perm: list[tuple[int, int]]) -> torch.Tensor:
    """lax.ppermute: `t` sent from src to dst for every (src, dst) pair of
    `perm` (each rank at most once as a source and once as a
    destination), all sends and receives in one batch_isend_irecv; a rank
    that receives nothing gets zeros.  (r, r) is a local copy."""
    calls["ppermute"] += 1
    src = t.contiguous()
    stage = _staged(mesh, t)
    if stage:
        src = src.cpu()
    is_bool = src.dtype == torch.bool
    if is_bool:  # sent as bytes
        src = src.view(torch.uint8)
    out = torch.zeros_like(src)
    ops = []
    me = mesh.rank
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src,
                                  dist.get_global_rank(mesh.group, d),
                                  group=mesh.group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(mesh.group, s),
                                  group=mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if is_bool:
        out = out.view(torch.bool)
    return out.to(t.device) if stage else out
