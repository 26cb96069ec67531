"""Scan Context descriptors as dense tensor ops.

Port of better_fastlio2_tpu/ops/scancontext.py (SCManager, reference:
include/sc-relo/Scancontext.{h,cpp}).  The descriptor is a 20x60 polar
max-height image (makeScancontext, Scancontext.cpp:195-251); retrieval is
a brute-force ring-key L2 against the whole database plus top-k, and the
column-shift alignment scores all 60 rotations at once.

Translation notes:
* the descriptor's scatter-max (`.at[flat].max(mode="drop")`) is
  `scatter_reduce_(..., "amax")` into an R*S + 1 buffer whose last row is
  the sink of the dropped points; a max is order-free, so the descriptor
  is the same on every run and device;
* the bin products follow the reference as compiled (a constant folded
  into one multiply), so points on a bin boundary land in its bin;
* `jnp.argmin` and `torch.argmin` both return the first minimum, which
  keeps the shift of tied distances;
* `lax.top_k` ties go to the lower index: a stable descending sort.

Parameters match Scancontext.h:84-102.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "SCParams",
    "make_descriptor",
    "ring_key",
    "sector_key",
    "sc_distance",
    "sc_distance_batch",
    "SCDatabase",
    "make_database",
    "add_descriptor",
    "detect_loop",
]


class SCParams(NamedTuple):
    num_ring: int = 20  # PC_NUM_RING
    num_sector: int = 60  # PC_NUM_SECTOR
    max_radius: float = 80.0  # PC_MAX_RADIUS
    lidar_height: float = 1.5  # LIDAR_HEIGHT
    dist_thresh: float = 0.3  # SC_DIST_THRES
    num_exclude_recent: int = 30  # NUM_EXCLUDE_RECENT
    num_candidates: int = 3  # NUM_CANDIDATES_FROM_TREE


_NO_POINT = -1000.0


def make_descriptor(pts: torch.Tensor, valid: torch.Tensor,
                    params: SCParams = SCParams()) -> torch.Tensor:
    """Polar BEV max-height descriptor (makeScancontext): bin (ring,
    sector) takes max(z + lidar_height) of its points within max_radius;
    empty bins are 0.  Bin indexing matches the reference's ceil()-based
    1..N clamp (Scancontext.cpp:231-233)."""
    R, S = params.num_ring, params.num_sector
    x, y = pts[:, 0], pts[:, 1]
    z = pts[:, 2] + params.lidar_height
    rng = torch.sqrt(x * x + y * y)
    # xy2theta: atan2 in degrees, mapped to [0, 360)
    theta = torch.atan2(y, x) * (180.0 / math.pi)
    theta = torch.where(theta < 0, theta + 360.0, theta)
    # the reference's `/ max_radius * R` and `/ 360.0 * S` as XLA compiles
    # them: one product with the folded constant (1/c) * n, whose rounding
    # decides the bin of a point on a sector boundary
    ring = torch.clamp(torch.ceil(rng * ((1.0 / params.max_radius) * R)),
                       1, R) - 1
    sect = torch.clamp(torch.ceil(theta * ((1.0 / 360.0) * S)), 1, S) - 1
    ok = valid & (rng <= params.max_radius)
    flat = torch.where(ok, (ring * S + sect).to(torch.int64), R * S)
    desc = torch.full((R * S + 1,), _NO_POINT, dtype=pts.dtype,
                      device=pts.device)
    desc.scatter_reduce_(0, flat, torch.where(ok, z, _NO_POINT), "amax",
                         include_self=True)
    desc = desc[:R * S]
    desc = torch.where(desc == _NO_POINT, 0.0, desc)
    return desc.reshape(R, S)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant row means (makeRingkeyFromScancontext)."""
    return torch.mean(desc, dim=-1)


def sector_key(desc: torch.Tensor) -> torch.Tensor:
    """Column means (makeSectorkeyFromScancontext)."""
    return torch.mean(desc, dim=-2)


def _all_shift_cosine(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(..., S) column-wise mean cosine distance of d1 (R, S) against every
    circular shift of d2 (..., R, S): index s = distDirectSC(d1,
    circshift(d2, s)).  Empty columns (zero norm in either operand) are
    left out of the mean (Scancontext.cpp:85-99)."""
    S = d1.shape[-1]
    dev = d1.device
    shifts = torch.arange(S, device=dev)
    src = (shifts[None, :] - shifts[:, None]) % S  # (shift, col)
    d2_shift = d2[..., :, src]  # (..., R, shift, col)
    dots = torch.einsum("rc,...rsc->...sc", d1, d2_shift)
    n1 = torch.linalg.vector_norm(d1, dim=-2)  # (S,)
    n2 = torch.linalg.vector_norm(d2, dim=-2)  # (..., S)
    n2s = n2[..., src]  # (..., shift, col)
    eff = (n1 > 0) & (n2s > 0)
    denom = torch.clamp(n1 * n2s, min=1e-12)
    sims = torch.where(eff, dots / denom, 0.0)
    cnt = torch.clamp(torch.sum(eff, dim=-1), min=1)
    return 1.0 - torch.sum(sims, dim=-1) / cnt


def sc_distance(d1: torch.Tensor, d2: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(min distance, argmin shift) over all rotations
    (distanceBtnScanContext with a full-shift search)."""
    d = _all_shift_cosine(d1, d2)
    s = torch.argmin(d)
    return d[s], s


def sc_distance_batch(d1: torch.Tensor, d2s: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched sc_distance of one query against (K, R, S) candidates."""
    d = _all_shift_cosine(d1, d2s)  # (K, S)
    s = torch.argmin(d, dim=-1)
    return torch.gather(d, -1, s[:, None])[:, 0], s


class SCDatabase(NamedTuple):
    """Fixed-capacity descriptor store (polarcontexts_ analog)."""

    descs: torch.Tensor  # (K, R, S)
    rkeys: torch.Tensor  # (K, R)
    count: torch.Tensor  # () int32


def make_database(capacity: int, params: SCParams = SCParams(),
                  dtype=torch.float32, device=None) -> SCDatabase:
    return SCDatabase(
        descs=torch.zeros((capacity, params.num_ring, params.num_sector),
                          dtype=dtype, device=device),
        rkeys=torch.zeros((capacity, params.num_ring), dtype=dtype,
                          device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def add_descriptor(db: SCDatabase, desc: torch.Tensor) -> SCDatabase:
    """Append (saveScancontextAndKeys analog); silently drops past
    capacity (the write lands in a sink row that is cut off)."""
    K = db.descs.shape[0]
    i = db.count.to(torch.int64).reshape(1)

    def put(a, row):
        out = torch.cat([a, a[:1]])
        out.index_put_((i,), row[None].to(a.dtype))
        return out[:K]

    return SCDatabase(descs=put(db.descs, desc),
                      rkeys=put(db.rkeys, ring_key(desc)),
                      count=torch.clamp(db.count + 1, max=K))


def detect_loop(db: SCDatabase, desc: torch.Tensor,
                params: SCParams = SCParams()
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global loop retrieval (detectClosestKeyframeID,
    Scancontext.cpp:402-470): the `num_candidates` nearest ring keys among
    entries older than `num_exclude_recent`, the winner the least full SC
    distance.  Returns (loop_idx (int32, -1 if none), distance, shift);
    the caller applies the SC_DIST_THRES gate."""
    K = db.descs.shape[0]
    q = ring_key(desc)
    d2 = torch.sum((db.rkeys - q[None, :]) ** 2, dim=-1)
    searchable = (torch.arange(K, device=desc.device)
                  < (db.count - params.num_exclude_recent))
    d2 = torch.where(searchable, d2, math.inf)
    k = min(params.num_candidates, K)
    cand = torch.sort(-d2, descending=True, stable=True).indices[:k]
    cand_ok = searchable[cand]
    dists, shifts = sc_distance_batch(desc, db.descs[cand])
    dists = torch.where(cand_ok, dists, math.inf)
    best = torch.argmin(dists)
    have = torch.isfinite(dists[best])
    return (torch.where(have, cand[best], -1).to(torch.int32), dists[best],
            shifts[best])
