"""Voxel-hash map on the device — the replacement for ikd-Tree.

Port of better_fastlio2_tpu/map/voxel_hash.py: a fixed-capacity
open-addressing table of voxel buckets,

    key:    (C,)      int32  packed voxel id + liveness
    count:  (C,)      int32  points stored in the slot (<= B)
    points: (C, B, 3) float  sentinel-filled (1e9)
    dense:  (Gx, Gy, Gz, 2) int32 or None — torus lookup index of
            (packed key, slot) rows, verified against the key at lookup

with the same slot placement as the reference (bit-exact hash), the same
deterministic scatter-min claim protocol, 5-NN over the voxel
neighbourhood and the moving-box crop.

Translation notes:
* `_hash` runs its uint32 wrap-around multiplies and logical shifts in
  int64 masked to 32 bits (torch has no full uint32 arithmetic).
* `mode="drop"` scatters become scatters whose inactive lanes add zero
  (integer adds) or write the value the target ends with anyway.
* Where the reference sets rows through possibly-duplicate indices
  (the bucket append and the dense-index refresh: two downsampled
  centroids of one batch can fall into one world voxel after the
  body->world transform), XLA applies the updates in order, so the last
  one wins.  CUDA's index_put_ picks an undefined winner, so these sets
  resolve the last writer explicitly (`_set_rows_last`).
* The grouped insert's `lexsort` becomes stable sorts from the least
  significant key up, and its `associative_scan(maximum)` group head a
  `torch.cummax`.
* The claim loop and the probe loop are host loops: one device->host read
  per round (utils.device.to_host counts them).

Only what the per-scan front end runs is here: the insert, grouped or
pre-grouped (one row per voxel — the downsample leaf equals the map
voxel), with or without the dense index, without budgets or moments.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import to_host

__all__ = ["VoxelHashMap", "make_map", "insert", "knn", "crop_outside_box",
           "num_voxels"]

_INT_MAX = 2147483647
_KEY_EMPTY = 0
_KEY_TOMB = -2147483648  # 1 << 31 (bit 30 clear => not live)
_LIVE_BIT = 1 << 30
_SENTINEL = 1e9  # "no point" coordinate value
_U32 = 0xFFFFFFFF

# multiplicative hash constants (the classic spatial-hash primes)
_P1, _P2, _P3 = 73856093, 19349669, 83492791


class VoxelHashMap(NamedTuple):
    key: torch.Tensor  # (C,) int32
    count: torch.Tensor  # (C,) int32
    points: torch.Tensor  # (C, B, 3) float
    dense: torch.Tensor | None  # (Gx, Gy, Gz, 2) int32 or None
    voxel_size: torch.Tensor  # () float

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def bucket(self) -> int:
        return self.points.shape[1]


def make_map(capacity_log2: int = 19, bucket: int = 8,
             voxel_size: float = 0.5, dtype=torch.float32, device=None,
             dense_log2: tuple[int, int, int] | None = None) -> VoxelHashMap:
    """Allocate an empty map of 2**capacity_log2 slots; dense_log2 adds
    the torus lookup index of 2**lx x 2**ly x 2**lz cells."""
    C = 1 << capacity_log2
    dense = (torch.zeros((1 << dense_log2[0], 1 << dense_log2[1],
                          1 << dense_log2[2], 2), dtype=torch.int32,
                         device=device)
             if dense_log2 is not None else None)
    return VoxelHashMap(
        key=torch.zeros(C, dtype=torch.int32, device=device),
        count=torch.zeros(C, dtype=torch.int32, device=device),
        points=torch.full((C, bucket, 3), _SENTINEL, dtype=dtype,
                          device=device),
        dense=dense,
        voxel_size=torch.tensor(voxel_size, dtype=dtype, device=device),
    )


def _dense_linear(dense_shape, ijk: torch.Tensor) -> torch.Tensor:
    """Row index into the flattened torus grid for each voxel coord."""
    Gx, Gy, Gz = dense_shape[:3]
    return (((ijk[..., 0] & (Gx - 1)) * Gy + (ijk[..., 1] & (Gy - 1))) * Gz
            + (ijk[..., 2] & (Gz - 1))).to(torch.int64)


def _dense_lookup(dense: torch.Tensor, ijk: torch.Tensor) -> torch.Tensor:
    """Slot of each voxel coord through the dense index; -1 if the row is
    absent or stale (its stored packed key differs from the query's)."""
    row = dense.reshape(-1, 2)[_dense_linear(dense.shape, ijk)]
    return torch.where(row[..., 0] == _pack(ijk), row[..., 1], -1)


def num_voxels(m: VoxelHashMap) -> torch.Tensor:
    return torch.sum(((m.key & _LIVE_BIT) != 0).to(torch.int32))


def _voxel_of(points: torch.Tensor, voxel_size) -> torch.Tensor:
    return torch.floor(points / voxel_size).to(torch.int32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for 0 <= h < 2^32 without leaving int64: split c
    into 16-bit halves so no partial product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def _hash(ijk: torch.Tensor, mask: int) -> torch.Tensor:
    """Spatial hash with the murmur3 avalanche finalizer, bit-exact with
    the reference's int32/uint32 arithmetic (int64 here, masked)."""
    i = ijk.to(torch.int64)
    h = ((i[..., 0] * _P1) ^ (i[..., 1] * _P2) ^ (i[..., 2] * _P3)) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h & 0x7FFFFFFF) & mask


def _pack(ijk: torch.Tensor) -> torch.Tensor:
    """Live-voxel key: 10 wrapped bits per axis + the LIVE bit."""
    return ((ijk[..., 0] & 1023) | ((ijk[..., 1] & 1023) << 10)
            | ((ijk[..., 2] & 1023) << 20) | _LIVE_BIT)


def _unpack_rel(key: torch.Tensor, center_ijk: torch.Tensor) -> torch.Tensor:
    """(..., 3) voxel coords of a LIVE packed key, unwrapped to the
    representative nearest `center_ijk` (exact within ±512 cells)."""
    w = torch.stack([key & 1023, (key >> 10) & 1023, (key >> 20) & 1023],
                    dim=-1)
    return center_ijk + (((w - center_ijk) + 512) & 1023) - 512


def _lookup_slots(key_arr: torch.Tensor, ijk: torch.Tensor,
                  max_probe: int) -> torch.Tensor:
    """Live slot of each voxel coord by linear probing; -1 if absent.
    Tombstones keep the chain walking, an empty key ends it.  One
    device->host read per probe round (the early exit)."""
    mask = key_arr.shape[0] - 1
    h0 = _hash(ijk, mask)
    target = _pack(ijk)
    slot = torch.full(h0.shape, -1, dtype=torch.int64, device=ijk.device)
    open_ = torch.ones(h0.shape, dtype=torch.bool, device=ijk.device)
    for j in range(max_probe):
        cand = (h0 + j) & mask
        k = key_arr[cand]
        hit = k == target
        slot = torch.where(open_ & hit, cand, slot)
        open_ = open_ & ~hit & (k != _KEY_EMPTY)
        if not to_host(torch.any(open_)):
            break
    return slot


def _set_rows_last(target: torch.Tensor, idx: torch.Tensor,
                   rows: torch.Tensor, active: torch.Tensor) -> None:
    """In place: target[idx[r]] = rows[r] for active r, the LAST active r
    winning where indices repeat (the reference's in-order scatter).

    Every lane writes the value its target row ends with — the winner's
    row, or for inactive lanes (sent to row 0) row 0's final value — so
    the unordered CUDA index_put_ is deterministic."""
    n = idx.shape[0]
    tgt = torch.where(active, idx, 0)
    lane = torch.arange(n, dtype=torch.int32, device=idx.device)
    win = torch.full((target.shape[0],), -1, dtype=torch.int32,
                     device=idx.device)
    win.scatter_reduce_(0, tgt, torch.where(active, lane, -1), "amax",
                        include_self=True)
    w = win[tgt]
    val = torch.where((w >= 0)[:, None], rows[torch.clamp(w, min=0).long()],
                      target[tgt])
    target.index_put_((tgt,), val)


def _lexsort(keys) -> torch.Tensor:
    """The permutation jnp.lexsort(keys) gives: the last key is primary,
    ties keep the input order (stable sorts, least significant key
    first)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def insert(m: VoxelHashMap, pts_world: torch.Tensor, valid: torch.Tensor,
           max_probe: int = 16, pre_grouped: bool = False) -> VoxelHashMap:
    """Insert a batch of world-frame points (`valid` masks rows); updates
    the map's tensors IN PLACE (the reference donates its map buffers the
    same way) and returns the map.

    Semantics of ikd-Tree Add_Points with downsample-on-insert: each
    bucket holds at most B points, excess points are dropped.  The rows
    are grouped by voxel (sorted by hash, then coords; invalid rows last),
    each group's head resolves or claims the voxel's slot, and every row
    appends at base + its rank in the group.  New voxels claim empty slots
    by scatter-min on the sorted row index, deterministic.
    pre_grouped=True asserts every valid row is its own voxel's group
    head, as the downsample output at the map's leaf size is, and skips
    the sort.  With a dense index, voxels whose row is current resolve
    through one gather and only the misses probe.
    """
    C, B = m.capacity, m.bucket
    hmask = C - 1
    dev = pts_world.device
    n = pts_world.shape[0]
    ijk = torch.where(valid[:, None], _voxel_of(pts_world, m.voxel_size),
                      _INT_MAX)
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    if pre_grouped:
        ijk_s, pts_s, valid_s = ijk, pts_world, valid
        is_head = valid
        group_head, rank = None, 0
    else:
        h0 = torch.where(valid, _hash(ijk, hmask), _INT_MAX)
        order = _lexsort((ijk[:, 2], ijk[:, 1], ijk[:, 0], h0))
        ijk_s, pts_s, valid_s = ijk[order], pts_world[order], valid[order]
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = torch.any(ijk_s[1:] != ijk_s[:-1], dim=-1)
        is_head = first & valid_s
        group_head = torch.cummax(torch.where(first, idx, 0), dim=0).values
        rank = idx - group_head

    h_s = _hash(ijk_s, hmask)
    key_target = _pack(ijk_s)
    key_arr = m.key

    # fast find through the dense index; the slot's LIVE key is
    # re-verified (a row may point at a slot the crop has tombstoned)
    if m.dense is not None:
        dslot = _dense_lookup(m.dense, ijk_s).to(torch.int64)
        live_ok = key_arr[torch.clamp(dslot, min=0)] == key_target
        dslot = torch.where(live_ok, dslot, -1)
        slot = torch.where(is_head, dslot, -1)
        unresolved = is_head & (dslot < 0)
    else:
        slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
        unresolved = is_head.clone()

    # claim loop over the group heads: one probe round per pass, one host
    # read per round
    probe = torch.zeros(n, dtype=torch.int64, device=dev)
    active = to_host(torch.any(unresolved))
    while active:
        cand = (h_s + probe) & hmask
        kcand = key_arr[cand]
        found = unresolved & (kcand == key_target)
        slot = torch.where(found, cand, slot)
        unresolved = unresolved & ~found
        # claim empty slots (tombstones are never reclaimed)
        tryc = unresolved & (kcand == _KEY_EMPTY)
        claim = torch.full((C,), _INT_MAX, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(tryc, cand, 0),
                              torch.where(tryc, idx, _INT_MAX), "amin",
                              include_self=True)
        won = tryc & (claim[cand] == idx)
        # winners are unique per slot and claimed slots hold key 0, so an
        # add is a set; losers add 0 to slot 0.  Integer index_add_ is
        # exact in any order; index_put_(accumulate=True) would take CUDA's
        # sort-based path (~1.4 ms a call on an H100 at the room shapes)
        key_arr.index_add_(0, torch.where(won, cand, 0),
                           torch.where(won, key_target, 0))
        slot = torch.where(won, cand, slot)
        unresolved = unresolved & ~won
        probe = torch.where(unresolved, probe + 1, probe)
        unresolved = unresolved & (probe < max_probe)
        active = to_host(torch.any(unresolved))
    head_slot = slot
    # every row inherits its group head's slot (-1 if the head failed)
    slot_all = head_slot if group_head is None else head_slot[group_head]
    slot_all = torch.where(valid_s, slot_all, -1)

    # append into the buckets at base + rank
    dest = m.count[torch.clamp(slot_all, min=0)].to(torch.int64) + rank
    ok = (slot_all >= 0) & (dest < B) & valid_s
    flat_pts = m.points.view(C * B, 3)
    _set_rows_last(flat_pts, slot_all * B + dest, pts_s, ok)
    m.count.index_add_(0, torch.where(ok, slot_all, 0), ok.to(torch.int32))
    torch.clamp(m.count, max=B, out=m.count)

    # refresh the dense row of every head that resolved a slot.  Distinct
    # voxels of one batch reach distinct rows only while the torus spans
    # the batch extent — at (8,8,7) x 0.5 m that is 128 x 128 x 64 m
    # against det_range 60 — and two rows of one voxel write the same
    # (key, slot) pair; the last-writer rule covers both cases exactly.
    if m.dense is not None:
        Gx, Gy, Gz, _ = m.dense.shape
        flat = m.dense.view(Gx * Gy * Gz, 2)
        row = torch.stack([key_target, head_slot.to(torch.int32)], dim=-1)
        _set_rows_last(flat, _dense_linear(m.dense.shape, ijk_s), row,
                       is_head & (head_slot >= 0))
    return m


@functools.lru_cache(maxsize=None)
def _neighbor_offsets(n_neighbors: int, device=None) -> torch.Tensor:
    """(NB, 3) int32 cell offsets of the 7/19/27-cell neighbourhood,
    cached per device (read-only)."""
    full = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2),
                                np.arange(-1, 2), indexing="ij"),
                    axis=-1).reshape(27, 3)
    if n_neighbors == 27:
        sel = full
    elif n_neighbors == 7:
        sel = full[np.abs(full).sum(1) <= 1]
    elif n_neighbors == 19:
        sel = full[np.abs(full).sum(1) <= 2]
    else:
        raise ValueError("n_neighbors must be 7, 19 or 27")
    return torch.as_tensor(sel.astype(np.int32), device=device)


def _top_k(score: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, ties to the lower index — the
    order lax.top_k gives (torch.topk leaves ties unspecified)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def knn(m: VoxelHashMap, queries: torch.Tensor, k: int = 5,
        max_probe: int = 16, chunk: int = 32768, n_neighbors: int = 27,
        max_live: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest stored points over each query's voxel neighbourhood.

    Returns (neighbors (N,k,3), sq_dists (N,k), valid (N,k)).  max_live > 0
    gathers points only from the up-to-`max_live` live cells nearest by
    cell-AABB lower bound (exact whenever a query has <= max_live live
    neighbourhood cells).  Rows are independent; `chunk` bounds the
    working set."""
    B = m.bucket
    dtype = m.points.dtype
    BIG = 1e17
    offs = _neighbor_offsets(n_neighbors, queries.device)
    NB = offs.shape[0]
    L = min(max_live, NB) if max_live > 0 else NB

    def one_chunk(q):
        c = q.shape[0]
        nb = _voxel_of(q, m.voxel_size)[:, None, :] + offs[None, :, :]
        if m.dense is not None:
            slots = _dense_lookup(m.dense, nb).to(torch.int64)
        else:
            slots = _lookup_slots(m.key, nb.reshape(-1, 3),
                                  max_probe).reshape(c, NB)
        if L < NB:
            vs = m.voxel_size
            lo = nb.to(dtype) * vs
            dq = torch.maximum(lo - q[:, None, :], q[:, None, :] - (lo + vs))
            lb = torch.sum(torch.clamp(dq, min=0.0) ** 2, dim=-1)
            score = torch.where(slots >= 0, -lb, -BIG)
            _, lane = _top_k(score, L)
            slots = torch.gather(slots, 1, lane)
        cand = m.points[torch.clamp(slots, min=0)]  # (c, L, B, 3)
        d2 = torch.sum((cand - q[:, None, None, :]) ** 2, dim=-1)
        d2 = torch.where(slots[..., None] >= 0, d2, BIG)
        neg_top, top_i = _top_k(-d2.reshape(c, L * B), k)
        top_d2 = -neg_top
        pts = torch.gather(cand.reshape(c, L * B, 3), 1,
                           top_i[..., None].expand(c, k, 3))
        return pts, top_d2, top_d2 < BIG

    outs = [one_chunk(queries[s:s + chunk])
            for s in range(0, queries.shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def crop_outside_box(m: VoxelHashMap, lo: torch.Tensor, hi: torch.Tensor,
                     enabled: torch.Tensor | None = None) -> VoxelHashMap:
    """Tombstone every voxel whose centre lies outside [lo, hi) — the
    moving-FoV-cube box deletion (laserMapping.cpp:1136-1200).  Voxel
    coords come from the packed keys, unwrapped around the box centre.
    `enabled` (device bool) gates the kill mask without a host read.
    Killed slots get sentinel points, so a stale dense row that matches a
    re-entering voxel resolves to a slot with no usable points; the dense
    index itself is left as is (insert re-verifies liveness).
    Returns a new map (the reference's crop is out of place too)."""
    live = (m.key & _LIVE_BIT) != 0
    center_ijk = _voxel_of((lo + hi) * 0.5, m.voxel_size)
    ijk = _unpack_rel(m.key, center_ijk)
    centers = (ijk.to(m.points.dtype) + 0.5) * m.voxel_size
    outside = torch.any((centers < lo) | (centers >= hi), dim=-1)
    kill = live & outside
    if enabled is not None:
        kill = kill & enabled
    return m._replace(
        key=torch.where(kill, _KEY_TOMB, m.key),
        count=torch.where(kill, 0, m.count),
        points=torch.where(kill[:, None, None], _SENTINEL, m.points),
    )
