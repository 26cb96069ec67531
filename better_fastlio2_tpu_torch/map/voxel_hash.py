"""Voxel-hash map on the device — the replacement for ikd-Tree.

Port of better_fastlio2_tpu/map/voxel_hash.py: a fixed-capacity
open-addressing table of voxel buckets,

    key:    (C,)      int32  packed voxel id + liveness
    count:  (C,)      int32  points stored in the slot (<= B)
    points: (C, B, 3) float  sentinel-filled (1e9)
    dense:  (Gx, Gy, Gz, 2) int32 or None — torus lookup index of
            (packed key, slot) rows, verified against the key at lookup
    mom:    (C, 10) float or None — per-slot corner-relative point moments
            [n, Σq, Σqqᵀ upper triangle] of the plane cache
    dmom:   (G, DMOM_CH) float or None — the dense moment table of the
            steady program: [alias tag, n, Σq, Σqqᵀ, pad] at torus address

with the same slot placement as the reference (bit-exact hash), the same
deterministic scatter-min claim protocol, 5-NN over the voxel
neighbourhood, the moving-box crop, the moment accumulation (full scatter
with the mom_cap rescale, or freeze-at-cap under a budget), the insert
budgets and the dense-moment steady insert with torus-wrap forgetting.

Translation notes:
* `_hash` runs its uint32 wrap-around multiplies and logical shifts in
  int64 masked to 32 bits (torch has no full uint32 arithmetic).
* `mode="drop"` scatters become scatters whose inactive lanes add zero
  (integer adds), write the value the target ends with anyway, or land in
  a sink row past the end of a buffer allocated here and cut off.
* Where the reference sets rows through possibly-duplicate indices
  (the bucket append and the dense-index refresh: two downsampled
  centroids of one batch can fall into one world voxel after the
  body->world transform), XLA applies the updates in order, so the last
  one wins.  CUDA's index_put_ picks an undefined winner, so these sets
  resolve the last writer explicitly (`_set_rows_last`).
* The float scatter-adds (`mom.at[slot].add`, `dmom.at[dst].add`) can
  see one target row twice for the same reason; a float index_add_ would
  run on CUDA atomics and change the sums' last bits from run to run.
  `_add_rows` sorts the rows by target, sums each target's rows in order
  (segment_reduce) and writes each target once: the same bits every run.
* `jnp.nonzero(mask, size=K, fill_value=n)` becomes
  utils.device.nonzero_static: same result, no host read.
* The grouped insert's `lexsort` becomes stable sorts from the least
  significant key up, and its `associative_scan(maximum)` group head a
  `torch.cummax`.
* The claim loop and the probe loop are host loops: one device->host read
  per round (utils.device.to_host counts them).
* `knn_sortjoin`'s `lax.sort` over (key, is_query) with a max-carry
  `associative_scan` becomes one stable sort of the combined key and a
  `torch.cummax` over the positions of the map entries.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..parallel import collectives
from ..utils.device import nonzero_static, to_host

__all__ = ["VoxelHashMap", "make_map", "insert", "insert_dense_moments",
           "build_dense_moments", "knn", "knn_sortjoin", "crop_outside_box",
           "num_voxels", "tombstone_fraction", "rebuild", "DMOM_CH"]

DMOM_CH = 12  # dense-moment row channels (see the module docstring)

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
    mom: torch.Tensor | None = None  # (C, 10) float or None
    dmom: torch.Tensor | None = None  # (G, DMOM_CH) float or None

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def bucket(self) -> int:
        return self.points.shape[1]


def make_map(capacity_log2: int = 19, bucket: int = 8,
             voxel_size: float = 0.5, dtype=torch.float32, device=None,
             dense_log2: tuple[int, int, int] | None = None,
             moments: bool = False) -> VoxelHashMap:
    """Allocate an empty map of 2**capacity_log2 slots; dense_log2 adds
    the torus lookup index of 2**lx x 2**ly x 2**lz cells, moments the
    (C, 10) moment accumulator of the plane cache.  The dense moment
    table is attached later (build_dense_moments)."""
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
        mom=(torch.zeros((C, 10), dtype=dtype, device=device)
             if moments else None),
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


def tombstone_fraction(m: VoxelHashMap) -> torch.Tensor:
    """Share of slots holding a tombstone (f32 device scalar)."""
    return torch.mean((m.key == _KEY_TOMB).to(torch.float32))


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


def _add_rows(target: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
              active: torch.Tensor) -> None:
    """In place: target[idx[r]] += rows[r] for active r — the reference's
    `.at[idx].add(rows, mode="drop")` — with the same bits on every run.

    The rows are sorted by target (stable), each target's rows are summed
    in index order by segment_reduce (one segment per distinct target,
    the inactive rows last), and each target is written once.  Lanes
    without a segment write segment 0's value to segment 0's row, so no
    two lanes write different values to one row."""
    n, T = idx.shape[0], target.shape[0]
    dev = idx.device
    key = torch.where(active, idx.to(torch.int64), T)
    ks, order = torch.sort(key, stable=True)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = ks[1:] != ks[:-1]
    seg = torch.cumsum(head.to(torch.int64), dim=0) - 1
    lengths = torch.zeros(n, dtype=torch.int64, device=dev)
    lengths.index_add_(0, seg, torch.ones_like(seg))
    sums = torch.segment_reduce(rows[order], "sum", lengths=lengths,
                                unsafe=True)
    # each segment's target (all its rows write the same value); segments
    # past the last one, and the inactive rows' segment, keep T
    seg_dst = torch.full((n,), T, dtype=torch.int64, device=dev)
    seg_dst.index_put_((seg,), ks)
    real = seg_dst < T
    safe = torch.where(real, seg_dst, torch.clamp(seg_dst[:1], max=T - 1))
    old = target[safe]
    upd = torch.where(real[:, None], old + sums, old)
    val = torch.where(real[:, None], upd, upd[:1])
    target.index_put_((safe,), val)


def _lexsort(keys) -> torch.Tensor:
    """The permutation jnp.lexsort(keys) gives: the last key is primary,
    ties keep the input order (stable sorts, least significant key
    first)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _mom_rows(q: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(n, 10) moment rows [1, q, qqᵀ upper triangle] * gate of
    corner-relative points q."""
    one = gate.to(q.dtype)[:, None]
    return torch.cat([
        one, q * one,
        torch.stack([q[:, 0] * q[:, 0], q[:, 0] * q[:, 1], q[:, 0] * q[:, 2],
                     q[:, 1] * q[:, 1], q[:, 1] * q[:, 2], q[:, 2] * q[:, 2]],
                    dim=-1) * one], dim=-1)


def insert(m: VoxelHashMap, pts_world: torch.Tensor, valid: torch.Tensor,
           max_probe: int = 16, pre_grouped: bool = False,
           claim_budget: int = 0, dense_budget: int = 0,
           moments_only: bool = False, claim_only: bool = False,
           mom_cap: int = 0, mom_budget: int = 0) -> VoxelHashMap:
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

    The steady program's options (the reference's insert docstring):
    claim_budget / dense_budget > 0 (pre_grouped, dense-index maps)
    compact the claim loop and the dense-index refresh to the first
    `budget` dense-miss rows in ascending order; the rest retry on the
    next scan.  moments_only skips the bucket appends.  claim_only only
    claims slots (keys and dense rows) for the batch's voxels: no bucket
    appends, no moments (rebuild's first pass).  With moment
    storage every resolved row adds its corner-relative moment row (also
    rows a full bucket drops); mom_cap > 0 rescales rows past mom_cap
    points back to that weight, or, with mom_budget > 0 and pre_grouped,
    freezes them at the cap and scatters at most mom_budget unsaturated
    rows.
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
        slot0 = torch.where(is_head, dslot, -1)
        unresolved0 = is_head & (dslot < 0)
    else:
        slot0 = torch.full((n,), -1, dtype=torch.int64, device=dev)
        unresolved0 = is_head

    use_claim_budget = claim_budget > 0 and pre_grouped and m.dense is not None
    if use_claim_budget:
        # the claim loop runs over the first claim_budget dense misses
        nb = claim_budget
        sel = nonzero_static(unresolved0, nb, n)
        act = sel < n
        safe_sel = torch.clamp(sel, max=n - 1)
        h_c, key_c = h_s[safe_sel], key_target[safe_sel]
        idx_c = torch.arange(nb, dtype=torch.int64, device=dev)
        slot = torch.full((nb,), -1, dtype=torch.int64, device=dev)
        unresolved = act
    else:
        h_c, key_c, idx_c = h_s, key_target, idx
        slot, unresolved = slot0, unresolved0

    # claim loop: one probe round per pass, one host read per round
    probe = torch.zeros_like(idx_c)
    active = to_host(torch.any(unresolved))
    while active:
        cand = (h_c + probe) & hmask
        kcand = key_arr[cand]
        found = unresolved & (kcand == key_c)
        slot = torch.where(found, cand, slot)
        unresolved = unresolved & ~found
        # claim empty slots (tombstones are never reclaimed)
        tryc = unresolved & (kcand == _KEY_EMPTY)
        claim = torch.full((C,), _INT_MAX, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(tryc, cand, 0),
                              torch.where(tryc, idx_c, _INT_MAX), "amin",
                              include_self=True)
        won = tryc & (claim[cand] == idx_c)
        # winners are unique per slot and claimed slots hold key 0, so an
        # add is a set; losers add 0 to slot 0.  Integer index_add_ is
        # exact in any order; index_put_(accumulate=True) would take CUDA's
        # sort-based path (~1.4 ms a call on an H100 at the room shapes)
        key_arr.index_add_(0, torch.where(won, cand, 0),
                           torch.where(won, key_c, 0))
        slot = torch.where(won, cand, slot)
        unresolved = unresolved & ~won
        probe = torch.where(unresolved, probe + 1, probe)
        unresolved = unresolved & (probe < max_probe)
        active = to_host(torch.any(unresolved))
    if use_claim_budget:
        # the compacted results over the dense-hit baseline (the selected
        # rows are distinct; unselected lanes land in the sink row n)
        head_slot = torch.cat([slot0, slot0.new_full((1,), -1)])
        head_slot.index_put_((torch.where(act, sel, n),), slot)
        head_slot = head_slot[:n]
    else:
        head_slot = slot
    # every row inherits its group head's slot (-1 if the head failed)
    slot_all = head_slot if group_head is None else head_slot[group_head]
    slot_all = torch.where(valid_s, slot_all, -1)

    # append into the buckets at base + rank
    if not (moments_only or claim_only):
        dest = m.count[torch.clamp(slot_all, min=0)].to(torch.int64) + rank
        ok = (slot_all >= 0) & (dest < B) & valid_s
        flat_pts = m.points.view(C * B, 3)
        _set_rows_last(flat_pts, slot_all * B + dest, pts_s, ok)
        m.count.index_add_(0, torch.where(ok, slot_all, 0),
                           ok.to(torch.int32))
        torch.clamp(m.count, max=B, out=m.count)
    elif moments_only and not claim_only and m.mom is None:
        raise ValueError("a moments_only insert needs moment storage")

    # moment accumulation: EVERY resolved row contributes (also rows a
    # full bucket dropped), in voxel-corner-relative coordinates
    if m.mom is not None and not claim_only:
        mok = (slot_all >= 0) & valid_s
        dt = pts_s.dtype
        if mom_cap > 0 and mom_budget > 0 and pre_grouped:
            # freeze-at-cap: only unsaturated voxels accumulate, the
            # first mom_budget of them
            n_seen = m.mom[torch.clamp(slot_all, min=0), 0]
            selm = nonzero_static(mok & (n_seen < mom_cap), mom_budget, n)
            actm = selm < n
            sm = torch.clamp(selm, max=n - 1)
            q_c = pts_s[sm] - ijk_s[sm].to(dt) * m.voxel_size
            _add_rows(m.mom, slot_all[sm], _mom_rows(q_c, actm), actm)
        else:
            q = pts_s - ijk_s.to(dt) * m.voxel_size
            _add_rows(m.mom, slot_all, _mom_rows(q, mok), mok)
            if mom_cap > 0:
                scale = torch.clamp(
                    mom_cap / torch.clamp(m.mom[:, 0], min=1.0), max=1.0)
                m.mom.mul_(scale[:, None])

    # refresh the dense row of every head that resolved a slot.  Distinct
    # voxels of one batch reach distinct rows only while the torus spans
    # the batch extent — at (8,8,7) x 0.5 m that is 128 x 128 x 64 m
    # against det_range 60 — and two rows of one voxel write the same
    # (key, slot) pair; the last-writer rule covers both cases exactly.
    # The budgeted refreshes add new - old to the rows they select (the
    # reference's scatter-add form; integer adds, exact in any order).
    if m.dense is not None:
        Gx, Gy, Gz, _ = m.dense.shape
        flat = m.dense.view(Gx * Gy * Gz, 2)
        lin = _dense_linear(m.dense.shape, ijk_s)

        def delta_set(lin_b, row_b, ok_rows):
            lin_b = torch.where(ok_rows, lin_b, 0)
            delta = torch.where(ok_rows[:, None], row_b - flat[lin_b], 0)
            flat.index_add_(0, lin_b, delta)

        if use_claim_budget and dense_budget > 0:
            # the rows needing a dense write are exactly the claim-loop
            # rows that resolved a slot
            ok_d = act & (slot >= 0)
            delta_set(lin[safe_sel],
                      torch.stack([key_c, slot.to(torch.int32)], dim=-1),
                      ok_d)
        elif dense_budget > 0 and pre_grouped:
            need = unresolved0 & (head_slot >= 0)
            seld = nonzero_static(need, dense_budget, n)
            sd = torch.clamp(seld, max=n - 1)
            delta_set(lin[sd],
                      torch.stack([key_target[sd],
                                   head_slot[sd].to(torch.int32)], dim=-1),
                      seld < n)
        else:
            row = torch.stack([key_target, head_slot.to(torch.int32)],
                              dim=-1)
            _set_rows_last(flat, lin, row, is_head & (head_slot >= 0))
    return m


def _alias_tag(dense_shape, ijk: torch.Tensor) -> torch.Tensor:
    """Packed-key bits ABOVE the torus address, per axis: with the torus
    address they give the full packed key, so an equal tag at the same
    address means the same voxel (within the 1024-cell key period).  The
    shifts are arithmetic on int32, as in the reference."""
    Gx, Gy, Gz = dense_shape[:3]
    lx, ly, lz = (int(Gx).bit_length() - 1, int(Gy).bit_length() - 1,
                  int(Gz).bit_length() - 1)
    bx, by = 10 - lx, 10 - ly
    tx = (ijk[..., 0] >> lx) & ((1 << bx) - 1)
    ty = (ijk[..., 1] >> ly) & ((1 << by) - 1)
    tz = (ijk[..., 2] >> lz) & ((1 << (10 - lz)) - 1)
    return tx | (ty << bx) | (tz << (bx + by))


def _kill_replace_dups(dst: torch.Tensor, own: torch.Tensor,
                       delta: torch.Tensor) -> torch.Tensor:
    """Zero every replace row (own False) after the first of its target
    cell: accumulate rows add up, but a second replace row would subtract
    the old row twice.  Duplicates are rare but real: the downsample
    de-duplicates in the body frame and the body->world transform can put
    two rows into one world voxel.  Stable sort by cell; the kill mask
    goes back through the inverse permutation."""
    order = torch.sort(dst, stable=True).indices
    ds = dst[order]
    dup = torch.zeros_like(own)
    dup[1:] = ds[1:] == ds[:-1]
    kill = torch.empty_like(own)
    kill[order] = dup & ~own[order]
    return torch.where(kill[:, None], 0.0, delta)


def insert_dense_moments(dmom: torch.Tensor, dense_shape: tuple,
                         voxel_size: torch.Tensor, pts_world: torch.Tensor,
                         valid: torch.Tensor, mom_cap: int, mom_budget: int,
                         mesh=None, spmd_ndev: int | None = None,
                         spmd_pre_sliced: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Steady-state moment insert straight into the dense torus table,
    IN PLACE; returns (dmom, n_new_cells) with n_new a device scalar.

    Each valid row accumulates its corner-relative moment row into its
    voxel's torus cell with freeze-at-cap semantics (mom_cap <= 0:
    unbounded), the first mom_budget rows that need it in ascending
    order.  A cell whose alias tag differs from the incoming voxel's holds
    geometry one torus period away: its row is replaced (a delta of
    new - old), which stands in for the FoV box crop.  The batch must be
    pre-grouped (<= 1 row per voxel) and the torus must span its extent;
    same-voxel duplicates after the body->world transform keep only their
    first replace row.

    mesh (a parallel.collectives.Mesh of D = spmd_ndev or mesh.size
    ranks; `dmom` and the batch replicated): the header gather, cap test,
    compaction and delta arithmetic run on this rank's strided rows r::D
    with a mom_budget / D compaction (strided, so that the front-compacted
    rows of the downsample spread evenly and a binding budget selects
    what the one-rank ascending cap does); an all_gather brings the
    ranks' delta rows, targets and own flags together in rank order, a
    psum adds up n_new, and every rank applies the one identical scatter
    (the replace-dedupe runs over the gathered rows).
    spmd_pre_sliced: `pts_world` / `valid` already are this rank's rows
    (ShapesConfig.spmd_local_downsample); the budget is still
    mom_budget / D."""
    G = dmom.shape[0]
    dt = dmom.dtype
    budget = mom_budget
    if mesh is not None:
        D = spmd_ndev or mesh.size
        if mom_budget % D:
            raise ValueError(f"mom_budget {mom_budget} does not divide by "
                             f"the {D} ranks")
        budget = mom_budget // D
        if not spmd_pre_sliced:
            n_all = pts_world.shape[0]
            if n_all % D:
                raise ValueError(f"{n_all} rows do not divide by the {D} "
                                 "ranks")
            r = mesh.rank
            pts_world = pts_world.reshape(n_all // D, D, 3)[:, r]
            valid = valid.reshape(n_all // D, D)[:, r]
    n = pts_world.shape[0]
    ijk = _voxel_of(pts_world, voxel_size)
    lin = _dense_linear(dense_shape, ijk)
    tag = _alias_tag(dense_shape, ijk).to(dt)

    hdr = dmom[lin, 0:2]  # (n, 2): [tag, count]
    own = (hdr[:, 0] == tag) & valid
    n_seen = torch.where(own, hdr[:, 1], 0.0)
    cap = float(mom_cap) if mom_cap > 0 else float("inf")
    need = valid & (n_seen < cap)

    sel = nonzero_static(need, budget, n)
    act = sel < n
    sm = torch.clamp(sel, max=n - 1)
    lin_s = lin[sm]
    old = dmom[lin_s]  # (budget, DMOM_CH)
    q = pts_world[sm] - ijk[sm].to(dt) * voxel_size
    rows = _mom_rows(q, act)
    contrib = torch.cat([tag[sm, None], rows, rows.new_zeros(sel.shape[0], 1)],
                        dim=-1)
    own_s = own[sm] & act
    # own cell: pure accumulate (tag delta 0); stale or new cell: replace
    add_own = torch.cat([torch.zeros_like(contrib[:, :1]), contrib[:, 1:]],
                        dim=-1)
    delta = torch.where(own_s[:, None], add_own, contrib - old)
    delta = delta * act.to(dt)[:, None]
    dst = torch.where(act, lin_s, G)
    n_new = torch.sum((act & ~own_s).to(torch.int32))
    if mesh is not None:
        delta = collectives.all_gather(delta, mesh)
        dst = collectives.all_gather(dst, mesh)
        own_s = collectives.all_gather(own_s, mesh)
        n_new = collectives.psum(n_new, mesh)
    delta = _kill_replace_dups(dst, own_s, delta)
    _add_rows(dmom, dst, delta, dst < G)
    return dmom, n_new


def build_dense_moments(m: VoxelHashMap, center) -> torch.Tensor:
    """The (G, DMOM_CH) dense moment table from the slot moments — the
    warmup->steady handoff, once.  Voxel coords come from the packed keys
    unwrapped around `center` (the FoV-cube centre, a (3,) tensor or
    array), so point-less moments_only voxels transfer too; only voxels
    within the torus half-span minus one cell of it per axis transfer, so
    no two land in one cell."""
    if m.mom is None or m.dense is None:
        raise ValueError("build_dense_moments needs moments and a dense "
                         "index")
    dense_shape = m.dense.shape
    G = dense_shape[0] * dense_shape[1] * dense_shape[2]
    dt = m.points.dtype
    live = ((m.key & _LIVE_BIT) != 0) & (m.mom[:, 0] > 0)
    center_ijk = _voxel_of(torch.as_tensor(center, dtype=dt,
                                           device=m.key.device), m.voxel_size)
    coords = _unpack_rel(m.key, center_ijk)
    for ax in range(3):
        hw_cells = (dense_shape[ax] >> 1) - 1
        live = live & (torch.abs(coords[:, ax] - center_ijk[ax]) <= hw_cells)
    lin = _dense_linear(dense_shape, coords)
    tag = _alias_tag(dense_shape, coords).to(dt)
    rows = torch.cat([tag[:, None], m.mom, m.mom.new_zeros(m.capacity, 1)],
                     dim=-1)
    dmom = torch.zeros((G, DMOM_CH), dtype=dt, device=m.key.device)
    # the target rows start at zero and live cells are distinct: add = set
    _add_rows(dmom, lin, torch.where(live[:, None], rows, 0.0), live)
    return dmom


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


def knn_sortjoin(m: VoxelHashMap, queries: torch.Tensor, k: int = 5,
                 chunk: int = 32768, n_neighbors: int = 27
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN with the slot lookup as a sort-merge join instead of hash
    probing (the reference's TPU variant; only tests call it).  The live
    keys (others padded with INT_MAX) and the queries' neighbourhood keys
    are sorted together by (key, is_query), stably; each query entry takes
    the slot of the last map entry before it when that entry's key equals
    its own.  Same results as `knn` over the full neighbourhood."""
    B, C = m.bucket, m.capacity
    dev = queries.device
    dtype = m.points.dtype
    BIG = 1e17
    offs = _neighbor_offsets(n_neighbors, dev)
    NB = offs.shape[0]
    live = (m.key & _LIVE_BIT) != 0
    map_keys = torch.where(live, m.key, _INT_MAX).to(torch.int64)
    map_slots = torch.arange(C, dtype=torch.int64, device=dev)

    def one_chunk(q):
        c = q.shape[0]
        nb = _voxel_of(q, m.voxel_size)[:, None, :] + offs[None, :, :]
        q_keys = _pack(nb.reshape(-1, 3)).to(torch.int64)
        nq = q_keys.shape[0]
        keys = torch.cat([map_keys, q_keys])
        isq = torch.cat([torch.zeros(C, dtype=torch.int64, device=dev),
                         torch.ones(nq, dtype=torch.int64, device=dev)])
        payload = torch.cat([map_slots,
                             torch.arange(nq, dtype=torch.int64, device=dev)])
        order = torch.sort(keys * 2 + isq, stable=True).indices
        skeys, sisq, spay = keys[order], isq[order], payload[order]
        pos = torch.arange(order.shape[0], device=dev)
        last_map = torch.cummax(torch.where(sisq == 0, pos, -1), 0).values
        src = torch.clamp(last_map, min=0)
        hit = (sisq == 1) & (last_map >= 0) & (skeys[src] == skeys)
        slot_sorted = torch.where(hit, spay[src], -1)
        # back to query order; map entries land in the sink row nq
        out = torch.full((nq + 1,), -1, dtype=torch.int64, device=dev)
        out.index_put_((torch.where(sisq == 1, spay, nq),), slot_sorted)
        slots = out[:nq].reshape(c, NB)
        cand = m.points[torch.clamp(slots, min=0)]  # (c, NB, B, 3)
        d2 = torch.sum((cand - q[:, None, None, :]) ** 2, dim=-1)
        d2 = torch.where(slots[..., None] >= 0, d2, BIG)
        neg_top, top_i = _top_k(-d2.reshape(c, NB * B), k)
        top_d2 = -neg_top
        pts = torch.gather(cand.reshape(c, NB * B, 3), 1,
                           top_i[..., None].expand(c, k, 3))
        return pts, top_d2.to(dtype), top_d2 < BIG

    outs = [one_chunk(queries[s:s + chunk])
            for s in range(0, queries.shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def crop_outside_box(m: VoxelHashMap, lo: torch.Tensor, hi: torch.Tensor,
                     enabled: torch.Tensor | None = None,
                     skip_points: bool = False) -> VoxelHashMap:
    """Tombstone every voxel whose centre lies outside [lo, hi) — the
    moving-FoV-cube box deletion (laserMapping.cpp:1136-1200).  Voxel
    coords come from the packed keys, unwrapped around the box centre.
    `enabled` (device bool) gates the kill mask without a host read.
    Killed slots get zero moments and sentinel points, so a stale dense
    row that matches a re-entering voxel resolves to a slot with no usable
    points; the dense index itself is left as is (insert re-verifies
    liveness).  skip_points=True leaves the points untouched (the steady
    plane-cache program never reads them).
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
        points=(m.points if skip_points else
                torch.where(kill[:, None, None], _SENTINEL, m.points)),
        mom=(torch.where(kill[:, None], 0.0, m.mom)
             if m.mom is not None else None),
    )


def rebuild(m: VoxelHashMap, max_probe: int = 16,
            center=None) -> VoxelHashMap:
    """Compact the table: re-create every live voxel in a fresh map of the
    same shapes (the recontructIKdTree analog, laserMapping.cpp:612-669).

    `center` (a world-frame (3,) tensor or array, e.g. the FoV-cube
    centre) takes each live voxel's coords from its packed key, unwrapped
    around it, and claims every live voxel first, so that point-less
    voxels of moments_only inserts survive with their moments; without it
    the coords come from each bucket's first point.  The stored points are
    re-inserted (grouped insert), the FULL slot moments are carried over
    to the new slots, and the dense moment table is kept as it is (it is
    keyed by torus address and alias tag, not by slot).  Returns a new map
    of new tensors; `m` is left as it was."""
    C, B = m.capacity, m.bucket
    dev = m.key.device
    live_slot = (m.key & _LIVE_BIT) != 0
    live = live_slot[:, None] & (torch.arange(B, device=dev)[None, :]
                                 < m.count[:, None])
    fresh = make_map(
        capacity_log2=C.bit_length() - 1, bucket=B, dtype=m.points.dtype,
        device=dev,
        dense_log2=(tuple(int(g).bit_length() - 1 for g in m.dense.shape[:3])
                    if m.dense is not None else None),
        moments=m.mom is not None)
    fresh = fresh._replace(voxel_size=m.voxel_size.clone())
    if center is not None:
        c = torch.as_tensor(center, dtype=m.points.dtype, device=dev)
        coords = _unpack_rel(m.key, _voxel_of(c, m.voxel_size))
        reps = (coords.to(m.points.dtype) + 0.5) * m.voxel_size
        fresh = insert(fresh, reps, live_slot, max_probe=max_probe,
                       pre_grouped=True, claim_only=True)
    else:
        coords = _voxel_of(m.points[:, 0, :], m.voxel_size)
    out = insert(fresh, m.points.reshape(C * B, 3), live.reshape(C * B),
                 max_probe=max_probe)
    if m.mom is not None:
        # each surviving voxel's fresh moments become its old row (the
        # new slots are distinct; the other lanes write a sink row)
        new_slot = _lookup_slots(out.key, coords, max_probe)
        ok = live_slot & (new_slot >= 0)
        mom = torch.cat([out.mom, out.mom.new_zeros(1, out.mom.shape[1])])
        mom.index_put_((torch.where(ok, new_slot, C),), m.mom)
        out = out._replace(mom=mom[:C])
    if m.dmom is not None:
        out = out._replace(dmom=m.dmom)
    return out
