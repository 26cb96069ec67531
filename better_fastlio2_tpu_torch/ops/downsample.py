"""Voxel-grid downsampling — static-shape analog of pcl::VoxelGrid.

Port of better_fastlio2_tpu/ops/downsample.py: one centroid per occupied
voxel via a stable sort + segmented mean, padded to a fixed size with a
mask.  The multi-operand lax.sort becomes torch.sort(key, stable=True) plus
gathers, and the `mode="drop"` segmented sums become torch.segment_reduce
over the sorted rows, whose last segment is a sink at index M (so groups
past the output size drop, exactly as `mode="drop"` does).  When the
occupied voxels exceed `out_size`, the surviving set and its order are
those of the reference: both sort stably on the same keys.

The sums are deterministic on every device: segment_reduce adds each
segment's rows in order, where a float index_add_ would run on CUDA atomics
and move the centroids' last bits from run to run.
"""

from __future__ import annotations

import torch

__all__ = ["voxel_downsample"]

_INT_MAX = 2147483647


def voxel_downsample(pts: torch.Tensor, valid: torch.Tensor, voxel_size,
                     out_size: int | None = None, packed_key: bool = False,
                     drop_high_z: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Centroid-per-voxel downsample of (N, 3) padded points.

    packed_key: sort one int32 key of 10-bit-wrapped voxel coords (valid
    while the batch's per-axis extent is under 1024 cells, true for
    sensor-frame scans) instead of a 3-key lexsort.  drop_high_z (packed
    key only): offset z by +256 so overflow drops the highest cells first.

    Returns (out_pts (M, 3), out_valid (M,)).
    """
    N = pts.shape[0]
    M = out_size or N
    ijk = torch.floor(pts / voxel_size).to(torch.int32)
    ijk = torch.where(valid[:, None], ijk, _INT_MAX)
    if packed_key:
        zk = ijk[:, 2] + 256 if drop_high_z else ijk[:, 2]
        key = torch.where(
            valid,
            (ijk[:, 0] & 1023) | ((ijk[:, 1] & 1023) << 10)
            | ((zk & 1023) << 20),
            _INT_MAX)
        key_s, order = torch.sort(key, stable=True)
        head_ne = key_s[1:] != key_s[:-1]
    else:
        # lexsort by (i, j, k): stable sorts from the last key to the first
        order = torch.arange(N, device=pts.device)
        for ax in (2, 1, 0):
            _, o = torch.sort(ijk[order, ax], stable=True)
            order = order[o]
        ijk_s = ijk[order]
        head_ne = torch.any(ijk_s[1:] != ijk_s[:-1], dim=-1)
    valid_s = valid[order]
    pts_s = torch.where(valid_s[:, None], pts[order], 0.0)

    head = torch.cat([head_ne.new_ones(1), head_ne]) & valid_s
    seg = torch.cumsum(head.to(torch.int64), dim=0) - 1
    seg = torch.where(valid_s & (seg < M), seg, M)  # sink row M drops

    # seg is non-decreasing in sorted order (segments 0..M-1, then the sink
    # M), so the rows of each output lie contiguously; rows below M are all
    # valid, so their lengths are the counts.  Integer adds are exact.
    lengths = torch.zeros(M + 1, dtype=torch.int64, device=pts.device)
    lengths.index_add_(0, seg, torch.ones_like(seg))
    sums = torch.segment_reduce(pts_s, "sum", lengths=lengths, unsafe=True)
    sums, cnts = sums[:M], lengths[:M]
    out = sums / torch.clamp(cnts, min=1)[:, None].to(pts.dtype)
    return out, cnts > 0
