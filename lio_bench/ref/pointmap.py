"""The reference's map: voxels of a fixed size, each holding at most B
places for points, kept as sorted arrays.

What the map answers, as the program's voxel map defines it:
* insert: a scan's points go in the order given, and a voxel keeps the
  point last given of those that reach it in one scan (a scan's rows at
  the map's own leaf size are one per scan-frame voxel, so a world voxel
  that several reach takes one point of them).  A voxel the map holds
  already takes it at its next place while places are left, and every
  point that reached it uses one; a voxel new to the map uses one place;
* neighbours: the k nearest stored points among the voxels around a
  query (27 cells), or among the `max_live` of those cells that hold
  points and lie nearest the query (by the distance from the query to
  the cell's box);
* crop: the voxels whose centre leaves a box are forgotten.
Voxels are found by binary search over their sorted keys; a neighbour
search reads every candidate point of a query and sorts their
distances.
"""

from __future__ import annotations

import torch

OFF = 1 << 20  # voxel coordinates offset into a non-negative key
SPAN = 1 << 21
BIG = float("inf")


def keys_of(ijk: torch.Tensor) -> torch.Tensor:
    i = ijk.to(torch.int64) + OFF
    return (i[..., 0] * SPAN + i[..., 1]) * SPAN + i[..., 2]


def ijk_of(keys: torch.Tensor) -> torch.Tensor:
    return torch.stack([keys // (SPAN * SPAN), (keys // SPAN) % SPAN,
                        keys % SPAN], -1) - OFF


class PointMap:
    """keys (V,) sorted voxel keys; used (V,) places taken; pts (V, B, 3)
    and real (V, B): the stored points and which places hold one."""

    def __init__(self, voxel: float, bucket: int, keys, used, pts, real):
        self.voxel, self.B = voxel, bucket
        self.keys, self.used, self.pts, self.real = keys, used, pts, real

    @classmethod
    def empty(cls, voxel, bucket, dtype, device):
        return cls(voxel, bucket, torch.zeros(0, dtype=torch.int64,
                                              device=device),
                   torch.zeros(0, dtype=torch.int64, device=device),
                   torch.zeros(0, bucket, 3, dtype=dtype, device=device),
                   torch.zeros(0, bucket, dtype=torch.bool, device=device))

    def copy(self):
        return PointMap(self.voxel, self.B, self.keys.clone(),
                        self.used.clone(), self.pts.clone(),
                        self.real.clone())

    def voxel_of(self, p: torch.Tensor) -> torch.Tensor:
        return torch.floor(p / self.voxel).to(torch.int64)

    def find(self, keys: torch.Tensor) -> torch.Tensor:
        """Row of each key, -1 where the map has no such voxel."""
        if self.keys.numel() == 0:
            return torch.full_like(keys, -1)
        r = torch.searchsorted(self.keys, keys.contiguous())
        rc = torch.clamp(r, max=self.keys.numel() - 1)
        return torch.where(self.keys[rc] == keys, rc, -1)

    def insert(self, p: torch.Tensor) -> None:
        """Insert the rows of p (n, 3), in order (see the module)."""
        if p.shape[0] == 0:
            return
        k = keys_of(self.voxel_of(p))
        uk, inv, cnt = torch.unique(k, return_inverse=True,
                                    return_counts=True)
        last = torch.full((uk.numel(),), -1, dtype=torch.int64,
                          device=p.device)
        last.scatter_reduce_(0, inv, torch.arange(k.numel(), device=p.device),
                             "amax")
        new = self.find(uk) < 0
        fresh = new.clone()
        if bool(new.any()):  # new voxels, empty, merged into the sorted rows
            n = int(new.sum())
            keys = torch.cat([self.keys, uk[new]])
            order = torch.argsort(keys)
            self.keys = keys[order]
            self.used = torch.cat([self.used, self.used.new_zeros(n)])[order]
            self.pts = torch.cat([self.pts, self.pts.new_zeros(
                n, self.B, 3)])[order]
            self.real = torch.cat([self.real, self.real.new_zeros(
                n, self.B)])[order]
        row = self.find(uk)
        c = self.used[row]
        ok = c < self.B
        r, place = row[ok], c[ok]
        self.pts[r, place] = p[last[ok]]
        self.real[r, place] = True
        self.used[row] = torch.where(fresh, 1, torch.clamp(c + cnt,
                                                           max=self.B))

    def crop(self, lo: torch.Tensor, hi: torch.Tensor) -> None:
        """Forget every voxel whose centre lies outside [lo, hi)."""
        c = (ijk_of(self.keys).to(lo.dtype) + 0.5) * self.voxel
        keep = torch.all((c >= lo) & (c < hi), dim=-1)
        self.keys, self.used = self.keys[keep], self.used[keep]
        self.pts, self.real = self.pts[keep], self.real[keep]

    def neighbours(self, q: torch.Tensor, k: int, max_live: int = 0,
                   chunk: int = 4096):
        """(points (n, k, 3), squared distances (n, k)) of the k nearest
        stored points around each query; inf where fewer are found."""
        g = torch.arange(-1, 2, device=q.device)
        offs = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                           -1).reshape(27, 3)
        outs = []
        for s in range(0, q.shape[0], chunk):
            qc = q[s:s + chunk]
            cells = self.voxel_of(qc)[:, None, :] + offs[None]
            row = self.find(keys_of(cells))
            if 0 < max_live < 27:
                lo = cells.to(q.dtype) * self.voxel
                gap = torch.clamp(torch.maximum(lo - qc[:, None],
                                                qc[:, None] - lo - self.voxel),
                                  min=0.0)
                lb = torch.where(row >= 0, torch.sum(gap * gap, -1), BIG)
                pick = torch.sort(lb, dim=1, stable=True).indices[:, :max_live]
                row = torch.gather(row, 1, pick)
            safe = torch.clamp(row, min=0)
            cand = self.pts[safe]  # (c, L, B, 3)
            real = self.real[safe] & (row >= 0)[..., None]
            d2 = torch.where(real, torch.sum((cand - qc[:, None, None]) ** 2,
                                             -1), BIG)
            d2 = d2.reshape(qc.shape[0], -1)
            top = torch.sort(d2, dim=1, stable=True)
            idx = top.indices[:, :k]
            nb = torch.gather(cand.reshape(qc.shape[0], -1, 3), 1,
                              idx[..., None].expand(-1, -1, 3))
            outs.append((nb, top.values[:, :k]))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))
