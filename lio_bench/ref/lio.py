"""The plain reference of the odometry: FAST-LIO's scan step and host
loop as the configuration states them, written for this benchmark.

Per scan: the IMU forward propagation and the points moved to the scan's
end (filter.py), the moving local-map box, the scan's voxel downsample
(one centroid a voxel, the first `n_ds` voxels in key order kept), the
iterated update with a 5-nearest-neighbour plane for each point (a
principal-axis fit, refused unless all five lie within 0.1 m of it, the
fifth within sqrt(5) m, and the point's residual passes the robust gate),
estimating the lidar-IMU extrinsic with the pose where the configuration
says so (`extrinsic_est_en`), and the insert of the scan's points at the
updated pose (pointmap.py).
The host loop: the filter starts from the first groups' IMU samples
(more than ten), stride-cuts a scan to `n_raw` points and its IMU samples
to `n_imu`, and the first scan after the start only builds the map.

It imports nothing of the program.  `load` starts it from the program's
state (its filter state, covariance and map, read as values) so that it
can follow the program step by step.  `rnd` rounds the stored
intermediate results: float64 and the identity for the reference, float32
rounded to TF32's mantissa for the control (control.py).
"""

from __future__ import annotations

import torch

from . import filter as F
from . import geom
from .pointmap import PointMap, keys_of

NN = 5  # neighbours of a plane (NUM_MATCH_POINTS)
NN_DIST2 = 5.0  # the fifth neighbour's largest squared distance
PLANE_FIT = 0.1  # every neighbour within this of its plane
S_GATE = 0.9  # the robust gate: 1 - 0.9 |r| / sqrt(|p|) above this
INIT_SAMPLES = 10  # the start waits for more IMU samples than this
MOV = 1.5  # the box moves once the lidar comes within MOV * det_range


def identity(x):
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest value with TF32's 10-bit mantissa."""
    b = x.to(torch.float32).view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32).to(x.dtype)


def downsample(p: torch.Tensor, leaf: float, n_out: int, packed: bool,
               drop_high_z: bool) -> torch.Tensor:
    """One centroid for each voxel of size `leaf` that holds points, in
    ascending voxel-key order, the first n_out kept.  The key: the voxel's
    coordinates, or, where the scan spans under 1000 voxels (`packed`),
    their ten lowest bits packed x | y << 10 | z << 20 (z raised by 256
    under drop_high_z, so that the highest voxels go first)."""
    ijk = torch.floor(p / leaf).to(torch.int64)
    if packed:
        z = ijk[:, 2] + 256 if drop_high_z else ijk[:, 2]
        key = (ijk[:, 0] & 1023) | ((ijk[:, 1] & 1023) << 10) | \
            ((z & 1023) << 20)
    else:
        key = keys_of(ijk)
    uk, inv, cnt = torch.unique(key, return_inverse=True, return_counts=True)
    s = torch.zeros(uk.numel(), 3, dtype=p.dtype, device=p.device)
    s.index_add_(0, inv, p)
    return (s / cnt[:, None].to(p.dtype))[:n_out]


def plane(nb: torch.Tensor):
    """(normal, offset, within) of the principal-axis plane n.p + d = 0
    (offset >= 0) through each row's neighbours (n, k, 3); `within`: every
    neighbour within PLANE_FIT of it."""
    c = nb.mean(1, keepdim=True)
    q = nb - c
    _, vec = torch.linalg.eigh(q.transpose(1, 2) @ q)
    n = vec[:, :, 0]
    d = -torch.sum(n * c[:, 0], -1)
    s = torch.where(d < 0, -1.0, 1.0).to(d.dtype)
    n, d = n * s[:, None], d * s
    r = torch.abs(torch.einsum("nki,ni->nk", nb, n) + d[:, None])
    return n, d, torch.all(r <= PLANE_FIT, -1)


class RefLIO:
    def __init__(self, cfg: dict, device, dtype=torch.float64, rnd=identity):
        self.cfg, self.dev, self.dt, self.rnd = cfg, device, dtype, rnd
        mp, kd, sh = cfg["mapping"], cfg["ikdtree"], cfg["shapes"]
        self.leaf = mp.get("mappingSurfLeafSize", 0.2)
        self.voxel = kd["filter_size_map_min"]
        self.det = mp["det_range"]
        self.cube_len = mp["cube_len"]
        self.max_iter = kd["max_iteration"]
        self.n_raw, self.n_ds, self.n_imu = (sh["n_raw"], sh["n_ds"],
                                            sh["n_imu"])
        self.bucket = sh.get("map_bucket", 4)
        self.max_live = sh.get("knn_max_live", 0)
        if sh.get("knn_neighbors", 27) != 27:
            raise ValueError("the reference searches 27 cells")
        if kd.get("single_association") or kd.get("plane_cache"):
            raise ValueError("the reference runs the row path, with "
                             "re-association on converged passes")
        self.ext = bool(mp.get("extrinsic_est_en", True))
        self.packed = 2.2 * self.det / self.leaf < 1000.0
        self.drop_high_z = sh.get("ds_drop_high_z", False)
        self.Q = F.noise(cfg, dtype, device)
        self.inited = False
        self._init = []
        self.last_end_abs = None

    def _t(self, a):
        return torch.as_tensor(a, dtype=self.dt, device=self.dev)

    # -- the host loop ---------------------------------------------------------

    def process(self, g: dict) -> None:
        end = float(g["scan_beg_abs"]) + float(g["scan_end_t"])
        if not self.inited:
            self._init.append((g["imu_acc"], g["imu_gyr"]))
            if sum(len(a) for a, _ in self._init) > INIT_SAMPLES:
                self._start()
            self.last_end_abs = end
            return
        pts, pt_t = g["pts"], g["pt_t"]
        if len(pts) > self.n_raw:
            s = -(-len(pts) // self.n_raw)
            pts, pt_t = pts[::s][:self.n_raw], pt_t[::s][:self.n_raw]
        k = min(len(g["imu_acc"]), self.n_imu)
        rel = self.last_end_abs - float(g["scan_beg_abs"])
        self.last_end_abs = end
        self.step(self._t(pts), self._t(pt_t), self._t(g["imu_acc"][:k]),
                  self._t(g["imu_gyr"][:k]), g["imu_t"][:k], rel,
                  float(g["scan_end_t"]))

    def _start(self) -> None:
        import numpy as np

        acc = np.concatenate([a for a, _ in self._init])
        gyr = np.concatenate([w for _, w in self._init])
        ma, mg = self._t(acc.mean(0)), self._t(gyr.mean(0))
        self.acc_norm = float(torch.linalg.vector_norm(ma))
        mp = self.cfg["mapping"]
        R_il = geom.project(self._t(mp.get("extrinsic_R", [1, 0, 0, 0, 1, 0,
                                                           0, 0, 1])
                                    ).reshape(3, 3))
        z = self._t([0.0, 0.0, 0.0])
        self.x = F.State(pos=z, R=torch.eye(3, dtype=self.dt, device=self.dev),
                         R_il=R_il, t_il=self._t(mp.get("extrinsic_T",
                                                        [0.0, 0.0, 0.0])),
                         vel=z, bg=mg, ba=z,
                         grav=-ma / self.acc_norm * geom.GRAVITY)
        self.P = F.initial_P(self.dt, self.dev)
        self.map = PointMap.empty(self.voxel, self.bucket, self.dt, self.dev)
        self.cube = None
        self.last_acc_w, self.last_gyr_b = z, z
        self.ekf_inited = False
        self.inited = True

    def load(self, st: dict, acc_norm: float, last_end_abs: float) -> None:
        """Start from the program's state `st` (harness.snapshot: its
        filter state, covariance, box and map as plain tensors)."""
        d = lambda a: a.to(self.dev, self.dt)  # noqa: E731
        self.x = F.State(pos=d(st["pos"]), R=geom.matrix_of(d(st["rot"])),
                         R_il=geom.matrix_of(d(st["off_r"])),
                         t_il=d(st["off_t"]), vel=d(st["vel"]),
                         bg=d(st["bg"]), ba=d(st["ba"]), grav=d(st["grav"]))
        self.P = d(st["P"])
        self.cube = ((d(st["cube_lo"]), d(st["cube_hi"]))
                     if bool(st["cube_init"]) else None)
        self.last_acc_w, self.last_gyr_b = d(st["last_acc_w"]), \
            d(st["last_gyr_b"])
        self.ekf_inited = bool(st["ekf_inited"])
        self.map = map_of(st, self.voxel, self.bucket, self.dt, self.dev)
        self.acc_norm, self.last_end_abs = acc_norm, last_end_abs
        self.inited = True

    # -- one scan ----------------------------------------------------------------

    def step(self, pts, pt_t, acc, gyr, t_imu, last_end_rel, scan_end_t):
        rnd = self.rnd
        x, P, poses = F.propagate(
            self.x, self.P, self.Q, acc, gyr, t_imu,
            geom.GRAVITY / self.acc_norm, last_end_rel, scan_end_t,
            self.last_acc_w, self.last_gyr_b, rnd)
        body = F.undistort(x, poses, pts, pt_t, self.n_imu, rnd)
        self._box(x.pos + x.R @ x.t_il)
        ds = rnd(downsample(body, self.leaf, self.n_ds, self.packed,
                            self.drop_high_z))
        if self.ekf_inited and ds.shape[0] >= 5:
            x, P = F.update(x, P, self._rows(ds), self.max_iter, rnd)
        self.map.insert(rnd(ds @ (x.R @ x.R_il).T + (x.R @ x.t_il + x.pos)))
        self.x, self.P = x, P
        self.last_acc_w, self.last_gyr_b = poses.acc_w[-1], poses.gyr_b[-1]
        self.ekf_inited = True

    def _box(self, p: torch.Tensor) -> None:
        """The local map's box: centred on the lidar at the first scan,
        moved along each axis whose face comes within MOV * det_range,
        and the map cropped to it when it moves."""
        half = self.cube_len / 2.0
        if self.cube is None:
            self.cube = (p - half, p + half)
            return
        lo, hi = self.cube
        near_lo = torch.abs(p - lo) <= MOV * self.det
        near_hi = torch.abs(hi - p) <= MOV * self.det
        mov = max((self.cube_len - 2.0 * MOV * self.det) * 0.45,
                  self.det * (MOV - 1.0))
        shift = torch.where(near_lo, -mov, torch.where(near_hi, mov, 0.0))
        self.cube = (lo + shift, hi + shift)
        if bool(torch.any(near_lo | near_hi)):
            self.map.crop(*self.cube)

    def _rows(self, ds: torch.Tensor):
        """rows(x, associate) for filter.update over the scan's points
        (laserMapping.cpp, h_share_model): with C = R^T n, a point's row is
        [n, p_imu x C] over position and attitude and, with extrinsic
        estimation, [p_lidar x R_il^T C, C] over the extrinsic's attitude
        and translation besides."""
        rnd = self.rnd
        sq = torch.sqrt(torch.clamp(torch.linalg.vector_norm(ds, dim=-1),
                                    min=1e-8))
        assoc = {}

        def rows(x: F.State, associate: bool):
            p_imu = rnd(ds @ x.R_il.T + x.t_il)
            p_w = rnd(p_imu @ x.R.T + x.pos)
            if associate:
                nb, d2 = self.map.neighbours(p_w, NN, self.max_live)
                found = torch.isfinite(d2[:, -1]) & (d2[:, -1] <= NN_DIST2)
                nb = torch.where(found[:, None, None], nb, 0.0)
                n, d, within = plane(nb)
                assoc.update(n=rnd(n), d=rnd(d), ok=found & within)
            r = rnd(torch.sum(assoc["n"] * p_w, -1) + assoc["d"])
            sel = assoc["ok"] & (1.0 - 0.9 * torch.abs(r) / sq > S_GATE)
            n = assoc["n"][sel]
            C = n @ x.R
            cols = [n, torch.linalg.cross(p_imu[sel], C)]
            if self.ext:  # the extrinsic's attitude and translation
                cols += [torch.linalg.cross(ds[sel], C @ x.R_il), C]
            H = rnd(torch.cat(cols, -1))
            return H, -r[sel]

        return rows

    def pose(self):
        """(7,) float64: position and the attitude's quaternion."""
        return torch.cat([self.x.pos, geom.quat_of(self.x.R)]).double().cpu()


def map_of(st: dict, voxel: float, bucket: int, dtype, device) -> PointMap:
    """The program's map as a PointMap: its live voxels (the keys' ten
    bits a coordinate unwrapped around the state's position), the places
    each has used, and its stored points (the places below the count that
    hold a point, not the empty-place marker).

    A voxel new to the map that several points of one scan reach is given
    a slot for each, one after the other along its probe chain; the last,
    which holds the last point, is the one the map's lookup index finds,
    and so the one read here (the farthest along the table, modulo its
    size)."""
    key = st["key"].to(device).to(torch.int64)
    C = key.numel()
    live = (key & (1 << 30)) != 0
    slot = torch.nonzero(live)[:, 0]
    key = key[live]
    # of the slots that hold one key, the farthest along its chain
    ks, order = torch.sort(key, stable=True)
    sl = slot[order]
    head = torch.ones_like(ks, dtype=torch.bool)
    head[1:] = ks[1:] != ks[:-1]
    grp = torch.cumsum(head.to(torch.int64), 0) - 1
    lo = torch.full((int(grp[-1]) + 1 if grp.numel() else 0,), C,
                    dtype=torch.int64, device=device)
    lo.scatter_reduce_(0, grp, sl, "amin")
    hi = torch.zeros_like(lo).scatter_reduce_(0, grp, sl, "amax")
    wrap = (hi - lo) > C // 2  # a chain that runs past the table's end
    pos = torch.where(wrap[grp] & (sl < C // 2), sl + C, sl)
    best = torch.full_like(lo, -1).scatter_reduce_(0, grp, pos, "amax")
    keep = torch.zeros(C, dtype=torch.bool, device=device)
    keep[best % C] = True
    live = keep
    key = st["key"].to(device).to(torch.int64)[live]
    w = torch.stack([key & 1023, (key >> 10) & 1023, (key >> 20) & 1023], -1)
    c = torch.floor(st["pos"].to(device, torch.float64) / voxel).to(
        torch.int64)
    ijk = c + (((w - c) + 512) & 1023) - 512
    used = st["count"].to(device)[live].to(torch.int64)
    pts = st["points"].to(device)[live].to(dtype)
    real = (torch.arange(bucket, device=device)[None] < used[:, None]) & \
        (torch.abs(pts).amax(-1) < 1e8)
    keys = keys_of(ijk)
    order = torch.argsort(keys)
    return PointMap(voxel, bucket, keys[order], used[order], pts[order],
                    real[order])


__all__ = ["RefLIO", "map_of", "tf32", "identity", "downsample", "plane"]
