"""The traffic generator: synchronised scan groups (one lidar sweep with
its IMU samples) from a traffic file's parameters and a seed.

One general generator reads every traffic file (`<name>.json` beside
this module).  A file names a world and its size, the sensor's returns
a sweep, the range noise, the scan and IMU rates, the walking or
driving speed, a still prefix for the IMU initialisation and the scans
of one closed lap at a constant turn rate.  The sensor sees all around
(a spinning lidar), or, where its `fov_h_deg` and `fov_v_deg` are given,
only the field ahead of it that they span (a solid-state lidar): the
azimuths within fov_h_deg / 2 of its +x axis and the elevations within
fov_v_deg / 2 of its xy plane, in the lidar's frame.  The lap ends where it
began (position, heading, velocity), so the traffic is the still
prefix, then the one lap fed again and again with its times carried
forward: the work of making it does not grow with the run's length.

The worlds are copies of the synthetic worlds the port's tests use (a
box room of planes; an outdoor scene of curved ground, partial facades,
trees, canopy and clutter, with moving boxes).  The world and the lap's
sweeps are made from the file's `world.seed`, so every run seed gets the
same scans and the same work; the run seed picks the lap scan the sensor
starts at and draws the still groups' returns and noise.  Each group is
a dict of the host arrays a sensor driver hands over: pts (n, 3) lidar
frame, pt_t (n,) seconds from the sweep's begin, imu_acc / imu_gyr
(k, 3), imu_t (k,) seconds from the sweep's begin (sample 0 the previous
packet's tail), scan_beg_abs, scan_end_t, and gt_pos, the IMU's true position at the sweep's end in the filter's frame
(the sensor's pose at the start).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

GRAVITY = 9.809
G_VEC = np.array([0.0, 0.0, -GRAVITY])
HERE = Path(__file__).resolve().parent
N_SLICES = 32  # a sweep's pose is held over 1/32 of its duration


def load_spec(name: str) -> dict:
    """The traffic file `<name>.json` beside this module."""
    with open(HERE / f"{name}.json") as f:
        return json.load(f)


class RoomWorld:
    """Box room: floor z=0, walls at x=+-half_x, y=+-half_y, ceiling
    z=height, points sampled on the planes at `density` per m^2."""

    def __init__(self, seed: int, half_x: float, half_y: float,
                 height: float, density: float):
        rng = np.random.default_rng(seed)

        def patch(origin, u, v, lu, lv):
            n = max(int(lu * lv * density), 16)
            a = rng.uniform(0, lu, size=n)
            b = rng.uniform(0, lv, size=n)
            return origin + a[:, None] * u + b[:, None] * v

        o = np.array
        planes = [
            patch(o([-half_x, -half_y, 0.0]), o([1.0, 0, 0]), o([0, 1.0, 0]),
                  2 * half_x, 2 * half_y),
            patch(o([-half_x, -half_y, height]), o([1.0, 0, 0]),
                  o([0, 1.0, 0]), 2 * half_x, 2 * half_y)]
        for sx in (-1, 1):
            planes.append(patch(o([sx * half_x, -half_y, 0.0]), o([0, 1.0, 0]),
                                o([0, 0, 1.0]), 2 * half_y, height))
        for sy in (-1, 1):
            planes.append(patch(o([-half_x, sy * half_y, 0.0]), o([1.0, 0, 0]),
                                o([0, 0, 1.0]), 2 * half_x, height))
        self.points = np.concatenate(planes)
        self.oversample = 1.0

    def sources(self, rng, n, sl, slice_t):
        """(n, 3) world points of n returns (return i captured in time
        slice sl[i]) and whether each is dynamic."""
        return self.points[rng.integers(0, len(self.points), n)], \
            np.zeros(n, bool)


class OutdoorWorld:
    """Outdoor scene: undulating ground, partial facades, tree trunks with
    canopy blobs, structureless clutter, and three moving boxes driven
    through the middle.  dyn_rate is the share of sampled returns drawn
    from the movers; `oversample` samples more returns than are wanted,
    since the range cull keeps only part of them."""

    def __init__(self, seed: int, half: float, n_facades: int,
                 n_trees: int):
        rng = np.random.default_rng(seed)
        self.half = half
        static = []
        n_g = int(half * half * 12)
        gx = rng.uniform(-half, half, n_g)
        gy = rng.uniform(-half, half, n_g)
        static.append(np.stack([gx, gy, self._terrain(gx, gy)], 1))
        for _ in range(n_facades):
            w, h = rng.uniform(6, 14), rng.uniform(3, 7)
            c = rng.uniform(-0.8 * half, 0.8 * half, 2)
            yaw = rng.uniform(0, np.pi)
            u = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            n_f = int(w * h * 30)
            a = rng.uniform(0, w, n_f)
            b = rng.uniform(0, h, n_f)
            base = np.array([c[0], c[1], 0.0]) - 0.5 * w * u
            pts = base + a[:, None] * u + b[:, None] * np.array([0, 0, 1.0])
            pts[:, 2] += self._terrain(pts[:, 0], pts[:, 1])
            static.append(pts)
        for _ in range(n_trees):
            c = rng.uniform(-0.9 * half, 0.9 * half, 2)
            r = rng.uniform(0.15, 0.45)
            hgt = rng.uniform(2.5, 6.0)
            th = rng.uniform(0, 2 * np.pi, 300)
            z = rng.uniform(0, hgt, 300)
            g0 = self._terrain(c[0], c[1])
            static.append(np.stack([c[0] + r * np.cos(th),
                                    c[1] + r * np.sin(th), z + g0], 1))
            static.append(np.array([c[0], c[1], hgt + g0])
                          + rng.normal(scale=[1.8, 1.8, 1.1], size=(500, 3)))
        n_cl = int(half * half * 2.5)
        cl = np.stack([rng.uniform(-half, half, n_cl),
                       rng.uniform(-half, half, n_cl),
                       rng.uniform(0.0, 1.2, n_cl)], 1)
        cl[:, 2] += self._terrain(cl[:, 0], cl[:, 1])
        static.append(cl)
        self.points = np.concatenate(static)
        self.movers = []
        for k in range(3):
            c0 = np.array([rng.uniform(-10, 10), rng.uniform(-6, 6), 0.9])
            v = np.array([rng.uniform(1.0, 3.0) * (-1) ** k,
                          rng.uniform(-0.3, 0.3), 0.0])
            self.movers.append((c0, v, np.array([4.2, 1.8, 1.5])))
        self.dyn_rate = 0.04
        self.oversample = 1.45

    @staticmethod
    def _terrain(x, y):
        return 0.4 * np.sin(np.asarray(x) / 15.0) * np.cos(
            np.asarray(y) / 21.0) + 0.15 * np.sin(np.asarray(y) / 7.0)

    def _mover_points(self, rng, t, n_per=120):
        out = []
        for c0, v, size in self.movers:
            face = rng.integers(0, 3, n_per)
            s = rng.uniform(-0.5, 0.5, (n_per, 3)) * size
            for ax in range(3):
                m = face == ax
                s[m, ax] = 0.5 * size[ax] * np.sign(rng.random(int(m.sum()))
                                                    - 0.5)
            out.append(c0 + v * t + s + [0, 0, 0.5 * size[2]])
        return np.concatenate(out)

    def sources(self, rng, n, sl, slice_t):
        n_dyn = int(self.dyn_rate * n)
        src = self.points[rng.integers(0, len(self.points), n)]
        dyn = np.zeros(n, bool)
        dyn[rng.permutation(n)[:n_dyn]] = True
        for s, t in enumerate(slice_t):
            m = dyn & (sl == s)
            if m.any():
                mv = self._mover_points(rng, t)
                src[m] = mv[rng.integers(0, len(mv), int(m.sum()))]
        return src, dyn


class Lap:
    """One closed lap at constant speed and turn rate: at lap time tau the
    sensor (the IMU) is on a circle of `lap_s` seconds through (0, 0,
    height), facing along it and turning left.  Every function of tau is
    periodic in lap_s, so the lap's end is its start."""

    def __init__(self, speed: float, lap_s: float, height: float):
        self.speed, self.height = speed, height
        self.w = 2.0 * np.pi / lap_s
        self.r = speed / self.w

    def pos(self, tau):
        y = self.w * tau
        return np.array([self.r * np.sin(y), self.r * (1.0 - np.cos(y)),
                         self.height])

    def rot(self, tau):
        c, s = np.cos(self.w * tau), np.sin(self.w * tau)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    def imu(self, tau):
        """Specific force and body rate: acc = R^T (a_w - g)."""
        y = self.w * tau
        a_w = self.speed * self.w * np.array([-np.sin(y), np.cos(y), 0.0])
        return self.rot(tau).T @ (a_w - G_VEC), np.array([0.0, 0.0, self.w])


class Ramp:
    """The run-in onto the lap: from standing at lap time tau0 the sensor
    speeds up along the circle at a constant rate for `ramp_s` seconds,
    reaching the lap's speed at lap time tau0 + ramp_s / 2; t is the time
    since the run-in began."""

    def __init__(self, lap: Lap, tau0: float, ramp_s: float):
        self.lap, self.tau0, self.T = lap, tau0, ramp_s

    def tau(self, t):
        t = min(max(t, 0.0), self.T)
        return self.tau0 + t * t / (2.0 * self.T)

    def pos(self, t):
        return self.lap.pos(self.tau(t))

    def rot(self, t):
        return self.lap.rot(self.tau(t))

    def imu(self, t):
        lap = self.lap
        t = min(max(t, 0.0), self.T)
        speed = lap.speed * t / self.T
        y = lap.w * self.tau(t)
        tangent = np.array([np.cos(y), np.sin(y), 0.0])
        normal = np.array([-np.sin(y), np.cos(y), 0.0])
        a_w = (lap.speed / self.T * tangent
               + speed * speed * lap.w / lap.speed * normal)
        return self.rot(t).T @ (a_w - G_VEC), np.array(
            [0.0, 0.0, lap.w * speed / lap.speed])


class Still:
    """The sensor standing at one pose."""

    def __init__(self, p: np.ndarray, R: np.ndarray):
        self.p, self.R = p, R

    def pos(self, t):
        return self.p

    def rot(self, t):
        return self.R


def build_world(spec: dict):
    w = spec["world"]
    if w["kind"] == "room":
        return RoomWorld(w["seed"], w["half_x"], w["half_y"], w["height"],
                         w["density"])
    if w["kind"] == "outdoor":
        return OutdoorWorld(w["seed"], w["half"], w["facades"], w["trees"])
    raise ValueError(f"unknown world kind {w['kind']!r}")


def extrinsic_of(cfg: dict):
    """(R_il (3, 3), t_il (3,)) of a configuration file: the lidar's pose
    in the IMU frame, p_imu = R_il p_lidar + t_il (identity if absent)."""
    mp = cfg.get("mapping", {})
    R = np.array(mp.get("extrinsic_R", [1, 0, 0, 0, 1, 0, 0, 0, 1]),
                 float).reshape(3, 3)
    return R, np.array(mp.get("extrinsic_T", [0.0, 0.0, 0.0]), float)


def _sweep(world, lap, rng, t0, dur, n, spec, extrinsic):
    """One sweep of n sampled returns: each return's capture time, the
    world point it hits, and the point in the lidar's frame (the lap is
    the IMU's pose, the lidar sits at `extrinsic` in it), culled to the
    sensor's range and field of view."""
    sen = spec["sensor"]
    tofs = np.sort(rng.uniform(0, dur, n))
    slice_t = t0 + (np.arange(N_SLICES) + 0.5) * dur / N_SLICES
    sl = np.minimum((tofs / dur * N_SLICES).astype(int), N_SLICES - 1)
    src, dyn = world.sources(rng, n, sl, slice_t)
    R_il, t_il = extrinsic
    out = np.empty((n, 3))
    for s in range(N_SLICES):
        m = sl == s
        if m.any():
            p_imu = (src[m] - lap.pos(slice_t[s])) @ lap.rot(slice_t[s])
            out[m] = (p_imu - t_il) @ R_il
    out += rng.normal(scale=sen["noise_m"], size=out.shape)
    rr = np.linalg.norm(out, axis=1)
    keep = (rr > sen["min_range_m"]) & (rr < sen["max_range_m"])
    if "fov_h_deg" in sen:
        az = np.degrees(np.arctan2(out[:, 1], out[:, 0]))
        el = np.degrees(np.arctan2(out[:, 2], np.hypot(out[:, 0], out[:, 1])))
        keep &= (np.abs(az) <= 0.5 * sen["fov_h_deg"]) & \
            (np.abs(el) <= 0.5 * sen["fov_v_deg"])
    return out[keep], tofs[keep], dyn[keep]


def _calibrate(world, lap, spec, extrinsic) -> int:
    """Returns to sample a sweep so that about `returns` survive the range
    and field-of-view culls, and the movers' share of the sampled returns,
    from probe sweeps of the world's own generator (seeded by the world,
    so every run seed gets the same numbers).  A world whose every return
    survives a spinning sensor's range cull (oversample 1) samples
    `returns` as they are."""
    sen = spec["sensor"]
    want = sen["returns"]
    if world.oversample == 1.0 and "fov_h_deg" not in sen:
        return want
    prng = np.random.default_rng(spec["world"]["seed"] + 1)
    n_arg = int(want * world.oversample)
    dur = 1.0 / spec["scan_rate_hz"]
    target_dyn = spec["world"].get("dynamic_share", 0.0) * want
    for _ in range(2):
        world.dyn_rate = target_dyn / n_arg
        probe = [len(_sweep(world, lap, prng, t, dur, n_arg, spec,
                            extrinsic)[0])
                 for t in np.linspace(0.1, 0.9, 5) * spec["lap_scans"] * dur]
        n_arg = int(n_arg * want / np.mean(probe))
    world.dyn_rate = target_dyn / n_arg
    return n_arg


def _imu_rows(ts, imu_of, rng, sen):
    """IMU samples at times ts from imu_of(t) -> (acc, gyr), with noise."""
    samples = [imu_of(t) for t in ts]
    acc = np.stack([a for a, _ in samples]) + rng.normal(
        scale=sen["acc_noise"], size=(len(ts), 3))
    gyr = np.stack([w for _, w in samples]) + rng.normal(
        scale=sen["gyr_noise"], size=(len(ts), 3))
    return acc, gyr


class Traffic:
    """The groups of one traffic file under one seed, fed as `group(i)`:
    `prefix`, the still groups (the first initialises the filter) and the
    run-in, then the lap again and again from its scan `phase`, times
    carried forward.  The lap's scans are made from the world's seed, so
    every run seed gets the same lap scans, and the same work: the seed
    picks where on the lap the sensor starts and draws the prefix's
    returns and noise.  Ground truth is in the filter's frame, the sensor's pose at
    the start.  `extrinsic` is the configuration's lidar pose in the IMU
    frame (extrinsic_of)."""

    def __init__(self, spec: dict, seed: int, extrinsic=None):
        self.spec = spec
        dur = 1.0 / spec["scan_rate_hz"]
        imu_T = 1.0 / spec["imu_rate_hz"]
        self.dur = dur
        self.lap_scans = L = int(spec["lap_scans"])
        n_pre = int(spec["still_scans"])
        sen = spec["sensor"]
        self.lap_traj = lap = Lap(spec["speed_mps"], L * dur, sen["height_m"])
        if extrinsic is None:
            extrinsic = (np.eye(3), np.zeros(3))
        world = build_world(spec)
        n_arg = _calibrate(world, lap, spec, extrinsic)
        # the lap: IMU samples over [t0 - imu_T, t1], the head the
        # previous packet's tail (the lap is periodic, so laps join)
        lrng = np.random.default_rng(spec["world"]["seed"] + 2)
        self.lap = []
        for k in range(L):
            t0, t1 = k * dur, (k + 1) * dur
            pts, pt_t, _ = _sweep(world, lap, lrng, t0, dur, n_arg, spec,
                                  extrinsic)
            ts = np.arange(round(t0 / imu_T) - 1, round(t1 / imu_T) + 1
                           ) * imu_T
            acc, gyr = _imu_rows(ts, lap.imu, lrng, sen)
            self.lap.append(dict(pts=pts, pt_t=pt_t, imu_acc=acc,
                                 imu_gyr=gyr, imu_t=ts - t0, scan_end_t=dur,
                                 gt_world=lap.pos(t1)))
        # the run's start: standing still, then the run-in, which reaches
        # the lap's speed where the lap's scan `phase` begins
        rng = np.random.default_rng(seed)
        self.phase = int(rng.integers(L))
        n_ramp = int(spec["ramp_scans"])
        ramp = Ramp(lap, self.phase * dur - n_ramp * dur / 2.0, n_ramp * dur)
        self.p0, self.R0 = ramp.pos(0.0), ramp.rot(0.0)
        still = Still(self.p0, self.R0)
        self.prefix = []
        for k in range(n_pre + n_ramp):
            moving = k >= n_pre
            t0 = (k - n_pre) * dur if moving else k * dur
            t1 = t0 + dur
            traj = ramp if moving else still
            pts, pt_t, _ = _sweep(world, traj, rng, t0, dur, n_arg, spec,
                                  extrinsic)
            ts = np.arange(round(t0 / imu_T) - 1, round(t1 / imu_T) + 1
                           ) * imu_T
            acc, gyr = _imu_rows(
                ts, ramp.imu if moving else
                (lambda t: (self.R0.T @ -G_VEC, np.zeros(3))), rng, sen)
            self.prefix.append(dict(
                pts=pts, pt_t=pt_t, imu_acc=acc, imu_gyr=gyr, imu_t=ts - t0,
                scan_beg_abs=k * dur, scan_end_t=dur,
                gt_pos=self.R0.T @ (traj.pos(t1) - self.p0)))

    def group(self, i: int) -> dict:
        """Group i of the endless feed."""
        if i < len(self.prefix):
            return self.prefix[i]
        j = i - len(self.prefix)
        g = dict(self.lap[(self.phase + j) % self.lap_scans])
        g["scan_beg_abs"] = (len(self.prefix) + j) * self.dur
        g["gt_pos"] = self.R0.T @ (g["gt_world"] - self.p0)
        return g

    def returns(self) -> float:
        """Mean returns a lap sweep."""
        return float(np.mean([len(g["pts"]) for g in self.lap]))
