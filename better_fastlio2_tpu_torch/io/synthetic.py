"""Synthetic LiDAR-inertial world for integration tests and benchmarks.

The reference validates only by rosbag replay on real datasets (SURVEY.md
§4 — it has no automated tests).  This module provides what the reference
never had: a closed-loop simulator with analytic ground truth, so the full
pipeline (propagation, undistortion, association, update, mapping) can be
regression-tested to centimetre ATE bounds in CI without dataset downloads.

World: points sampled on large planes (floor + walls) — ideal for the
point-to-plane model.  Trajectory: analytic position/yaw with exact IMU
(specific force + body rates) generated from the same kinematic
conventions the filter integrates (core/esikf.get_f).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GRAVITY = 9.809
G_VEC = np.array([0.0, 0.0, -GRAVITY])

__all__ = ["SyntheticWorld", "OutdoorWorld", "Trajectory",
           "make_lio_sequence", "make_bench_sequence"]


class SyntheticWorld:
    """Box room: floor z=0, walls at x=±hx, y=±hy, ceiling z=hz."""

    def __init__(
        self,
        seed: int = 0,
        half_x: float = 30.0,
        half_y: float = 30.0,
        height: float = 8.0,
        density: float = 40.0,  # points per m^2
    ):
        rng = np.random.default_rng(seed)
        planes = []

        def patch(origin, u, v, lu, lv):
            n = max(int(lu * lv * density), 16)
            a = rng.uniform(0, lu, size=n)
            b = rng.uniform(0, lv, size=n)
            return origin + a[:, None] * u + b[:, None] * v

        o = np.array
        planes.append(patch(o([-half_x, -half_y, 0.0]), o([1.0, 0, 0]),
                            o([0, 1.0, 0]), 2 * half_x, 2 * half_y))  # floor
        planes.append(patch(o([-half_x, -half_y, height]), o([1.0, 0, 0]),
                            o([0, 1.0, 0]), 2 * half_x, 2 * half_y))  # ceiling
        for sx in (-1, 1):
            planes.append(
                patch(o([sx * half_x, -half_y, 0.0]), o([0, 1.0, 0]),
                      o([0, 0, 1.0]), 2 * half_y, height)
            )
        for sy in (-1, 1):
            planes.append(
                patch(o([-half_x, sy * half_y, 0.0]), o([1.0, 0, 0]),
                      o([0, 0, 1.0]), 2 * half_x, height)
            )
        self.points = np.concatenate(planes).astype(np.float64)

    def scan(
        self,
        pos_of_t,
        rot_of_t,
        t0: float,
        duration: float,
        n_points: int,
        max_range: float = 50.0,
        min_range: float = 1.0,
        noise: float = 0.0,
        rng: np.random.Generator | None = None,
    ):
        """Simulate one sweep: each point sampled at its own time within
        [t0, t0+duration) from the continuously-moving sensor.

        Returns (pts_lidar (n,3), t_offsets (n,)) — lidar-frame points with
        per-point capture-time offsets, like the reference's `curvature`
        channel (preprocess.cpp per-vendor handlers)."""
        rng = rng or np.random.default_rng(1)
        tofs = np.sort(rng.uniform(0, duration, size=n_points))
        idx = rng.integers(0, len(self.points), size=n_points)
        pw = self.points[idx]
        out = np.empty((n_points, 3))
        # vectorized over unique-ish times: chunk into 32 time slices
        n_slices = 32
        sl = np.minimum((tofs / duration * n_slices).astype(int), n_slices - 1)
        for s in range(n_slices):
            m = sl == s
            if not m.any():
                continue
            tm = t0 + (s + 0.5) * duration / n_slices
            R = rot_of_t(tm)
            p = pos_of_t(tm)
            out[m] = (pw[m] - p) @ R  # R^T (pw - p)
        if noise:
            out += rng.normal(scale=noise, size=out.shape)
        rng_ok = np.linalg.norm(out, axis=1)
        keep = (rng_ok > min_range) & (rng_ok < max_range)
        return out[keep], tofs[keep]


class OutdoorWorld:
    """Hostile outdoor-like scene — the adversarial counterpart of the
    box room, built so the point-to-plane model and the per-voxel plane
    cache CANNOT rely on large dense planes:

    * undulating ground (curved, never exactly planar)
    * sparse partial building facades (small patches, gaps between them)
    * tree trunks (vertical cylinders) with volumetric canopy clutter
    * free-floating clutter points on no structure at all (vegetation)
    * a few moving box objects (cars) translating through the scene —
      their returns are sampled at the point's capture time, so they
      smear across the sweep exactly like real dynamic objects

    The mixture weights put ~35% of returns on curved/cluttered/dynamic
    geometry, which drops plane-fit validity and cache hit rates the way
    real outdoor scans do (BASELINE.md's second workload row)."""

    def __init__(self, seed: int = 0, half: float = 60.0,
                 n_facades: int = 24, n_trees: int = 60,
                 dyn_rate: float = 0.04):
        rng = np.random.default_rng(seed)
        self.half = half
        # fraction of SAMPLED rows drawn from the movers (pre-cull).
        # Movers are corridor objects (nearly always in range), so when
        # a caller oversamples against a low static in-range fraction
        # (large worlds), the default 0.04 inflates the dynamic share
        # of KEPT returns — make_bench_sequence calibrates this down to
        # hold the kept-share of the original workload.
        self.dyn_rate = dyn_rate
        static = []

        # ground: sampled on a grid patchwork with height field.
        # Density matters for fairness: the world must carry enough
        # unique structure that a 30k-point scan is mostly fresh surface
        # samples (a too-sparse world lets ANY implementation skip work).
        n_g = int(half * half * 12)
        gx = rng.uniform(-half, half, n_g)
        gy = rng.uniform(-half, half, n_g)
        gz = self._terrain(gx, gy)
        static.append(np.stack([gx, gy, gz], 1))

        # facades: partial wall patches, random yaw, 6-14 m wide
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

        # tree trunks + canopy blobs
        for _ in range(n_trees):
            c = rng.uniform(-0.9 * half, 0.9 * half, 2)
            r = rng.uniform(0.15, 0.45)
            hgt = rng.uniform(2.5, 6.0)
            n_t = 300
            th = rng.uniform(0, 2 * np.pi, n_t)
            z = rng.uniform(0, hgt, n_t)
            trunk = np.stack(
                [c[0] + r * np.cos(th), c[1] + r * np.sin(th),
                 z + self._terrain(c[0], c[1])], 1)
            static.append(trunk)
            n_c = 500
            canopy = (np.array([c[0], c[1],
                                hgt + self._terrain(c[0], c[1])])
                      + rng.normal(scale=[1.8, 1.8, 1.1], size=(n_c, 3)))
            static.append(canopy)

        # structureless clutter (bushes/grass returns)
        n_cl = int(half * half * 2.5)
        cl = np.stack([
            rng.uniform(-half, half, n_cl),
            rng.uniform(-half, half, n_cl),
            rng.uniform(0.0, 1.2, n_cl),
        ], 1)
        cl[:, 2] += self._terrain(cl[:, 0], cl[:, 1])
        static.append(cl)

        self.points = np.concatenate(static).astype(np.float64)

        # moving boxes: (center0 (3,), velocity (3,), size (3,)) — driven
        # through the corridor the trajectory uses
        self.movers = []
        for k in range(3):
            c0 = np.array([rng.uniform(-10, 10), rng.uniform(-6, 6), 0.9])
            v = np.array([rng.uniform(1.0, 3.0) * (-1) ** k,
                          rng.uniform(-0.3, 0.3), 0.0])
            size = np.array([4.2, 1.8, 1.5])
            self.movers.append((c0, v, size))
        self._rng = rng

    @staticmethod
    def _terrain(x, y):
        return 0.4 * np.sin(np.asarray(x) / 15.0) * np.cos(
            np.asarray(y) / 21.0) + 0.15 * np.sin(np.asarray(y) / 7.0)

    def _mover_points(self, t, n_per=120):
        out = []
        for c0, v, size in self.movers:
            c = c0 + v * t
            face = self._rng.integers(0, 3, n_per)
            s = self._rng.uniform(-0.5, 0.5, (n_per, 3)) * size
            for ax in range(3):
                m = face == ax
                s[m, ax] = 0.5 * size[ax] * np.sign(
                    self._rng.random(int(m.sum())) - 0.5)
            out.append(c + s + [0, 0, 0.5 * size[2]])
        return np.concatenate(out)

    def scan(self, pos_of_t, rot_of_t, t0, duration, n_points,
             max_range=50.0, min_range=1.0, noise=0.0, rng=None,
             return_labels=False):
        """Same contract as SyntheticWorld.scan; ~4% of returns come from
        the moving objects, sampled at each slice's capture time.
        return_labels=True additionally returns the per-return ground
        truth is_dynamic mask (the mover-origin rows) — the evaluation
        input for io.evaluate.pr_rr_f1."""
        rng = rng or np.random.default_rng(1)
        # oversample so the post-cull scan still delivers ~n_points
        # returns (fairness: both bench workloads feed the same point
        # budget to both implementations)
        n_points = int(n_points * 1.45)
        n_dyn = int(self.dyn_rate * n_points)
        n_stat = n_points - n_dyn
        tofs = np.sort(rng.uniform(0, duration, size=n_points))
        idx = rng.integers(0, len(self.points), size=n_stat)
        out = np.empty((n_points, 3))
        src = np.empty((n_points, 3))
        n_slices = 32
        sl = np.minimum((tofs / duration * n_slices).astype(int),
                        n_slices - 1)
        # dynamic returns: uniformly spread over the sweep
        dyn_rows = rng.permutation(n_points)[:n_dyn]
        stat_mask = np.ones(n_points, bool)
        stat_mask[dyn_rows] = False
        src[stat_mask] = self.points[idx[: stat_mask.sum()]]
        for s in range(n_slices):
            m = sl == s
            if not m.any():
                continue
            tm = t0 + (s + 0.5) * duration / n_slices
            dyn_m = m & ~stat_mask
            if dyn_m.any():
                mv = self._mover_points(tm)
                src[dyn_m] = mv[rng.integers(0, len(mv), int(dyn_m.sum()))]
            R = rot_of_t(tm)
            p = pos_of_t(tm)
            out[m] = (src[m] - p) @ R
        if noise:
            out += rng.normal(scale=noise, size=out.shape)
        rr = np.linalg.norm(out, axis=1)
        keep = (rr > min_range) & (rr < max_range)
        if return_labels:
            return out[keep], tofs[keep], (~stat_mask)[keep]
        return out[keep], tofs[keep]


@dataclass
class Trajectory:
    """Analytic trajectory: stationary for t_still, then constant forward
    speed with sinusoidal yaw — smooth, fully differentiable.

    yaw_rate adds a constant turn rate on top of the sinusoid, bending
    the path into a closed loop of radius speed/yaw_rate: lets long
    benchmark runs (hundreds of scans) stay inside a bounded world
    instead of exiting through a wall."""

    t_still: float = 1.2
    speed: float = 2.0
    yaw_amp: float = 0.3
    yaw_freq: float = 0.25
    height: float = 1.5
    yaw_rate: float = 0.0

    def _tau(self, t):
        return max(t - self.t_still, 0.0)

    def pos(self, t):
        tau = self._tau(t)
        w = 2 * np.pi * self.yaw_freq
        # integrate heading analytically via small-step quadrature cache-free
        # (cheap: called at IMU rate only)
        n = max(int(tau * 200), 1)
        ts = np.linspace(0, tau, n + 1)
        yaws = self.yaw_amp * np.sin(w * ts) + self.yaw_rate * ts
        dirs = np.stack([np.cos(yaws), np.sin(yaws)], axis=1)
        xy = self.speed * np.trapezoid(dirs, ts, axis=0) if tau > 0 else np.zeros(2)
        return np.array([xy[0], xy[1], self.height])

    def yaw(self, t):
        tau = self._tau(t)
        return (self.yaw_amp * np.sin(2 * np.pi * self.yaw_freq * tau)
                + self.yaw_rate * tau)

    def rot(self, t):
        c, s = np.cos(self.yaw(t)), np.sin(self.yaw(t))
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

    def vel(self, t):
        tau = self._tau(t)
        if tau <= 0:
            return np.zeros(3)
        y = self.yaw(t)
        return self.speed * np.array([np.cos(y), np.sin(y), 0.0])

    def acc_world(self, t):
        tau = self._tau(t)
        if tau <= 0:
            return np.zeros(3)
        w = 2 * np.pi * self.yaw_freq
        yd = self.yaw_amp * w * np.cos(w * tau) + self.yaw_rate
        y = self.yaw(t)
        return self.speed * yd * np.array([-np.sin(y), np.cos(y), 0.0])

    def gyro_body(self, t):
        tau = self._tau(t)
        if tau <= 0:
            return np.zeros(3)
        w = 2 * np.pi * self.yaw_freq
        return np.array(
            [0.0, 0.0, self.yaw_amp * w * np.cos(w * tau) + self.yaw_rate])

    def imu_sample(self, t, rng=None, acc_noise=0.0, gyr_noise=0.0):
        """Specific force + body rate: acc = R^T (a_w - g_vec)."""
        R = self.rot(t)
        acc = R.T @ (self.acc_world(t) - G_VEC)
        gyr = self.gyro_body(t)
        if rng is not None:
            acc = acc + rng.normal(scale=acc_noise, size=3)
            gyr = gyr + rng.normal(scale=gyr_noise, size=3)
        return acc, gyr


def make_bench_sequence(workload: str, n_scans: int, n_points: int = 30_000,
                        seed: int = 7):
    """The benchmark workloads, shared verbatim by bench.py and the C++
    reference-baseline harness (tools/bench_cpu_ref.py) so the
    vs_baseline ratio stays apples-to-apples on every workload.

    "room"    — the six-plane box room (the design's best case)
    "outdoor" — the hostile OutdoorWorld mix (curved ground, partial
                facades, trees, clutter, moving objects)

    The trajectory is the straight-ish 3 m/s path the baselines were
    measured on.  (A loop variant via Trajectory.yaw_rate exists — but
    it SPEEDS UP the C++ baseline ~40% by shrinking the map it
    revisits, so switching paths would silently move the vs_baseline
    denominator; both sides pin the original path.)

    Outdoor world sizing (round 5): the workload contract is ~n_points
    returns reaching the filter on EVERY scan (the KITTI-class 64-beam
    profile bench.py advertises — a real sequence does not thin out).
    The original half=60 world violated it: the path runs off the
    world's edge, so the 50 m sensing disc progressively empties and
    per-scan returns decay 29k -> 10k (mean 20.8k over 240 scans) —
    which discounts the per-point C++ baseline on the back half while
    the TPU program pays its full padded cost either way.  The world is
    now sized so the sensing disc stays interior along the whole path
    (half = path reach + 58 m), structure counts scale with area so the
    per-scan geometry MIX (curved ground / facades / trees / canopy /
    clutter) is statistically unchanged, and the sample count is
    calibrated against the built world's measured in-range density so
    kept returns track ~n_points throughout.  Both sides of the ratio
    (bench.py and tools/bench_cpu_ref.py) consume this same function,
    and the C++ baseline + its end error were re-measured on the fixed
    sequence (BASELINE.md).
    """
    traj = Trajectory(t_still=0.7, speed=3.0)
    if workload == "room":
        world = None  # make_lio_sequence default (SyntheticWorld)
    elif workload == "outdoor":
        duration = n_scans / 10.0
        reach = 3.0 * max(duration - traj.t_still, 0.0)
        half = max(60.0, reach + 58.0)
        area = (half / 60.0) ** 2
        world = OutdoorWorld(seed=seed, half=half,
                             n_facades=int(round(24 * area)),
                             n_trees=int(round(60 * area)))
        # Calibrate (sample count, mover rate) against probe scans so
        # the generated sequence matches the original workload's
        # per-scan contract: ~n_points kept returns with the original
        # start-of-path dynamic share (~6% of kept).  scan() oversamples
        # x1.45 then culls to [1, 50] m; movers are corridor objects
        # kept at ~full rate, so dyn_rate must shrink with the static
        # in-range fraction or the dynamic share balloons.
        P = world.points[:, :2]
        fracs = []
        for t in np.linspace(traj.t_still + 1.0, duration, 9):
            d = np.linalg.norm(P - traj.pos(t)[:2], axis=1)
            fracs.append(np.mean(d < 50.0))
        frac = float(np.mean(fracs))
        target_dyn = 0.058 * n_points  # original half=60 start-of-path
        n_arg = int(n_points / (1.45 * frac))
        world.dyn_rate = target_dyn / (1.45 * n_arg)
        # one empirical correction round: probe scans absorb every
        # composition effect the analytic estimate misses (probe rng is
        # private — the sequence rng below is untouched)
        prng = np.random.default_rng(seed + 1)
        kept = [len(world.scan(traj.pos, traj.rot, t, 1.0 / 10.0, n_arg,
                               noise=0.004, rng=prng)[0])
                for t in np.linspace(traj.t_still + 1.0, duration - 0.1, 5)]
        n_arg = int(n_arg * n_points / np.mean(kept))
        world.dyn_rate = target_dyn / (1.45 * n_arg)
        n_points = n_arg
    else:
        raise ValueError(f"unknown workload {workload!r}")
    return list(make_lio_sequence(
        duration=n_scans / 10.0, scan_rate=10.0, imu_rate=100.0,
        n_points=n_points, seed=seed, noise=0.004,
        traj=traj, world=world,
    ))


def make_lio_sequence(
    duration: float = 8.0,
    scan_rate: float = 10.0,
    imu_rate: float = 100.0,
    n_points: int = 8000,
    seed: int = 0,
    noise: float = 0.005,
    traj: Trajectory | None = None,
    world: SyntheticWorld | None = None,
    labels: bool = False,
    gyr_bias_walk: float = 0.0,
):
    """Generate a full synchronized sequence of (scan, imu) measurement
    groups, the sync_packages analog (laserMapping.cpp:1374).

    Yields dicts with keys: pts, pt_t, imu_acc, imu_gyr, imu_t,
    scan_beg_abs, scan_end_t, gt_pos, gt_rot (ground truth at scan end).
    labels=True (worlds whose scan() supports return_labels, i.e.
    OutdoorWorld) adds gt_dynamic: the per-return mover ground truth —
    the PR/RR/F1 evaluation input for dynamic removal.
    gyr_bias_walk > 0 adds a random-walk gyro bias (rad/s per sqrt
    sample at imu_rate) on top of the white noise — the real-IMU drift
    mechanism an otherwise-perfect simulator lacks.  A walk faster than
    the filter's assumed bias process noise leaks into yaw and
    accumulates position drift over long runs: what loop closure exists
    to correct (the bench.py --slam workload uses this).
    """
    rng = np.random.default_rng(seed)
    bias_g = np.zeros(3)
    traj = traj or Trajectory()
    world = world or SyntheticWorld(seed=seed)
    scan_T = 1.0 / scan_rate
    imu_T = 1.0 / imu_rate
    groups = []
    n_scans = int(duration * scan_rate)
    for k in range(n_scans):
        t0 = k * scan_T
        t1 = t0 + scan_T
        gt_dyn = None
        if labels:
            pts, pt_t, gt_dyn = world.scan(
                traj.pos, traj.rot, t0, scan_T, n_points, noise=noise,
                rng=rng, return_labels=True
            )
        else:
            pts, pt_t = world.scan(
                traj.pos, traj.rot, t0, scan_T, n_points, noise=noise,
                rng=rng
            )
        # IMU samples covering [t0 - imu_T, t1] (head = prev packet tail)
        ts = np.arange(np.floor(t0 / imu_T) * imu_T - imu_T, t1 + 1e-9, imu_T)
        samples = [traj.imu_sample(t, rng, 0.01, 0.001) for t in ts]
        acc = np.stack([s[0] for s in samples])
        gyr = np.stack([s[1] for s in samples])
        if gyr_bias_walk > 0.0:
            # walk advances once per NEW sample (the head sample repeats
            # the previous packet's tail — bias there is already baked in)
            steps = rng.normal(scale=gyr_bias_walk, size=(len(ts) - 1, 3))
            walk = bias_g + np.concatenate(
                [np.zeros((1, 3)), np.cumsum(steps, axis=0)])
            gyr = gyr + walk
            bias_g = walk[-1]
        groups.append(
            dict(
                pts=pts,
                pt_t=pt_t,
                imu_acc=acc,
                imu_gyr=gyr,
                imu_t=ts - t0,
                scan_beg_abs=t0,
                scan_end_t=scan_T,
                gt_pos=traj.pos(t1),
                gt_rot=traj.rot(t1),
                **({"gt_dynamic": gt_dyn} if gt_dyn is not None else {}),
            )
        )
    return groups
