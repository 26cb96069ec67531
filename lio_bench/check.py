"""The comparison that decides `correct`: the program's answers against
the plain reference (ref/), and the numbers compared with their limits.

The answers are the poses the program returned for its scans
(`LIOPipeline.trajectory`) and the state its step left: the filter
state, the covariance and the map (each voxel's used places and stored
points, read as values).  They are checked step by step; a step is one
scan.

* The start runs the reference from its own IMU initialisation on the
  same groups, then the first scan (which only builds the map): it
  checks the program's initialisation, propagation and first map.
* Every later step starts the reference from the program's state before
  the scan (harness.snapshot, taken between two calls) and runs the same
  scan: the reference follows the program step by step.  These steps are
  drawn from the seed inside the measured window.

Numbers: of the start, `start_cov_gap` (the largest entry of the
covariance's difference over the reference's largest entry) and
`start_map_gap` (the share of the voxels either side changed on which the
two disagree: places used, or a stored point more than MAP_TOL apart);
over the window's steps the medians of the position, attitude and
covariance gaps, and the map gap of all their changed voxels together;
the medians of the gaps between the lidar-IMU extrinsic the step left
(attitude `step_ext_rot_gap_rad`, translation `step_ext_pos_gap_m`),
which moves where the configuration estimates it; and `report_gap`, the
largest difference between a reported pose and the pose in the state
the step left (exactly 0 for a sound program).  A cell compares the
numbers its limits file names.  The reference runs in float64; the
control (control.py) puts the same reference in the program's place at
TF32 (ref/lio.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ref import geom
from .ref.lio import RefLIO, identity, map_of, tf32
from .ref.pointmap import PointMap

MAP_TOL = 1e-3  # metres between two stored points that agree
NUMBERS = ("start_cov_gap", "start_map_gap", "step_pos_gap_m",
           "step_rot_gap_rad", "step_cov_gap", "step_map_gap",
           "step_ext_rot_gap_rad", "step_ext_pos_gap_m", "report_gap")


def quat_angle(q1, q2) -> float:
    """Angle in radians between two unit quaternions (w, x, y, z)."""
    q1 = np.asarray(q1, np.float64) / np.linalg.norm(q1)
    q2 = np.asarray(q2, np.float64) / np.linalg.norm(q2)
    q2 = q2 if np.dot(q1, q2) >= 0 else -q2
    return 4.0 * math.atan2(np.linalg.norm(q1 - q2), np.linalg.norm(q1 + q2))


def _aligned(maps: list[PointMap]):
    """(used, points, real) of each map over the union of their voxels."""
    keys = torch.unique(torch.cat([m.keys.cpu() for m in maps]))
    out = []
    for m in maps:
        V, B = keys.numel(), m.B
        used = torch.zeros(V, dtype=torch.int64)
        pts = torch.zeros(V, B, 3, dtype=torch.float64)
        real = torch.zeros(V, B, dtype=torch.bool)
        at = torch.searchsorted(keys, m.keys.cpu())
        used[at], pts[at], real[at] = (m.used.cpu(), m.pts.double().cpu(),
                                       m.real.cpu())
        out.append((used, torch.where(real[..., None], pts, 0.0), real))
    return out


def map_gap(before: PointMap, prog: PointMap, ref: PointMap
            ) -> tuple[int, int]:
    """(voxels that either side changed from `before`, those of them on
    which the program and the reference disagree)."""
    (ub, pb, rb), (up, pp, rp), (ur, pr, rr) = _aligned([before, prog, ref])

    def differ(u1, p1, r1, u2, p2, r2, tol):
        return ((u1 != u2) | torch.any(r1 != r2, -1)
                | torch.any(torch.abs(p1 - p2) > tol, -1).any(-1))

    changed = differ(ub, pb, rb, up, pp, rp, 0.0) | \
        differ(ub, pb, rb, ur, pr, rr, 0.0)
    bad = changed & differ(up, pp, rp, ur, pr, rr, MAP_TOL)
    return int(changed.sum()), int(bad.sum())


def cov_gap(P_prog, P_ref) -> float:
    P_ref = P_ref.double().cpu()
    d = torch.max(torch.abs(P_prog.double().cpu() - P_ref))
    return float(d / torch.max(torch.abs(P_ref)))


def reference_answers(cfg: dict, traffic, first_group: int, steps: list,
                      device, control: bool = False) -> dict:
    """The reference's answers for each step ({"scans": (j0, j1),
    "before": the program's snapshot before scan j0, or None for the
    start}): the poses of those scans, the map before them and the state
    after them (covariance, map, and the extrinsic as a quaternion and a
    translation).  control: float32 rounded to TF32 (and TF32 products on
    the card) instead of float64."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = control
    try:
        return _answers(cfg, traffic, first_group, steps, device, control)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _answers(cfg, traffic, first_group, steps, device, control) -> dict:
    dtype, rnd = ((torch.float32, tf32) if control
                  else (torch.float64, identity))
    out, acc_norm = [], None
    for st in steps:
        j0, j1 = st["scans"]
        r = RefLIO(cfg, device, dtype, rnd)
        if st["before"] is None:  # the start: the reference's own init
            g = 0
            while not r.inited:
                r.process(traffic.group(g))
                g += 1
            if g != first_group:
                raise RuntimeError(f"the reference started at group {g}, "
                                   f"the program at {first_group}")
            acc_norm = r.acc_norm
        else:
            if acc_norm is None:
                raise ValueError("the start step comes first")
            prev = traffic.group(first_group + j0 - 1)
            r.load(st["before"], acc_norm,
                   float(prev["scan_beg_abs"]) + float(prev["scan_end_t"]))
        before = r.map.copy()
        poses = []
        for j in range(j0, j1):
            r.process(traffic.group(first_group + j))
            poses.append(r.pose().numpy())
        out.append({"scans": (j0, j1), "poses": np.stack(poses),
                    "before_map": before, "P": r.P, "map": r.map,
                    "ext": _ext(geom.quat_of(r.x.R_il), r.x.t_il),
                    "start": st["before"] is None})
        del r
    return {"acc_norm": acc_norm, "steps": out}


def _ext(q, t) -> np.ndarray:
    """(7,) float64: the extrinsic's quaternion and translation."""
    return torch.cat([q.double().cpu(), t.double().cpu()]).numpy()


def program_answers(traj: np.ndarray, steps: list, cfg: dict) -> dict:
    """The program's answers of the checked steps: the poses it returned
    (`traj`, scan order) and its state after each step, as values."""
    kd, sh = cfg["ikdtree"], cfg["shapes"]
    out = []
    for st in steps:
        a = st["after"]
        left = np.concatenate([a["pos"].double().cpu().numpy(),
                               a["rot"].double().cpu().numpy()])
        out.append({"poses": traj[st["scans"][0]:st["scans"][1]],
                    "left": left, "P": a["P"],
                    "ext": _ext(a["off_r"], a["off_t"]),
                    "map": map_of(a, kd["filter_size_map_min"],
                                  sh.get("map_bucket", 4), torch.float64,
                                  "cpu")})
    return {"steps": out}


def numbers(answers: dict, ref: dict, detail: dict | None = None
            ) -> dict[str, float]:
    """The numbers of `answers` (program_answers, or the control's
    reference_answers) against the reference's; `detail`, when given,
    receives every scan's and step's gaps."""
    pos, rot, cov, mp, rep, ext_rot, ext_pos = [], [], [], [], [], [], []
    start_cov = start_map = 0.0
    for a, r in zip(answers["steps"], ref["steps"]):
        pa = np.asarray(a["poses"], np.float64)
        if "left" in a:
            rep.append(float(np.max(np.abs(pa[-1] - a["left"]))))
        c = cov_gap(a["P"], r["P"])
        m = map_gap(r["before_map"], a["map"], r["map"])
        if r["start"]:
            start_cov, start_map = c, m[1] / max(m[0], 1)
            continue
        pos += [float(v) for v in
                np.linalg.norm(pa[:, :3] - r["poses"][:, :3], axis=1)]
        rot += [quat_angle(x[3:7], y[3:7]) for x, y in zip(pa, r["poses"])]
        cov.append(c)
        mp.append(m)
        ext_rot.append(quat_angle(a["ext"][:4], r["ext"][:4]))
        ext_pos.append(float(np.linalg.norm(a["ext"][4:] - r["ext"][4:])))
    if detail is not None:
        detail.update(start_cov=start_cov, start_map=start_map,
                      step_pos=pos, step_rot=rot, step_cov=cov, step_map=mp,
                      step_ext_rot=ext_rot, step_ext_pos=ext_pos, report=rep)
    med = lambda v: float(np.median(v)) if v else 0.0  # noqa: E731
    out = {"start_cov_gap": start_cov, "start_map_gap": start_map,
           "step_pos_gap_m": med(pos), "step_rot_gap_rad": med(rot),
           "step_cov_gap": med(cov),
           "step_map_gap": sum(b for _, b in mp) / max(sum(c for c, _ in mp),
                                                      1),
           "step_ext_rot_gap_rad": med(ext_rot),
           "step_ext_pos_gap_m": med(ext_pos),
           "report_gap": max(rep) if rep else 0.0}
    for k, v in out.items():
        if not math.isfinite(v):
            out[k] = math.inf  # NaN compares as failed
    return out


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number (those `limits` names) beside its limit, and
    whether every one is within."""
    compared = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in compared.values())
    return ok, compared


__all__ = ["reference_answers", "program_answers", "numbers", "verdict",
           "quat_angle", "map_gap", "cov_gap"]
