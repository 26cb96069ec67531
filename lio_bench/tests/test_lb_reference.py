"""The reference against itself in float64, and against the program run
in float64 on the CPU at small sizes: two runs agree bit for bit; a run
started from another run's state, written as the program's state is,
goes on as the run it was taken from; the program, which follows the
same semantics in other code, agrees with it to rounding, with the
extrinsic fixed and estimated; and the cells' reference answers stay
what they were before the reference learned to estimate the extrinsic."""

import hashlib
import json

import numpy as np
import pytest
import torch

from lio_bench import check, harness as H
from lio_bench.ref import geom
from lio_bench.ref.lio import RefLIO
from lio_bench.traffic import gen

from .small import cfg_over, traffic_over

CELLS = [w["name"] for w in H.load_benchmark()["workloads"]]


def _setup(cell):
    w = H.cell_of(H.load_benchmark(), cell)
    cfg = H.load_config(w["config"])
    cfg_over(cfg)
    spec = gen.load_spec(w["traffic"])
    traffic_over(spec)
    return cfg, gen.Traffic(spec, 2 ** 32 + 17,
                            extrinsic=gen.extrinsic_of(cfg))


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _as_program_state(r: RefLIO) -> dict:
    """The reference's state in the program's snapshot form: quaternions,
    and the map as live packed keys, counts and points (empty places
    hold the program's marker)."""
    m, x = r.map, r.x
    from lio_bench.ref.pointmap import ijk_of

    ijk = ijk_of(m.keys)
    key = ((ijk[:, 0] & 1023) | ((ijk[:, 1] & 1023) << 10)
           | ((ijk[:, 2] & 1023) << 20) | (1 << 30)).to(torch.int32)
    pts = torch.where(m.real[..., None], m.pts, 1e9)
    box = r.cube
    return {"pos": x.pos, "rot": geom.quat_of(x.R),
            "off_r": geom.quat_of(x.R_il), "off_t": x.t_il, "vel": x.vel,
            "bg": x.bg, "ba": x.ba, "grav": x.grav, "P": r.P,
            "cube_lo": box[0], "cube_hi": box[1],
            "cube_init": torch.tensor(True), "last_acc_w": r.last_acc_w,
            "last_gyr_b": r.last_gyr_b,
            "ekf_inited": torch.tensor(r.ekf_inited), "key": key,
            "count": m.used.to(torch.int32), "points": pts}


def _run(cfg, tr, K, keep=None):
    r = RefLIO(cfg, "cpu")
    g = 0
    while not r.inited:
        r.process(tr.group(g))
        g += 1
    poses, state = [], None
    for j in range(K):
        if j == keep:
            state = _as_program_state(r)
        r.process(tr.group(g + j))
        poses.append(r.pose().numpy())
    return g, np.stack(poses), state, r


@pytest.mark.parametrize("cell", CELLS)
def test_reference_repeats_and_resumes(cell):
    cfg, tr = _setup(cell)
    K = 10
    g, a, st, r = _run(cfg, tr, K, keep=K - 3)
    _, b, _, _ = _run(cfg, tr, K)
    np.testing.assert_array_equal(a, b)
    steps = [{"scans": (0, 3), "before": None},
             {"scans": (K - 3, K), "before": st}]
    out = check.reference_answers(cfg, tr, g, steps, "cpu")
    np.testing.assert_array_equal(out["steps"][0]["poses"], a[:3])
    # resumed through the quaternion form of its state: to rounding
    np.testing.assert_allclose(out["steps"][1]["poses"], a[K - 3:K],
                               atol=1e-9)
    assert out["acc_norm"] == r.acc_norm
    ans = {"steps": [{"poses": s["poses"], "P": s["P"], "map": s["map"],
                      "ext": s["ext"]} for s in out["steps"]]}
    nums = check.numbers(ans, out)
    assert set(nums) == set(check.NUMBERS)
    assert all(v == 0.0 for v in nums.values())
    ok, compared = check.verdict(nums, {k: 0.0 for k in check.NUMBERS})
    assert ok and json.dumps(compared)


def _program_steps(cfg, tr, K):
    """The program in float64 on the CPU over K scans, each a step from a
    snapshot of its state; returns (steps, the reference's answers, the
    program's answers)."""
    from better_fastlio2_tpu_torch.config import LIOConfig
    from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline

    cfg["dtype"] = "float64"
    pipe = LIOPipeline(LIOConfig.from_dict(cfg), device="cpu")
    names = ("pts", "pt_t", "imu_acc", "imu_gyr", "imu_t", "scan_beg_abs",
             "scan_end_t")
    g = 0
    while not pipe.inited:
        pipe.process_scan(*[tr.group(g)[k] for k in names])
        g += 1
    steps = []
    for j in range(K):
        before = H.snapshot(pipe.ls) if j else None
        pipe.process_scan(*[tr.group(g + j)[k] for k in names])
        steps.append({"scans": (j, j + 1), "before": before,
                      "after": H.snapshot(pipe.ls)})
    ref = check.reference_answers(cfg, tr, g, steps, "cpu")
    traj = np.asarray(pipe.trajectory, np.float64)
    return steps, ref, check.program_answers(traj, steps, cfg)


@pytest.mark.parametrize("cell", CELLS)
def test_program_in_float64_agrees_with_the_reference(cell):
    cfg, tr = _setup(cell)
    steps, ref, prog = _program_steps(cfg, tr, 8)
    detail = {}
    nums = check.numbers(prog, ref, detail)
    # the program reports its pose in float32
    assert max(detail["step_pos"]) < 1e-6, detail
    assert max(detail["step_rot"]) < 1e-6, detail
    assert max(detail["step_cov"] + [detail["start_cov"]]) < 1e-6, detail
    assert nums["step_map_gap"] == 0.0 and nums["start_map_gap"] == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_program_in_float64_agrees_estimating_the_extrinsic(cell):
    """With extrinsic_est_en on, the reference's 12-column rows move the
    extrinsic as the program does: every step's state and extrinsic agree
    to 1e-8, over scans in which the extrinsic moves."""
    cfg, tr = _setup(cell)
    cfg["mapping"]["extrinsic_est_en"] = True
    steps, ref, prog = _program_steps(cfg, tr, 8)
    moved = [check.quat_angle(st["before"]["off_r"], st["after"]["off_r"])
             for st in steps[1:]]
    assert max(moved) > 1e-6, moved
    for a, r in zip(prog["steps"][1:], ref["steps"][1:]):
        assert np.linalg.norm(a["left"][:3] - r["poses"][-1][:3]) < 1e-8
        assert check.quat_angle(a["left"][3:], r["poses"][-1][3:]) < 1e-8
        assert check.quat_angle(a["ext"][:4], r["ext"][:4]) < 1e-8
        assert np.linalg.norm(a["ext"][4:] - r["ext"][4:]) < 1e-8
    nums = check.numbers(prog, ref)
    assert nums["step_ext_rot_gap_rad"] < 1e-8
    assert nums["step_ext_pos_gap_m"] < 1e-8


# sha256 of the reference's poses over ten scans and its covariance and
# map after them (small sizes, seed 2**32 + 17), taken with the reference
# that refused extrinsic estimation
REF_DIGEST = {
    "hdl64_street_scan":
        "08b60a27ea8330228b13ac4558f3802cbadf6416f0e39ec78333dbde242901ea",
    "vlp16_room_scan":
        "c59239feff39237a0ea87f969801067e38e2d4ff75fb64b594b026fe1de4fdd1",
}


def _digest(h, v):
    a = np.ascontiguousarray(np.asarray(v))
    h.update(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())


@pytest.mark.parametrize("cell", CELLS)
def test_reference_answers_unchanged(cell):
    cfg, tr = _setup(cell)
    _, poses, _, r = _run(cfg, tr, 10)
    h = hashlib.sha256()
    for p in poses:
        _digest(h, p)
    m = r.map
    for v in (r.P, m.keys, m.used, m.pts, m.real):
        _digest(h, v.numpy())
    assert h.hexdigest() == REF_DIGEST[cell]
