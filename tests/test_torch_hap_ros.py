"""The Livox HAP deployment (configs/hap_ros.yaml as the benchmark runs
it, lio_bench/configs/hap_ros.json) on the CPU, at the benchmark's small
test sizes (lio_bench/tests/small.py) with its traffic
(lio_bench/traffic/hap_room.json: a 120 x 25 degree field, 200 Hz IMU).

The deployment estimates the lidar-IMU extrinsic online, so every pass of
its update runs the 12-column rows.  Here: the program in float64 agrees
with the benchmark's independent reference (lio_bench/ref) to 1e-8 m and
1e-8 rad in state and extrinsic over scans in which the extrinsic moves;
the benchmark's whole run in float32 is `correct`, and with the step's
update of the extrinsic dropped it is not; the traced step's records
hold a lio.hth and a lio.solve span inside every lio.update.pass; and the
span sites add no device operation to the untraced step.
"""

import contextlib

import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from better_fastlio2_tpu_torch.config import LIOConfig
from better_fastlio2_tpu_torch.core import esikf, measurement
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from lio_bench import check, harness as H
from lio_bench.tests import test_lb_faults as lb_faults
from lio_bench.tests.small import cfg_over, traffic_over
from lio_bench.traffic import gen
from torch_threads import one_torch_thread  # noqa: F401

CELL = "hap_room_scan"
SEED = 2 ** 31 + 1907
NAMES = ("pts", "pt_t", "imu_acc", "imu_gyr", "imu_t", "scan_beg_abs",
         "scan_end_t")
BENCH = H.load_benchmark()


@pytest.fixture(scope="module")
def setup():
    """The cell's configuration and traffic at the small sizes."""
    w = H.cell_of(BENCH, CELL)
    cfg = H.load_config(w["config"])
    cfg_over(cfg)
    spec = gen.load_spec(w["traffic"])
    traffic_over(spec)
    return cfg, gen.Traffic(spec, SEED, extrinsic=gen.extrinsic_of(cfg))


def _feed(pipe, tr, g):
    return pipe.process_scan(*[tr.group(g)[k] for k in NAMES])


def _start(pipe, tr) -> int:
    """Feed the IMU initialisation's groups; the first group after them."""
    g = 0
    while not pipe.inited:
        _feed(pipe, tr, g)
        g += 1
    return g


def test_deployment_estimates_the_extrinsic(setup):
    cfg, tr = setup
    c = LIOConfig.from_dict(cfg)
    assert c.mapping.extrinsic_est_en and not c.ikdtree.single_association
    assert c.mapping.cube_len == 1000 and c.ikdtree.max_iteration == 4
    assert H.cell_of(BENCH, CELL)["chips"] == 1
    imu_rows = [len(tr.group(g)["imu_t"]) for g in range(30)]
    assert min(imu_rows) >= 21 and max(imu_rows) <= c.shapes.n_imu


def test_program_in_float64_agrees_with_the_reference(setup):
    """Eight scans, each a step from a snapshot of the program's state:
    the state the step left and its extrinsic agree with the reference's
    to 1e-8, and the extrinsic moves."""
    cfg, tr = setup
    cfg = {**cfg, "dtype": "float64"}
    pipe = LIOPipeline(LIOConfig.from_dict(cfg), device="cpu")
    g = _start(pipe, tr)
    steps = []
    for j in range(8):
        before = H.snapshot(pipe.ls) if j else None
        _feed(pipe, tr, g + j)
        steps.append({"scans": (j, j + 1), "before": before,
                      "after": H.snapshot(pipe.ls)})
    ref = check.reference_answers(cfg, tr, g, steps, "cpu")
    prog = check.program_answers(np.asarray(pipe.trajectory, np.float64),
                                 steps, cfg)
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
    assert nums["step_map_gap"] == 0.0 and nums["start_map_gap"] == 0.0


@pytest.mark.parametrize("fault", [None, "extrinsic_frozen"])
def test_float32_run_is_correct_and_a_frozen_extrinsic_is_not(monkeypatch,
                                                              fault):
    """The benchmark's own case (lio_bench/tests/test_lb_faults.py) for
    this cell: its whole run at the small sizes is correct, and with the
    step's update of the extrinsic dropped fails the extrinsic's gaps."""
    # the tests' conftest loads JAX for the JAX package's tests; the
    # benchmark's guard against it is not what this test holds
    monkeypatch.setattr(H, "forbidden_modules", lambda: [])
    lb_faults.test_estimating_run_and_frozen_extrinsic(CELL, fault)


def test_traced_passes_hold_hth_and_solve(setup):
    """Every lio.update.pass of a traced scan holds one lio.hth (the K2
    normal equations and the extrinsic's rotation of them) and, after
    it, one lio.solve (the gain and the increment); the two together
    take no more than lio.update."""
    cfg, tr = setup
    pipe = LIOPipeline(LIOConfig.from_dict(cfg), device="cpu", trace=True)
    g = _start(pipe, tr)
    recs = [_feed(pipe, tr, g + j) for j in range(6)]
    for out in recs:
        spans = out["trace"].spans
        passes = [i for i, s in enumerate(spans)
                  if s.name == "lio.update.pass"]
        assert len(passes) == out["iters"] >= 1
        for i in passes:
            kids = {s.name: s for s in spans if s.parent == i}
            hth, solve = kids["lio.hth"], kids["lio.solve"]
            assert spans[i].start_us <= hth.start_us <= hth.end_us \
                <= solve.start_us <= solve.end_us <= spans[i].end_us
        ms = out["trace"].stage_ms(("lio.hth", "lio.solve", "lio.update"))
        assert ms["lio.hth"] + ms["lio.solve"] <= ms["lio.update"]


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not name.startswith("profiler."):  # record_function's own
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


def test_span_sites_add_no_operation_untraced(setup, monkeypatch):
    """Untraced, the step runs the same operations, in the same order and
    to the same bits, with the lio.hth and lio.solve sites as without
    them: a span without a tracer is a host range alone."""
    cfg, tr = setup

    def scans():
        pipe = LIOPipeline(LIOConfig.from_dict(cfg), device="cpu")
        g = _start(pipe, tr)
        _feed(pipe, tr, g)  # the first scan builds the map alone
        with _Ops() as mode:
            for j in range(1, 3):
                _feed(pipe, tr, g + j)
        return mode.ops, np.array(pipe.trajectory)

    ops, traj = scans()
    real = esikf.span
    for mod in (esikf, measurement):
        monkeypatch.setattr(mod, "span", lambda name: (
            real(name) if name not in ("lio.hth", "lio.solve")
            else contextlib.nullcontext()))
    ops_without, traj_without = scans()
    assert len(ops) > 1000 and ops == ops_without
    np.testing.assert_array_equal(traj, traj_without)
