"""A run with the program's timed path broken underneath comes out not
correct: the harness's whole run (set-up, window, the reference's
judgement) on the CPU at small sizes, with each fault a cell on one chip
can have planted under the step (faults.py).  A sound run comes out
correct under the same limits.  So too under each cell's configuration
with extrinsic estimation on, where a frozen extrinsic has to fail the
extrinsic's gaps."""

import time

import pytest
import torch

from lio_bench import harness as H
from lio_bench import run
from lio_bench.faults import ESTIMATION_FAULTS, FAULTS

from .small import cfg_over, traffic_over

BENCH = H.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, fault=None, seconds=2.0, cfg=cfg_over, limits_over=None):
    return run.run_cell(BENCH, H.cell_of(BENCH, cell), 2 ** 31 + 5, seconds,
                        False, time.perf_counter(), device="cpu",
                        cfg_over=cfg, traffic_over=traffic_over,
                        fault=fault and {**FAULTS, **ESTIMATION_FAULTS}[fault],
                        limits_over=limits_over)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault):
    line = _run(cell, fault)
    over = [k for k, v in line["compared"].items()
            if v["value"] > v["limit"]]
    assert not line["correct"], line["compared"]
    assert over


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_line(cell):
    line = _run(cell)
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "compared"}
    assert list(line)[-1] == "compared"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == set(H.declared(BENCH, cell, False))


# The extrinsic's limits at these sizes on the CPU, where sound runs read
# up to 9.0e-6 rad and 7.5e-6 m and the frozen extrinsic from 6.3e-4 rad
# and 3.7e-4 m; a cell that estimates the extrinsic sets its own on the
# card.
EXT_LIMITS = {"step_ext_rot_gap_rad": 1e-4, "step_ext_pos_gap_m": 1e-4}


def _estimating(d):
    cfg_over(d)
    d["mapping"]["extrinsic_est_en"] = True


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, *sorted(ESTIMATION_FAULTS)])
def test_estimating_run_and_frozen_extrinsic(cell, fault):
    line = _run(cell, fault, cfg=_estimating,
                limits_over=lambda lim: lim.update(EXT_LIMITS))
    over = {k for k, v in line["compared"].items() if v["value"] > v["limit"]}
    assert set(EXT_LIMITS) <= set(line["compared"])
    if fault is None:
        assert line["correct"] and not over, line["compared"]
    else:
        assert not line["correct"] and over & set(EXT_LIMITS), \
            line["compared"]
