"""A run with the program's timed path broken underneath comes out not
correct: the harness's whole run (set-up, window, the reference's
judgement) on the CPU at small sizes, with each fault a cell on one chip
can have planted under the step (faults.py).  A sound run comes out
correct under the same limits."""

import time

import pytest
import torch

from lio_bench import harness as H
from lio_bench import run
from lio_bench.faults import FAULTS

from .small import cfg_over, traffic_over

BENCH = H.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, fault=None, seconds=2.0):
    return run.run_cell(BENCH, H.cell_of(BENCH, cell), 2 ** 31 + 5, seconds,
                        False, time.perf_counter(), device="cpu",
                        cfg_over=cfg_over, traffic_over=traffic_over,
                        fault=FAULTS[fault] if fault else None)


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
