"""The control on the card: the reference at the precision below the
configuration's float32 (TF32 products), put in the program's place,
comes out not correct where the program comes out correct.  Runs the
cell at its own size with a short window."""

import time

import pytest

from lio_bench import harness as H
from lio_bench import run

BENCH = H.load_benchmark()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_where_the_program_passes(card, cell):
    line = run.run_cell(BENCH, H.cell_of(BENCH, cell), 2 ** 31 + 99, 3.0,
                        False, time.perf_counter(), control=True)
    limits = H.load_limits(cell)
    assert line["correct"], line["compared"]
    ctl = line["readings"]["control"]
    assert any(ctl[k] > limits[k] for k in limits), ctl
