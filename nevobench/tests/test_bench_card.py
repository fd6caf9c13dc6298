"""On the card, at each cell's own size: the configuration's control (the
next lower precision, control.py) fails the limit of ``correct``, and the
program passes it. Run on the card with

    python -m pytest nevobench/tests -m cuda
"""

import pytest
import torch

from cells import WORKLOADS
from nevobench import control

SEEDS = (4000000001, 4000000002, 4000000003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's own size on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_and_program_passes(card, workload, seed):
    low = control.reading(workload, "control", seed, 1.0, "cuda")
    assert low["gap_max"] > low["limit"], low
    prog = control.reading(workload, "program", seed, 1.0, "cuda")
    assert prog["gap_max"] <= prog["limit"], prog
