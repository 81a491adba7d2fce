"""The control of each cell's comparison, on the card at the cell's own
size: the program with its own path in the next precision down switched on
(the configuration's `control_lane`) has to read not correct against the
cell's limits, and the program as configured correct, on one seed each.
Skips without a CUDA device; on the chip:

    python3 -m pytest -p no:cacheprovider --noconftest -m cuda \\
        benchmark/tests/test_benchmark_control.py
"""

import pytest
import torch

from benchmark import control, harness

CELLS = ("3b-clip1080", "7b-throughput-image1080")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(card, cell):
    c = harness.load_cell(cell)
    assert c.limits, f"{cell} has no limits"
    assert control.readings(c, 20231, "control", card)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_reads_correct(card, cell):
    c = harness.load_cell(cell)
    assert control.readings(c, 20232, "program", card)["correct"] is True
