"""Each plain reference against the program's stacked DecentLaM step at a
small size on the CPU: the readings of the first three steps agree within
1e-4, and each fault planted in the reference reads far above that."""

import math

import pytest
import torch

from bench import compare, harness
from bench.tests.tiny import tiny_cell

CELLS = ["olmo-1b.l8.b4k", "granite-moe-1b-a400m.l12.b4k", "olmo-1b.l8.b1k.int8ef"]
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_program(name):
    cell = tiny_cell(name)
    prog = harness.Program(cell, 2**31 + 5, CPU, "torch")
    got = prog.check_steps()
    want = harness.reference_readings(cell, 2**31 + 5, CPU)
    numbers = compare.numbers(got, want)
    assert set(cell.limits) <= set(numbers)
    assert all(v < 1e-4 for v in numbers.values()), numbers
    assert len(got["losses"]) == harness.CHECK_STEPS and all(map(math.isfinite, got["losses"]))


@pytest.mark.parametrize("fault", ["half_batch", "no_exchange"])
@pytest.mark.parametrize("name", CELLS)
def test_reference_faults_read_high(name, fault):
    cell = tiny_cell(name)
    want = harness.reference_readings(cell, 7, CPU)
    bad = harness.reference_readings(cell, 7, CPU, fault=fault)
    numbers = compare.numbers(bad, want)
    assert max(numbers.values()) > 1e-2, numbers
