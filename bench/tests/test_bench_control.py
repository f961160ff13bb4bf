"""On the card, at each cell's own size and traffic: the sound program's
first three steps are within every limit of the cell, and the control (the
plain reference computed in TF32, the precision below the configurations'
float32, put in the program's place) is not.  ``bench/calibrate.py`` reads
the same at many seeds; these tests keep the check alive (about two
minutes on one H100)."""

import gc

import pytest
import torch

from bench import compare, harness

CELLS = ["olmo-1b.l8.b4k", "granite-moe-1b-a400m.l12.b4k", "olmo-1b.l8.b1k",
         "olmo-1b.l8.b1k.int8ef"]


@pytest.mark.parametrize("name", CELLS)
def test_program_within_limits(name, cuda):
    cell = harness.load_cell(name)
    prog = harness.Program(cell, 2**31 + 101, cuda, "triton")
    got = prog.check_steps()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    want = harness.reference_readings(cell, 2**31 + 101, cuda)
    checks = compare.checks(compare.numbers(got, want), cell.limits)
    assert compare.passes(checks), checks


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, cuda):
    cell = harness.load_cell(name)
    want = harness.reference_readings(cell, 2**31 + 102, cuda)
    control = harness.reference_readings(cell, 2**31 + 102, cuda, tf32=True)
    checks = compare.checks(compare.numbers(control, want), cell.limits)
    assert not compare.passes(checks), checks
