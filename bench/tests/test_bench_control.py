"""The control at a size a test run holds: the reference in float8
(``FP8``) put in the program's place, through the harness's own output
check, comes out not correct at the tiny cells' limits where the program
(bf16) comes out correct, at the SMOKE sizes on the CPU; it reads a
wider worst block than the program and keeps the exact bound.  Seeds 2
and 3, whose readings set the tiny limits (``tiny.LIMITS``: over more
seeds the two overlap at these widths).  The readings at the cells' own
sizes come from ``bench/control.py`` on the card (PERF.md)."""

import pytest
import torch

from bench import harness
from bench.reference.common import FP8

CELLS = ["tiny-olmoe.tiny", "tiny-jamba.tiny"]


def _checks(lay, cell, seed):
    """The program's and the control's checks on one window's requests."""
    served = harness.setup(lay, cell, seed, torch.device("cpu"))
    run = harness.window(served, 0.0, False, None, 0.0)
    program = harness.output_check(lay, run)
    return program, harness.output_check(lay, run, control=FP8)


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_wider_than_the_program(tiny_root, cell):
    lay = harness.Layout(tiny_root)
    program, control = [], []
    for seed in (2, 3):
        p, c = _checks(lay, cell, seed)
        program.append(p["logit_rms_worst_block"][0])
        control.append(c["logit_rms_worst_block"][0])
        assert c["excess_gap"][0] <= 0.0
    assert min(control) > 3 * max(program), (program, control)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_limits(tiny_root, cell):
    lay = harness.Layout(tiny_root)
    for seed in (2, 3):
        p, c = _checks(lay, cell, seed)
        assert harness.correct(p), p
        assert not harness.correct(c), c
