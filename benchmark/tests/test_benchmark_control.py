"""The control, the reference in TF32 put in the program's place, comes out not correct.

On the CPU at toy size (TF32 is emulated by rounding the operands of every
matrix product, so it computes the same here and on the card), and on the
card (marker ``card``) at the cells' own widths with one fragment or pass.
"""

import math
import shutil
import tempfile
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests import toy


def _control_checks(cell_name, device, overrides, seed):
    cell = harness.load_cell(cell_name)
    for k, v in (overrides or {}).items():
        cell[k] = v if k == "limits" else {**cell[k], **v}
    entry = harness.load_entry(cell["entry"])
    workdir = Path(tempfile.mkdtemp(prefix="control-"))
    try:
        state = entry.setup(cell, seed, device, workdir)
        verdicts = entry.judge(state, entry.control(state))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    attempted, failed, checks = harness.judge_summary(verdicts, cell["limits"])
    return attempted, failed, checks


@pytest.mark.parametrize("cell", sorted(toy.CELLS))
def test_the_control_is_not_correct_at_toy_size(cell):
    attempted, failed, checks = _control_checks(cell, "cpu", toy.CELLS[cell], toy.SEED)
    assert attempted >= 1 and failed == attempted, checks


@pytest.mark.card
@pytest.mark.parametrize("cell", ["odometry.livingroom_full_640", "register.livingroom_full_640"])
def test_the_control_is_not_correct_on_the_card(cell, card):
    attempted, failed, checks = _control_checks(cell, "cuda", None, toy.SEED)
    assert attempted >= 1 and failed == attempted, checks
    assert any(v["value"] == "inf" or (v["value"] > v["limit"] and math.isfinite(v["value"]))
               for v in checks.values())
