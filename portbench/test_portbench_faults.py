"""The comparison that decides ``correct`` fails what it must: the
program with a fault planted under the timed path, and the control (the
reference one precision down, TF32, in the program's place)."""
from __future__ import annotations

import io

import pytest

from portbench import control, harness
from portbench.faults import Fault

from .conftest import TINY, TRAFFIC, tiny_cell

CELLS = [tiny_cell(name, t) for name in TINY for t in TRAFFIC]


@pytest.mark.parametrize("kind", ["frozen", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(tiny_root, cell, kind):
    out = harness.run(tiny_root, cell, 2 ** 32 + 11, 0.3, False,
                      device="cpu", log=io.StringIO(),
                      wrap=lambda p: Fault(p, kind))
    assert not out["correct"], (kind, out["checks"])
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    for seed in (3, 4, 2 ** 31 + 5):
        r = control.readings(tiny_root, cell, seed, device="cpu")
        assert not r["correct"], r


@pytest.mark.parametrize("cell", CELLS)
def test_late_fault_is_not_correct(tiny_root, cell):
    """Gains off by 1e-3 once a summary holds half its budget: the
    sessions part late, after earlier near ties, and still fail."""
    for seed in (3, 2 ** 31 + 5):
        r = control.readings(tiny_root, cell, seed, late=1e-3,
                             device="cpu")
        assert not r["correct"], r
