"""The control: the reference in bfloat16 storage (float32 arithmetic),
put in the program's place from the same sampled inputs, fails at least
one of each cell's limits, while the program at the same size stays
inside all of them. On the chip the same readings come from
calibrate.py at the cells' own sizes (PERF.md gives them)."""

import pytest

from conftest import TINY

from portbench import calibrate, core


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails_a_limit(bench_root, cell):
    limits = core.find_cell(bench_root, cell)[-1]
    r = calibrate.readings(cell, 2 ** 31 + 5, 0.2, True, "cpu",
                           overrides=TINY[cell], root=bench_root)
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r
