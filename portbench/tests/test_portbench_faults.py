"""The harness's comparison catches the faults a cell can have
(faults.py): with the look for a card skipped and the timed path broken
underneath, a run of each cell comes out not correct; `planted` undoes
what it patched."""

import pytest

from conftest import TINY

from portbench import core, faults

CELLS = sorted(TINY)


def run(root, cell):
    return core.run_cell(root, cell, 2 ** 31 + 99, 0.2, False, "cpu", 0.0,
                         overrides=TINY[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench_root, cell):
    r = run(bench_root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(bench_root, cell, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = run(bench_root, cell)
    assert not r["correct"], r["checks"]


def test_planted_fault_is_undone():
    from swraytracing_torch.ops import march_window as mw
    before = mw.fused_march_gathered
    with faults.planted("half"):
        assert mw.fused_march_gathered is not before
    assert mw.fused_march_gathered is before
