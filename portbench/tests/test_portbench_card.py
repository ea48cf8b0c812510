"""On a machine with a CUDA device: every cell of BENCHMARK.json through
the command the benchmark runs, a short window each, untraced and
traced: one JSON line, `correct`, the cell's metrics and the device."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

from portbench import core

CELLS = [w["name"] for w in core.load_json(ROOT / "BENCHMARK.json")
         ["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483651", "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    bench = core.load_json(ROOT / "BENCHMARK.json")
    want = {m["name"] for m in core.cell_metrics(bench, cell, bool(trace))}
    assert set(r["metrics"]) == want
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
