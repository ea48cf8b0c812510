"""Tests of the port's benchmark harness. Run from the repo root:

    python -m pytest portbench/tests -q -p no:cacheprovider

on the CPU; the tests marked `card` skip there and run on a machine with
a CUDA device. Nothing here imports JAX.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory):
    """A root whose BENCHMARK.json also holds the cells of held.json, with
    portbench/ linked in: the tests run held cells as the benchmark's."""
    root = tmp_path_factory.mktemp("bench_root")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    held = json.loads((ROOT / "portbench" / "held.json").read_text())
    bench["configs"] += held["configs"]
    bench["workloads"] += held["workloads"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench").symlink_to(ROOT / "portbench")
    return root


# Each cell at a size the CPU holds, in float64: sound runs then read
# round-off, far under every limit, so the faults' readings stand out.
TINY = {
    "qg2_512.p1m": {
        "config": {"dtype": "float64",
                   "Coupled2Config": {"nx": 32, "window_min_np": 64}},
        "traffic": {"n_packets": 512, "steps_per_save": 5,
                    "check": {"within": 3}}},
    "qg2_512.p64k": {
        "config": {"dtype": "float64",
                   "Coupled2Config": {"nx": 32, "window_min_np": 64}},
        "traffic": {"n_packets": 256, "steps_per_save": 5,
                    "check": {"within": 3}}},
    "qg2_512.grad5": {
        "config": {"dtype": "float64",
                   "Coupled2Config": {"nx": 32, "window_min_np": 64}},
        "traffic": {"n_packets": 256, "steps_per_save": 2,
                    "check": {"within": 3}}},
    "sweep_runI.p16k": {
        "config": {"dtype": "float64",
                   "members": [[2.0, 0.6], [16.0, 1.0]],
                   "CoupledConfig": {"nx": 32, "window_min_np": 64}},
        "traffic": {"n_packets": 128, "saves_per_unit": 50,
                    "trace_saves_per_unit": 2, "check": {"within": 2}}},
}
