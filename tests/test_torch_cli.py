"""CLI tests of `python -m swraytracing_torch` (the counterpart of
tests/test_cli.py): the subcommands, a CPU run in float64 and its
analysis, and the failures that name what is missing."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swraytracing_torch.io import binio, runmeta

REPO = Path(__file__).resolve().parents[1]


def _run(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "swraytracing_torch", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout, env=env)


def test_cli_help_lists_subcommands():
    r = _run("--help")
    assert r.returncode == 0
    for sub in ("qgsw", "qg2", "sweep", "analyze"):
        assert sub in r.stdout
    r = _run("qg2", "--help")
    assert r.returncode == 0
    assert "--device" in r.stdout and "--dtype" in r.stdout
    assert "--platform" not in r.stdout


def test_cli_qgsw_on_cpu_then_analyze(tmp_path):
    out = tmp_path / "cli-run"
    r = _run("qgsw", "--nx", "32", "--packets", "4", "--t-fr-days", "30",
             "--delay-days", "0.1", "--out", str(out), "--max-steps", "60",
             "--device", "cpu", "--dtype", "float64")
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "run.log").exists() and (out / "packet_x.bin").exists()
    assert runmeta.parse_run_log(out / "run.log")["n_packets"] == 4
    x = binio.read_field(str(out / "packet_x"), 4, 2, frames=list(range(
        1, binio.frame_count(str(out / "packet_x"), 4, 2) + 1)))
    assert x.shape == (4, 2, 21) and np.isfinite(x).all()
    r2 = _run("analyze", str(out), "--out", str(tmp_path / "figs"))
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "mean omega/f" in r2.stdout
    figs = sorted(p.name for p in (tmp_path / "figs").glob("*.png"))
    assert figs == ["energy_vs_omega.png", "trajectories.png"]


def test_cli_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    r = _run("qg2", "--nx", "16", "--packets", "4", "--out",
             str(tmp_path / "x"), "--max-steps", "5")
    assert r.returncode != 0
    assert "no CUDA device is available; pass device='cpu'" in r.stderr
    assert not (tmp_path / "x").exists()


def test_cli_sweep_ensemble_names_its_roadmap_item(tmp_path):
    """`sweep --ensemble` runs (ROADMAP A11 is ported): one program for
    the 20 members, each with its run directory of omega histograms."""
    r = _run("sweep", "--ensemble", "--nx", "16", "--packets", "4",
             "--t-fr-days", "30", "--delay-days", "0.1", "--max-steps", "10",
             "--base-dir", str(tmp_path / "sw"), "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NotImplementedError" not in r.stderr
    runs = sorted((tmp_path / "sw").glob("run-*"))
    assert len(runs) == 20
    assert all((run / "omega_hist.bin").exists() for run in runs)
