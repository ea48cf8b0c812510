"""The ensemble sweep driver of swraytracing_torch
(`run_sweep(ensemble=True)`) and its CLI against swraytracing_tpu's, in the
configurations of tests/test_drivers.py: the same arguments go to both
packages (the port on the CPU in float64, JAX in x64) and the run
directories are compared file by file. Checkpoints, resume and init_from:
tests/test_torch_ensemble_resume.py."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from swraytracing_tpu import drivers as jdr
from swraytracing_torch import drivers as tdr
from swraytracing_torch.analysis import spectra
from swraytracing_torch.io import binio, runmeta

from test_torch_drivers import assert_same_run
import torch_parity  # noqa: F401  (one torch thread per worker)

PORT = dict(device="cpu", dtype=torch.float64)
SWEEP = [(2.0, 0.3), (4.0, 0.6)]
# tests/test_drivers.py's ensemble configuration, with 47 bins where it
# has 48: the packets start on the ring omega = w0 f, which an even number
# of linear bins on [0, 2 w0 f] puts exactly on an edge, where the last bit
# of omega picks the bin, and XLA on the CPU contracts kx*kx + ky*ky into
# a fused multiply-add that PyTorch does not form
ENS = dict(ensemble=True, nx=32, Npackets=16, T_Fr_days=30.0,
           packet_delay_days=0.1, omega_hist_bins=47, window_min_np=1,
           verbose=False)
REPO = Path(__file__).resolve().parents[1]


def _both(tmp, name, **kw):
    """The same sweep by both packages: (jax dir, port dir, port result)."""
    jdir, tdir = tmp / f"jax-{name}", tmp / f"torch-{name}"
    jdr.run_sweep(SWEEP, base_dir=str(jdir), **ENS, **kw)
    res = tdr.run_sweep(SWEEP, base_dir=str(tdir), **ENS, **kw, **PORT)
    return jdir, tdir, res


def assert_same_sweep(tdir, jdir):
    """The base directory (params.json, metrics.jsonl's record) and every
    member's run directory, file by file."""
    assert_same_run(tdir, jdir)
    for i in range(len(SWEEP)):
        assert_same_run(tdir / f"run-{i}", jdir / f"run-{i}")


def test_ensemble_sweep_matches_jax(tmp_path):
    """tests/test_drivers.py::test_run_sweep_ensemble_writes_member_dirs:
    member 1 freezes at T=0.15 and stops writing frames; the directories
    equal JAX's (log bins: tests/test_torch_ensemble_resume.py)."""
    jdir, tdir, (carry, rds) = _both(
        tmp_path, "sweep", max_steps=100,
        T_member=lambda w0, ug: 0.15 if w0 == 4.0 else 1e9)
    assert_same_sweep(tdir, jdir)
    assert carry.packet_x.shape == (2, 2, 16)
    assert carry.overflow is not None and int(carry.overflow.max()) == 0
    for i, (w0, ug) in enumerate(SWEEP):
        counts, edges, t, params = spectra.load_omega_hist(tdir / f"run-{i}")
        assert (params["near_inertial_factor"], params["U_g"]) == (w0, ug)
        assert (counts.sum(axis=1) == 16).all()
    t0 = binio.read_field(str(tdir / "run-0" / "packet_time"))
    t1 = binio.read_field(str(tdir / "run-1" / "packet_time"))
    assert len(t1) < len(t0) and 0.15 <= t1[-1] < 0.4
    assert [str(rd.path) for rd in rds] == [str(tdir / f"run-{i}")
                                            for i in range(2)]
    metrics = runmeta.RunDir(tdir).read_metrics()
    assert [m["members_live"] for m in metrics] == [1, 1]
    assert all(m["packet_steps_per_sec"] > 0 for m in metrics)


def test_ensemble_margin_overflow_retries_like_jax(tmp_path):
    """A margin too narrow for the packets' drift: the chunk is discarded,
    the margin widened and the chunk re-run, in both packages alike."""
    jdir, tdir, (carry, _) = _both(
        tmp_path, "margin", max_steps=50, march_margin=1, Cg=30.0,
        T_member=lambda w0, ug: 1e9)
    assert_same_sweep(tdir, jdir)
    metrics = runmeta.RunDir(tdir).read_metrics()
    assert any(m.get("march_overflow") for m in metrics)
    assert int(carry.overflow.max()) == 0


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "swraytracing_torch", *args], cwd=REPO,
        capture_output=True, text=True, timeout=600, env=env)


def test_cli_ensemble_sweep_writes_member_dirs(tmp_path):
    """tests/test_cli.py::test_cli_ensemble_sweep: 20 member directories
    with histogram frames and reference-format logs."""
    base = tmp_path / "cli-sweep"
    r = _cli("sweep", "--ensemble", "--nx", "32", "--packets", "16",
             "--t-fr-days", "30", "--delay-days", "0.1", "--base-dir",
             str(base), "--max-steps", "60", "--hist-bins", "32",
             "--device", "cpu", "--dtype", "float64")
    assert r.returncode == 0, r.stderr[-2000:]
    runs = sorted(base.glob("run-*"))
    assert len(runs) == 20
    for run in runs:
        assert (run / "omega_hist.bin").exists()
        assert runmeta.parse_run_log(run / "run.log")["nx"] == 32
    counts, _, t, _ = spectra.load_omega_hist(base / "run-19")
    assert counts.shape == (len(t), 33) and (counts.sum(axis=1) == 16).all()


def test_cli_ensemble_takes_qgsw_only(tmp_path):
    r = _cli("sweep", "--ensemble", "--model", "qg2", "--nx", "16",
             "--base-dir", str(tmp_path / "sw"), "--device", "cpu")
    assert r.returncode == 2
    assert ("--ensemble supports only --model qgsw (the vmapped ensemble "
            "runs the one-layer physics); run a qg2 sweep without "
            "--ensemble") in r.stderr
    assert not (tmp_path / "sw").exists()
