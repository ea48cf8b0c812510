"""Checkpoints, resume, init_from and the PV series of the ensemble sweep
of swraytracing_torch against swraytracing_tpu's
(tests/test_drivers.py::test_run_sweep_ensemble_pv_series_and_init_from):
the same arguments go to both packages (the port on the CPU in float64,
JAX in x64); run directories are compared file by file and ensemble
checkpoints load across the packages in both directions."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from swraytracing_tpu import drivers as jdr
from swraytracing_torch import drivers as tdr
from swraytracing_torch.io import binio, runmeta
from swraytracing_torch.io.checkpoint import latest_checkpoint

from test_torch_ensemble_drivers import ENS, PORT, SWEEP, assert_same_sweep

# a PV frame and a checkpoint every 2 chunks of 50 steps
SERIES = dict(checkpoint_every=2, pv_every=2)


@pytest.fixture(scope="module")
def first(tmp_path_factory):
    """100 steps (2 chunks, a checkpoint after the second) by both
    packages."""
    tmp = tmp_path_factory.mktemp("ensemble")
    jdir, tdir = tmp / "jax-100", tmp / "torch-100"
    jdr.run_sweep(SWEEP, base_dir=str(jdir), max_steps=100, **ENS, **SERIES)
    tdr.run_sweep(SWEEP, base_dir=str(tdir), max_steps=100, **ENS, **SERIES,
                  **PORT)
    return tmp, jdir, tdir


def test_ensemble_pv_series_and_checkpoints_match_jax(first):
    """Equal directories, PV series included; the checkpoints hold the
    same leaves: leaf_3 the members' t, (E,) float64, leaf_4 their step
    counts, int32."""
    _, jdir, tdir = first
    assert_same_sweep(tdir, jdir)
    for i in range(len(SWEEP)):
        tpv = binio.read_field(str(tdir / f"run-{i}" / "pv_time"))
        assert len(tpv) >= 2 and (np.diff(tpv) > 0).all()
    jck = latest_checkpoint(jdir, prefix="ckpt-g0")
    tck = latest_checkpoint(tdir, prefix="ckpt-g0")
    assert Path(jck).name == Path(tck).name == "ckpt-g0_000000000002.npz"
    with np.load(tck) as t, np.load(jck) as j:
        assert sorted(t.files) == sorted(j.files)
        assert t["leaf_3"].shape == (2,) and t["leaf_3"].dtype == np.float64
        assert t["leaf_4"].dtype == np.int32
        np.testing.assert_array_equal(t["leaf_4"], j["leaf_4"])
        np.testing.assert_allclose(t["leaf_3"], j["leaf_3"], rtol=1e-14)
        for leaf in ("leaf_5", "leaf_6", "leaf_7"):   # packets, fields
            assert t[leaf].shape == j[leaf].shape, leaf
            np.testing.assert_allclose(t[leaf], j[leaf], atol=1e-10,
                                       err_msg=leaf)


def test_ensemble_resume_from_either_package(first):
    """The port resumes to 150 steps from its own checkpoint after 100 and
    from JAX's: both directories equal the port's uninterrupted 150-step
    sweep."""
    tmp, jdir, tdir = first
    ref = tmp / "torch-150"
    want, _ = tdr.run_sweep(SWEEP, base_dir=str(ref), max_steps=150, **ENS,
                            **SERIES, **PORT)
    for src in (tdir, jdir):
        d = tmp / f"resumed-{src.name}"
        shutil.copytree(src, d)
        carry, _ = tdr.run_sweep(SWEEP, base_dir=str(d), max_steps=150,
                                 resume=True, **ENS, **SERIES, **PORT)
        assert (carry.flow_state.step == 150).all()
        assert_same_sweep(d, ref)
        np.testing.assert_allclose(carry.packet_x.numpy(),
                                   want.packet_x.numpy(), atol=1e-10)


def test_ensemble_init_from_across_packages(first):
    """A log-binned continuation seeded by init_from: the port's from JAX's
    checkpoint writes the directories of JAX's from the port's."""
    tmp, jdir, tdir = first
    cont = dict(max_steps=120, omega_hist_log=True,
                omega_hist_max_factor=64.0, pv_every=2)
    jck = latest_checkpoint(jdir, prefix="ckpt-g0")
    tck = latest_checkpoint(tdir, prefix="ckpt-g0")
    jax_from_port = tmp / "jax-from-torch"
    jdr.run_sweep(SWEEP, base_dir=str(jax_from_port), init_from=tck, **ENS,
                  **cont)
    port_from_jax = tmp / "torch-from-jax"
    tdr.run_sweep(SWEEP, base_dir=str(port_from_jax), init_from=jck, **ENS,
                  **cont, **PORT)
    assert_same_sweep(port_from_jax, jax_from_port)
    with np.load(jck) as j:
        ck_t = j["leaf_3"]
    for i in range(len(SWEEP)):
        p = runmeta.RunDir(port_from_jax / f"run-{i}").read_params()
        assert p["omega_hist_log"] and p["t_seed"] == ck_t[i]
        t = binio.read_field(str(port_from_jax / f"run-{i}" / "packet_time"))
        assert t[0] == ck_t[i] and t[-1] > t[0]
