"""Packets and ensemble members of swraytracing_torch sharded over two
ranks (parallel/sharding.py, drivers.run_sweep(mesh=...),
parallel/scaling.py) against the port on one rank and against
swraytracing_tpu's sharded runs on the 8 virtual CPU devices
(tests/test_parallel.py, tests/test_drivers.py:186-207).

The ranks are two processes of a gloo group on the CPU
(tests/torch_ranks.py, suite "parallel"), started once for the module;
the references are computed in this process while they run. Two ranks
against one: bit for bit (a packet's arithmetic does not depend on the
other packets). The port against JAX: packets atol 1e-10, the spectrum
rtol 1e-10; omega counts exactly."""

import functools
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

from swraytracing_tpu import drivers as jdr
from swraytracing_tpu.models import coupled as jcoupled
from swraytracing_tpu.parallel import sharding as jshd
from swraytracing_torch import drivers as tdr
from swraytracing_torch.io.checkpoint import latest_checkpoint
from swraytracing_torch.models.coupled import (CoupledConfig,
                                               run_coupled_chunk,
                                               setup_coupled)

import torch_parity  # noqa: F401  (one torch thread per worker)
import torch_ranks as tr

ATOL, RTOL_QK = 1e-10, 1e-10
# members split over ranks against all members on one rank: a rank's flow
# runs as a batch of its own members, and the CPU's FFT rounds a transform
# by its place in the batch, so states agree to round-off, not bit for bit
ATOL_MEMBERS = 1e-12
EXACT = ("omega_hist", "packet_time", "packet_snap_time", "pv_time")
CLOSE = ("packet_snap_x", "packet_snap_k", "pv")


def jax_chunk_on_8_shards(cfg_kw, n_saves):
    """tests/test_parallel.py: the chunk with the packets on 8 shards."""
    cfg = jcoupled.CoupledConfig(**cfg_kw)
    s, carry = jcoupled.setup_coupled(cfg)
    mesh = jshd.make_mesh(ensemble=1)
    carry = carry.replace(
        packet_x=jax.device_put(carry.packet_x, jshd.packet_sharding(mesh)),
        packet_k=jax.device_put(carry.packet_k, jshd.packet_sharding(mesh)),
        prev_fields=jax.device_put(carry.prev_fields, jshd.replicated(mesh)))
    c, (px, pk, _) = jax.jit(functools.partial(
        jcoupled.run_coupled_chunk, s=s, cfg=cfg, n_saves=n_saves))(carry)
    return dict(x=np.asarray(c.packet_x), k=np.asarray(c.packet_k),
                px=np.asarray(px), pk=np.asarray(pk),
                qk=np.asarray(c.flow_state.qk))


def port_chunk(cfg_kw, n_saves):
    cfg = CoupledConfig(**cfg_kw)
    s, carry = setup_coupled(cfg, **tr.CPU)
    c, (px, pk, _) = run_coupled_chunk(carry, s, cfg, n_saves)
    return tr.arrays(x=c.packet_x, k=c.packet_k, px=px, pk=pk,
                     qk=c.flow_state.qk,
                     overflow=-1 if c.overflow is None else int(c.overflow))


def port_sweep(base, **kw):
    carry, _ = tdr.run_sweep(tr.SWEEP, base_dir=str(base), **kw, **tr.CPU)
    return tr.arrays(x=carry.packet_x, k=carry.packet_k,
                     qk=carry.flow_state.qk, t=carry.flow_state.t,
                     step=carry.flow_state.step, overflow=carry.overflow)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    procs, out = tr.spawn("parallel", 2, tmp)
    ref = {"chunk": {}, "jax": {}}
    for name, (cfg_kw, n_saves) in tr.CHUNKS.items():
        ref["chunk"][name] = port_chunk(cfg_kw, n_saves)
        ref["jax"][name] = jax_chunk_on_8_shards(cfg_kw, n_saves)
    ref["sweep"] = port_sweep(tmp / "sweep", **tr.ENS)
    ref["margin"] = port_sweep(tmp / "margin", **tr.MARGIN)
    jdr.run_sweep(tr.SWEEP, base_dir=str(tmp / "jax-sweep"),
                  mesh=jshd.make_mesh(jax.devices(), ensemble=2), **tr.ENS)
    tr.collect(procs)
    with np.load(out / "parallel.npz") as d:
        ranks = dict(d)
    info = json.loads((out / "parallel.json").read_text())
    return tmp, out, ref, ranks, info


def ranks_of(ranks, prefix):
    return {k[len(prefix) + 1:]: v for k, v in ranks.items()
            if k.startswith(prefix + "_")}


def assert_same_carry(got: dict, want: dict):
    """Times, step counts and overflow exactly; packets at ATOL_MEMBERS,
    the spectrum at ATOL_MEMBERS relative to its scale."""
    for key in ("t", "step", "overflow"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("x", "k"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=ATOL_MEMBERS, err_msg=key)
    np.testing.assert_allclose(got["qk"], want["qk"], rtol=0,
                               atol=ATOL_MEMBERS * np.abs(want["qk"]).max())


def assert_same_files(got: Path, want: Path):
    """Each member's omega counts and times byte for byte, its packet
    snapshot and PV at ATOL_MEMBERS, and its params.json."""
    for i in range(len(tr.SWEEP)):
        g, w = got / f"run-{i}", want / f"run-{i}"
        assert sorted(p.name for p in g.glob("*.bin")) == \
            sorted(f"{b}.bin" for b in EXACT + CLOSE)
        for b in EXACT:
            assert (g / f"{b}.bin").read_bytes() == \
                (w / f"{b}.bin").read_bytes(), (i, b)
        for b in CLOSE:
            np.testing.assert_allclose(np.fromfile(g / f"{b}.bin"),
                                       np.fromfile(w / f"{b}.bin"), rtol=0,
                                       atol=ATOL_MEMBERS, err_msg=f"{i} {b}")
        assert json.loads((g / "params.json").read_text()) == \
            json.loads((w / "params.json").read_text())
    assert json.loads((got / "params.json").read_text()) == \
        json.loads((want / "params.json").read_text())


@pytest.mark.parametrize("path", sorted(tr.CHUNKS))
def test_sharded_chunk_matches_one_rank_and_jax(runs, path):
    """tests/test_parallel.py's packet sharding on the stencil path, the
    windowed path and the production fused march: two ranks equal one bit
    for bit (overflow reduced by MAX included) and JAX on 8 shards."""
    _, _, ref, ranks, _ = runs
    got, one, want = ranks_of(ranks, path), ref["chunk"][path], \
        ref["jax"][path]
    assert sorted(got) == sorted(one)
    for key in one:
        np.testing.assert_array_equal(got[key], one[key], err_msg=key)
    assert int(got["overflow"]) == (0 if path == "production" else -1)
    for key in ("x", "k", "px", "pk"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=ATOL,
                                   err_msg=key)
    # rtol relative to each mode, atol to the spectrum's scale (modes the
    # filter has decayed to ~1e-315), as tests/test_torch_coupled.py does
    np.testing.assert_allclose(got["qk"], want["qk"], rtol=RTOL_QK,
                               atol=RTOL_QK * np.abs(want["qk"]).max())


def test_sweep_on_mesh_matches_unsharded_and_jax(runs):
    """run_sweep(ensemble=True, mesh=make_mesh(ensemble=2)) on two ranks:
    every member's omega counts and times equal the one-rank sweep's, and
    so does the returned (gathered) carry (assert_same_carry); omega counts
    exactly and times equal to JAX's run_sweep on its (2, 4) mesh."""
    tmp, out, ref, ranks, _ = runs
    assert_same_files(out / "sweep", tmp / "sweep")
    assert_same_carry(ranks_of(ranks, "sweep"), ref["sweep"])
    from swraytracing_torch.analysis import spectra
    for i in range(len(tr.SWEEP)):
        c1, _, t1, _ = spectra.load_omega_hist(out / "sweep" / f"run-{i}")
        c2, _, t2, _ = spectra.load_omega_hist(tmp / "jax-sweep" / f"run-{i}")
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_allclose(t1, t2, rtol=1e-14)


def test_two_rank_checkpoint_resumes_on_one_rank_and_in_jax(runs):
    """The two ranks' checkpoint after chunk 1 holds the whole ensemble:
    the port resumes it on one rank into the one-rank sweep's files and
    carry, and the JAX package continues it (init_from) to the same
    packets (atol 1e-12)."""
    tmp, out, ref, _, _ = runs
    ck = latest_checkpoint(out / "sweep", prefix="ckpt-g0")
    assert Path(ck).name == "ckpt-g0_000000000002.npz"
    d = tmp / "resumed"
    shutil.copytree(out / "sweep", d)
    (d / Path(ck).name).unlink()
    carry, _ = tdr.run_sweep(tr.SWEEP, base_dir=str(d), resume=True,
                             **tr.ENS, **tr.CPU)
    assert_same_files(d, tmp / "sweep")
    assert_same_carry(tr.arrays(x=carry.packet_x, k=carry.packet_k,
                                qk=carry.flow_state.qk, t=carry.flow_state.t,
                                step=carry.flow_state.step,
                                overflow=carry.overflow), ref["sweep"])
    first = latest_checkpoint(d, prefix="ckpt-g0")
    assert Path(first).name == "ckpt-g0_000000000002.npz"   # rewritten
    jcarry, _ = jdr.run_sweep(
        tr.SWEEP, base_dir=str(tmp / "jax-init"),
        init_from=str(out / "sweep" / "ckpt-g0_000000000001.npz"),
        **dict(tr.ENS, max_steps=50))
    np.testing.assert_allclose(np.asarray(jcarry.packet_x), ref["sweep"]["x"],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(jcarry.packet_k), ref["sweep"]["k"],
                               rtol=0, atol=1e-12)


def test_margin_retry_agreed_by_every_rank(runs):
    """Member 0 overflows its one-cell margin and member 1 does not: on a
    (2, 1) mesh only rank 0 sees the overflow, yet both ranks discard the
    chunk, widen the margin and re-run it together (no rank hangs), and the
    files equal the one-rank sweep's."""
    tmp, out, ref, ranks, _ = runs
    assert_same_files(out / "margin", tmp / "margin")
    metrics = [json.loads(line) for line in
               (out / "margin" / "metrics.jsonl").read_text().splitlines()]
    assert any(m.get("march_overflow") and m.get("chunk_discarded")
               for m in metrics)
    got = ranks_of(ranks, "margin")
    assert int(got["overflow"].max()) == 0
    assert_same_carry(got, ref["margin"])


def test_scaling_harness_runs(runs):
    """tests/test_parallel.py::test_scaling_harness_runs at one and two
    ranks: packet counts, positive rates, the first efficiency 1."""
    points = runs[4]["scaling"]
    assert [p["n_ranks"] for p in points] == [1, 2]
    assert [p["packets"] for p in points] == [64, 128]
    assert all(p["packet_steps_per_sec"] > 0 for p in points)
    assert abs(points[0]["efficiency"] - 1.0) < 1e-9


def test_make_mesh_raises_on_a_non_divisor(runs):
    assert runs[4]["mesh_error"] == "ensemble=3 must divide the world size 2"
