"""Four processes of swraytracing_torch joined through
parallel/multihost.initialize (tests/test_multiprocess.py's multi-host
path): global packet arrays from each rank's block, the coupled chunk on
four ranks against one process, the flow gradient summed over the packet
ranks against jax.grad on 8 shards (tests/test_parallel.py:44-64,
:282-306), and the sweep on a (2, 2) mesh, where both axes hold more than
one rank, against the one-rank sweep and JAX's.

The ranks are gloo processes on the CPU (tests/torch_ranks.py, suite
"multihost"), started once for the module; the references are computed in
this process while they run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swraytracing_tpu import drivers as jdr
from swraytracing_tpu.models import coupled as jcoupled
from swraytracing_tpu.parallel import sharding as jshd
from swraytracing_torch.analysis import spectra
from swraytracing_torch.models.coupled import (CoupledConfig,
                                               run_coupled_chunk,
                                               setup_coupled)

import torch_parity  # noqa: F401  (one torch thread per worker)
import torch_ranks as tr
from test_torch_parallel import (assert_same_carry, assert_same_files,
                                 port_sweep, ranks_of)

WORLD = 4


def jax_chunk(cfg_kw, n_saves):
    """tests/test_multiprocess.py's single-process reference."""
    cfg = jcoupled.CoupledConfig(**cfg_kw)
    s, carry = jcoupled.setup_coupled(cfg)
    c, _ = jax.jit(lambda c: jcoupled.run_coupled_chunk(c, s, cfg,
                                                        n_saves))(carry)
    return np.asarray(c.packet_x), np.asarray(c.packet_k)


def jax_flow_gradient_on_8_shards(cfg_kw):
    """tests/test_parallel.py: jax.grad of mean_c(sum_packets pk[-1]^2)
    through 2 saves, the packets on 8 shards."""
    cfg = jcoupled.CoupledConfig(**cfg_kw)
    s, carry = jcoupled.setup_coupled(cfg)

    def loss(qk0, c):
        c = c.replace(flow_state=c.flow_state.replace(qk=qk0))
        c, (px, pk, ts) = jcoupled.run_coupled_chunk(c, s, cfg, 2)
        return jnp.mean(jnp.sum(pk[-1] ** 2, -1))

    mesh = jshd.make_mesh(ensemble=1)
    carry = carry.replace(
        packet_x=jax.device_put(carry.packet_x, jshd.packet_sharding(mesh)),
        packet_k=jax.device_put(carry.packet_k, jshd.packet_sharding(mesh)))
    qk = jax.device_put(carry.flow_state.qk, jshd.replicated(mesh))
    return np.asarray(jax.jit(jax.grad(loss))(qk, carry))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    procs, out = tr.spawn("multihost", WORLD, tmp)
    cfg_kw, n_saves = tr.MULTIPROCESS
    cfg = CoupledConfig(**cfg_kw)
    s, carry = setup_coupled(cfg, **tr.CPU)
    c, _ = run_coupled_chunk(carry, s, cfg, n_saves)
    ref = dict(port=tr.arrays(x=c.packet_x, k=c.packet_k),
               jax=jax_chunk(cfg_kw, n_saves),
               grads={name: jax_flow_gradient_on_8_shards(kw)
                      for name, kw in tr.GRADS.items()},
               sweep=port_sweep(tmp / "sweep", **tr.ENS))
    jdr.run_sweep(tr.SWEEP, base_dir=str(tmp / "jax-sweep"),
                  mesh=jshd.make_mesh(jax.devices(), ensemble=2), **tr.ENS)
    tr.collect(procs)
    with np.load(out / "multihost.npz") as d:
        ranks = dict(d)
    roundtrip = json.loads((out / "multihost.json").read_text())
    return tmp, out, ref, ranks, roundtrip


@pytest.mark.parametrize("shape", [(1, WORLD), (2, WORLD // 2)])
def test_global_packet_array_roundtrip(runs, shape):
    """test_parallel.py::test_multihost_helpers_roundtrip across processes:
    each rank's (2, 16) block of a (2, 64) array assembles into the global
    DTensor, host_local_slice gives the block back, and the whole array is
    the blocks in rank order."""
    got = runs[4][str(shape)]
    assert got == dict(shape=[2, 64], local_back=True, whole=True,
                       gathered=True)


def test_four_processes_match_one(runs):
    """test_multiprocess.py: the chunk on four ranks, each holding a
    quarter of the packets, equals the one-process run: the port's bit for
    bit, JAX's to 1e-12."""
    _, _, ref, ranks, _ = runs
    got = ranks_of(ranks, "multiprocess")
    for key in ("x", "k"):
        np.testing.assert_array_equal(got[key], ref["port"][key])
    np.testing.assert_allclose(got["x"], ref["jax"][0], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got["k"], ref["jax"][1], rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("path", sorted(tr.GRADS))
def test_sharded_flow_gradient_matches_jax(runs, path):
    """The flow gradient, each rank's part summed over the four ranks,
    equals jax.grad with the packets on 8 shards (PyTorch's gradient w.r.t.
    a complex leaf is the conjugate of JAX's) to rtol 1e-10."""
    _, _, ref, ranks, _ = runs
    got = ranks[f"grad_{path}"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.conj(ref["grads"][path]), rtol=1e-10)


def test_sweep_on_2x2_mesh_matches_unsharded_and_jax(runs):
    """run_sweep(mesh=make_mesh(ensemble=2)) on four ranks: members over
    the ensemble axis and each member's packets over the packet axis (the
    omega counts summed over it) give the one-rank sweep's files and carry
    and JAX's counts and times."""
    tmp, out, ref, ranks, _ = runs
    assert_same_files(out / "sweep", tmp / "sweep")
    assert_same_carry(ranks_of(ranks, "sweep"), ref["sweep"])
    for i in range(len(tr.SWEEP)):
        c1, _, t1, _ = spectra.load_omega_hist(out / "sweep" / f"run-{i}")
        c2, _, t2, _ = spectra.load_omega_hist(tmp / "jax-sweep" / f"run-{i}")
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_allclose(t1, t2, rtol=1e-14)
