"""Gradients through the one-layer coupled chunk
(swraytracing_torch.models.coupled.run_coupled_chunk): the port's autograd
against jax.grad through the JAX chunk on the same config (CPU, float64),
on the fused march (window_min_np=1; the march's backward differentiates
its plain version, as the JAX package's custom VJP does); remat=True
against the plain chunk on every packet path; and one finite-difference
check of the port alone. The one-pass window build is held against JAX in
tests/test_torch_gradients_windows.py, the per-stage paths in
tests/test_torch_gradients_per_stage.py, the two-layer model in
tests/test_torch_gradients2.py.

Conventions. For a real loss of the complex PV spectrum qk, PyTorch's
gradient is the complex conjugate of jax.grad's, so the tests compare
g_torch with conj(g_jax), and the finite-difference identity is
FD == Re(torch.vdot(g_torch, d)) for a direction d. The whole spectrum is
compared, the ky=0 and Nyquist columns included: irfft2's backward treats
the imaginary parts there alike in both packages."""

import dataclasses

import numpy as np
import pytest
import torch

from swraytracing_tpu.models import coupled as jcp
from swraytracing_torch.models import coupled as tcp

from torch_parity import (GRAD_CFG as CFG, GRAD_PATHS as PATHS,
                          GRAD_N_SAVES as N_SAVES, check_chunk_gradients,
                          torch_chunk_grads, torch_chunk_loss)


def test_chunk_gradients_match_jax():
    # and rematerialised, the same gradients
    ts, _ = check_chunk_gradients(jcp, tcp, "coupled", PATHS["march"])
    assert ts.march is not None


@pytest.mark.parametrize("path", list(PATHS))
def test_remat_gradient_matches_plain(path):
    """tests/test_parallel.py's check through the port: remat changes
    memory, not math (rtol 1e-10, atol 1e-12), on the JAX test's config
    (16 packets, 10 flow steps) for each packet path."""
    cfg = tcp.CoupledConfig(nx=32, n_packets=16, T_Fr_days=5.0,
                            packet_delay_days=0.05, **PATHS[path])
    s, carry = tcp.setup_coupled(cfg, device="cpu", dtype=torch.float64)

    def grad(remat):
        qk = carry.flow_state.qk.detach().clone().requires_grad_(True)
        c = dataclasses.replace(carry, flow_state=dataclasses.replace(
            carry.flow_state, qk=qk))
        c2, _ = tcp.run_coupled_chunk(c, s, cfg, 2, remat=remat)
        (g,) = torch.autograd.grad((c2.packet_k.abs() ** 2).mean(), qk)
        return g.numpy()

    g_plain, g_remat = grad(False), grad(True)
    np.testing.assert_allclose(g_remat, g_plain, rtol=1e-10, atol=1e-12)
    assert np.abs(g_plain).max() > 0


def test_chunk_gradient_vs_finite_differences():
    """The port alone: the directional derivative of the loss along a
    random complex direction of qk and a random direction of the packet
    wavevectors, by autograd through the fused march and by a central
    difference (eps 1e-6, rtol 1e-6). FD == Re(torch.vdot(g, d))."""
    tcfg = tcp.CoupledConfig(**dict(CFG, **PATHS["march"]))
    ts, tc = tcp.setup_coupled(tcfg, device="cpu", dtype=torch.float64)
    g_qk, g_k = torch_chunk_grads(tcp.run_coupled_chunk, ts, tcfg, tc,
                                  N_SAVES)
    rng = np.random.default_rng(11)
    d_qk = torch.from_numpy(rng.standard_normal(g_qk.shape)
                            + 1j * rng.standard_normal(g_qk.shape))
    d_qk = d_qk * float(tc.flow_state.qk.abs().max())
    d_k = torch.from_numpy(rng.standard_normal(g_k.shape))
    eps = 1e-6
    qk0, pk0 = tc.flow_state.qk, tc.packet_k
    with torch.no_grad():
        def loss(sgn):
            return float(torch_chunk_loss(
                tcp.run_coupled_chunk, ts, tcfg, tc, N_SAVES,
                qk0 + sgn * eps * d_qk, pk0 + sgn * eps * d_k))
        fd = (loss(1) - loss(-1)) / (2 * eps)
    ad = float(torch.vdot(torch.from_numpy(g_qk).ravel(), d_qk.ravel()).real
               + (torch.from_numpy(g_k) * d_k).sum())
    np.testing.assert_allclose(ad, fd, rtol=1e-6)
