"""Gradients through the one-layer coupled chunk whose fused march is fed
by the one-pass window build (march_fused_build=True; its backward is the
linear transpose of the plain build in both packages): the port against
jax.grad through the JAX chunk (CPU, float64), and against the port's
two-pass build. Conventions as in tests/test_torch_gradients.py:
g_torch == conj(g_jax) for the complex PV spectrum."""

import numpy as np
import torch

from swraytracing_tpu.models import coupled as jcp
from swraytracing_torch.models import coupled as tcp

from torch_parity import (GRAD_CFG as CFG, GRAD_PATHS as PATHS,
                          GRAD_N_SAVES as N_SAVES, check_chunk_gradients,
                          torch_chunk_grads)


def test_fused_build_chunk_gradients_match_jax():
    ts, got = check_chunk_gradients(
        jcp, tcp, "coupled", dict(PATHS["march"], march_fused_build=True),
        remat=False)
    assert ts.march.fused_build
    # the same gradients as the two-pass build's (the forward is the same
    # bits; the backward sums the same cotangents another way)
    tcfg = tcp.CoupledConfig(**dict(CFG, **PATHS["march"]))
    ts2, tc2 = tcp.setup_coupled(tcfg, device="cpu", dtype=torch.float64)
    two = torch_chunk_grads(tcp.run_coupled_chunk, ts2, tcfg, tc2, N_SAVES)
    for a, b in zip(got, two):
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-13 * np.abs(b).max())
