"""Gradients through the two-layer coupled chunk
(swraytracing_torch.models.coupled2.run_coupled2_chunk): the port's
autograd against jax.grad through the JAX chunk on the same config (CPU,
float64) on the fused march and the stencil per-stage path, each also
rematerialised (remat=True) against the plain chunk; the windowed
per-stage path is in tests/test_torch_gradients_windows.py. Conventions
as in tests/test_torch_gradients.py: g_torch == conj(g_jax) for the
complex PV spectra of both layers."""

import pytest

from swraytracing_tpu.models import coupled2 as jc2
from swraytracing_torch.models import coupled2 as tc2

from torch_parity import GRAD_PATHS as PATHS, check_chunk_gradients


@pytest.mark.parametrize("path", ["march", "stencil"])
def test_chunk_gradients_match_jax(path):
    ts, (g_qk, _) = check_chunk_gradients(jc2, tc2, "coupled2", PATHS[path])
    assert (ts.march is not None) == (path == "march")
    assert g_qk.shape[0] == 2   # both layers' spectra
