"""Gradients through the coupled chunks on the per-stage packet path (no
fused march; plain PyTorch stages of the blended flow), the port against
jax.grad through the JAX chunk (CPU, float64), rematerialised against
plain: the stencil path of the one-layer model (below window_min_np) and
the windowed path (prebuilt stencil windows, fused_march off) of both
models; the two-layer stencil path is in tests/test_torch_gradients2.py.
Conventions as in tests/test_torch_gradients.py: g_torch == conj(g_jax)
for the complex PV spectrum."""

import pytest

from swraytracing_tpu.models import coupled as jcp
from swraytracing_tpu.models import coupled2 as jc2
from swraytracing_torch.models import coupled as tcp
from swraytracing_torch.models import coupled2 as tc2

from torch_parity import GRAD_PATHS as PATHS, check_chunk_gradients


@pytest.mark.parametrize("model,path", [("coupled", "stencil"),
                                        ("coupled", "windowed"),
                                        ("coupled2", "windowed")])
def test_chunk_gradients_match_jax(model, path):
    jmod, tmod = (jcp, tcp) if model == "coupled" else (jc2, tc2)
    ts, _ = check_chunk_gradients(jmod, tmod, model, PATHS[path])
    assert ts.march is None
