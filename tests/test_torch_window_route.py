"""The window build's two routes on the card (ops/march_window.
build_gather_windows, the rule window_build_route): a build that needs no
gradient runs the one-pass kernel K3 whatever spec.fused_build says, and
its rows are the two-pass build's (the shifted views' strided copy, then
K2) bit for bit; a build that needs a gradient keeps the form the field
names. Every test needs a CUDA device and skips without one. This file
imports no JAX, so on a machine with a card it runs by itself:

    python -m pytest tests/test_torch_window_route.py --noconftest -q
"""

import pytest
import torch

from swraytracing_torch.ops import march_window as mw

# main: the two-layer main path's windows (512^2, uv windows, margin 1,
# float32); wide: six fields, margin 2, float64
CASES = {
    "main": dict(nx=512, nf=2, margin=1, dtype=torch.float32),
    "wide": dict(nx=512, nf=6, margin=2, dtype=torch.float64),
}
MEMBERS = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _spec(nx, nf, margin, fused_build=False):
    dx = 2.0 * torch.pi / nx
    return mw.MarchSpec(nx=nx, ny=nx, dx=dx, dy=dx, f=3.0, Cg=1.0, nf=nf,
                        grad_from_interp=nf == 2, margin=margin,
                        fused_build=fused_build)


def _counts():
    return {"routes": dict(mw.build_gather_windows.routes),
            "build": mw.build_windows_cuda.launches,
            "build_batched": mw.build_windows_batched_cuda.launches,
            "transpose": mw.transpose_cuda.launches,
            "transpose_batched": mw.transpose_batched_cuda.launches}


def _since(before):
    now = _counts()
    out = {k: now[k] - before[k] for k in now if k != "routes"}
    out.update({r: n - before["routes"][r]
                for r, n in now["routes"].items()})
    return out


def _two_pass(F, spec):
    """The two-pass build by its kernels: the shifted views' strided copy,
    then K2 (batched for an ensemble's fields)."""
    W = mw.build_margin_windows(F, spec).contiguous()
    if F.dim() == 4:
        return mw.transpose_batched_cuda(W)
    return mw.transpose_cuda(W)


@pytest.mark.card
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("fused_build", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_one_pass_route_is_the_two_pass_build(card, case, fused_build,
                                              batched):
    """A build that needs no gradient launches K3 once (the batched K3 for
    an ensemble's fields) and no K2, counts "one_pass", and gives the
    two-pass build's rows bit for bit, and the plain version's."""
    c = CASES[case]
    spec = _spec(c["nx"], c["nf"], c["margin"], fused_build)
    g = torch.Generator(device=card).manual_seed(23)
    shape = ((MEMBERS,) if batched else ()) + (6, c["nx"], c["nx"])
    F = torch.randn(shape, dtype=c["dtype"], device=card, generator=g)
    before = _counts()
    got = mw.build_gather_windows(F, spec)
    took = _since(before)
    assert took == {"one_pass": 1, "two_pass": 0,
                    "build": 0 if batched else 1,
                    "build_batched": 1 if batched else 0,
                    "transpose": 0, "transpose_batched": 0}
    assert got.is_contiguous()
    assert got.shape == shape[:-3] + (c["nx"] * c["nx"], spec.K)
    assert torch.equal(got, _two_pass(F, spec))
    plain = (mw.build_windows_batched_reference if batched
             else mw.build_windows_reference)
    assert torch.equal(got, plain(F, spec))


@pytest.mark.card
@pytest.mark.parametrize("fused_build", [False, True])
def test_a_build_that_needs_a_gradient_keeps_its_form(card, fused_build):
    """Fields that require grad, with grad mode on, take the form the
    field names (K2 after the strided copy, or K3 with the plain build's
    backward); the same fields with grad mode off take K3. All give the
    same rows, and both forms the same gradient."""
    c = CASES["main"]
    spec = _spec(c["nx"], c["nf"], c["margin"], fused_build)
    g = torch.Generator(device=card).manual_seed(29)
    F = torch.randn((2, c["nx"], c["nx"]), dtype=c["dtype"], device=card,
                    generator=g).requires_grad_(True)
    before = _counts()
    W = mw.build_gather_windows(F, spec)
    took = _since(before)
    form = "one_pass" if fused_build else "two_pass"
    assert took == {"one_pass": 0, "two_pass": 0, form: 1,
                    "build": int(fused_build), "build_batched": 0,
                    "transpose": int(not fused_build),
                    "transpose_batched": 0}
    assert W.requires_grad
    ct = torch.randn(W.shape, dtype=W.dtype, device=card, generator=g)
    (grad,) = torch.autograd.grad(W, F, ct)
    with torch.no_grad():
        before = _counts()
        W0 = mw.build_gather_windows(F, spec)
        assert _since(before)["one_pass"] == 1
    assert torch.equal(W.detach(), W0)
    other = mw.build_gather_windows(F, spec._replace(
        fused_build=not fused_build))
    (grad_other,) = torch.autograd.grad(other, F, ct)
    torch.testing.assert_close(grad, grad_other, rtol=1e-5, atol=1e-4)
