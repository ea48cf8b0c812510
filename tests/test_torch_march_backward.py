"""The march's backward (swraytracing_torch.ops.march_window:
march_gathered_backward_cuda, the kernel of kernels/csrc/march_backward.cuh,
and the dispatch in _march_backward) against autograd through the plain
march, march_gathered_reference.

On the CPU: the dispatch keeps the plain route, bit for bit, and the
kernel's wrapper refuses what its kernel does not take before any build.
The tests marked `card` need a CUDA device and skip without one; they hold
the kernel's cotangents of the packets and of both window arrays to
autograd on the card. This file imports no JAX, so on a machine with a card
it runs by itself:

    python -m pytest tests/test_torch_march_backward.py --noconftest -q
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from swraytracing_torch import kernels
from swraytracing_torch.ops import march_window as mw

NX = 16
L = 2.0 * math.pi
DX = L / NX


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _spec(nf=2, margin=1, **kw):
    return mw.MarchSpec(nx=NX, ny=NX, dx=DX, dy=DX, f=3.0, Cg=1.0,
                        n_substeps=2, nf=nf, margin=margin,
                        grad_from_interp=nf == 2, tiles_transposed=True,
                        **kw)


def _smooth(rng, n):
    """n smooth random (NX, NX) fields."""
    f = rng.standard_normal((n, NX, NX))
    fk = np.fft.rfft2(f)
    kx = np.fft.fftfreq(NX)[:, None]
    ky = np.fft.rfftfreq(NX)[None, :]
    fk *= np.exp(-((kx * NX / 6) ** 2 + (ky * NX / 6) ** 2))
    return np.fft.irfft2(fk, s=(NX, NX))


def _inputs(spec, n, seed=0, crowd=0, overflow=0, dtype=torch.float64,
            device="cpu"):
    """(win1, win2, xk, oi, oj, ct): both snapshots' window arrays, n
    packets in the left half of the grid (the right half's cells stay
    empty), a few of them on cell edges, `crowd` of them in one cell, and
    the last `overflow` of them given an origin cell two rows of cells from
    where they stand, past a margin of 1 (the march clamps their shift and
    counts the excess); a random cotangent."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0, L / 2, n), rng.uniform(0, L, n)])
    k = rng.normal(0, 3.0, (2, n))
    edges = min(n, 4)
    x[:, :edges] = np.array([[3, 5, 0, 7], [2, 0, 9, 7]])[:, :edges] * DX
    if crowd:
        x[:, edges:edges + crowd] = (np.array([[5.0], [11.0]])
                                     + rng.uniform(0.01, 0.99, (2, crowd))) * DX
    if overflow:
        x[0, n - overflow:] = rng.uniform(2 * DX, 6 * DX, overflow)
    F1, F2 = (torch.from_numpy(_smooth(rng, 6)) for _ in range(2))
    win1 = mw.build_gather_windows(F1, spec)
    win2 = mw.build_gather_windows(F2, spec)
    xk = torch.from_numpy(np.concatenate([x, k]))
    oi, oj = mw.packet_cells(xk[0], xk[1], spec)
    if overflow:
        oi[n - overflow:] += 2
    ct = torch.from_numpy(rng.standard_normal((4, n)))
    return tuple(t.to(device=device, dtype=dtype if t.is_floating_point()
                      else t.dtype).contiguous()
                 for t in (win1, win2, xk, oi, oj, ct))


def _autograd(win1, win2, xk, oi, oj, ct, sub_dt, spec):
    """Today's cotangents: autograd through march_gathered_reference."""
    leaves = [t.clone().requires_grad_(True) for t in (win1, win2, xk)]
    out, _ = mw.march_gathered_reference(*leaves, oi, oj, sub_dt, spec)
    g1, g2, gx = torch.autograd.grad(out, leaves, ct)
    return gx, g1, g2


def _rel(got, want):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale else 1.0)


def _counts():
    return (dict(mw._march_backward.routes),
            mw.march_gathered_backward_cuda.launches)


# ---------------------------------------------------------------------------
# the CPU: the plain route, bit for bit, and the wrapper's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nf,margin,wanted", [
    (2, 1, (True, True, True)), (6, 2, (True, True, True)),
    (2, 1, (False, False, True)), (2, 2, (True, False, False))])
def test_cpu_keeps_the_plain_route_bit_for_bit(nf, margin, wanted):
    spec = _spec(nf, margin)
    win1, win2, xk, oi, oj, ct = _inputs(spec, 300, seed=nf + margin)
    sub_dt = 0.3 * margin * DX
    leaves = [t.clone().requires_grad_(w)
              for t, w in zip((win1, win2, xk), wanted)]
    want_leaves = [t.clone().requires_grad_(w)
                   for t, w in zip((win1, win2, xk), wanted)]
    routes, launches = _counts()
    out, _ = mw.fused_march_gathered(*leaves, oi, oj, sub_dt, spec)
    (out * ct).sum().backward()
    after, launches_after = _counts()
    assert after["plain"] == routes["plain"] + 1
    assert after["kernel"] == routes["kernel"]
    assert launches_after == launches == 0
    ref, _ = mw.march_gathered_reference(*want_leaves, oi, oj, sub_dt, spec)
    (ref * ct).sum().backward()
    for got, want in zip(leaves, want_leaves):
        if want.requires_grad:
            assert torch.equal(got.grad, want.grad)
        else:
            assert got.grad is None


def test_cpu_plain_version_is_autograd_through_the_plain_march():
    """march_gathered_backward_reference: the cotangents autograd gives
    through march_gathered_reference, bit for bit; the windows' left out
    without need_win."""
    spec = _spec(2, 1)
    win1, win2, xk, oi, oj, ct = _inputs(spec, 200, seed=3, crowd=40)
    sub_dt = 0.3 * DX
    gx, g1, g2 = mw.march_gathered_backward_reference(win1, win2, xk, oi, oj,
                                                      sub_dt, ct, spec)
    want = _autograd(win1, win2, xk, oi, oj, ct, sub_dt, spec)
    for got, w in zip((gx, g1, g2), want):
        assert torch.equal(got, w)
    gx2, n1, n2 = mw.march_gathered_backward_reference(
        win1, win2, xk, oi, oj, sub_dt, ct, spec, need_win=False)
    assert n1 is None and n2 is None
    assert torch.equal(gx2, gx)


@pytest.mark.parametrize("stepper,dt_grad", [("rk4", False),
                                             ("symplectic", False),
                                             ("rk23", True)])
def test_cpu_other_steppers_and_layouts_stay_plain(stepper, dt_grad):
    """rk4, symplectic, and a sub_dt that is a tensor needing a gradient,
    take the plain route; that sub_dt gets autograd's cotangent through
    the plain march."""
    spec = _spec(2, 1, stepper=stepper)
    win1, win2, xk, oi, oj, ct = _inputs(spec, 64, seed=4)

    def leaves():
        dt = 0.2 * DX
        if dt_grad:
            dt = torch.tensor(dt, dtype=torch.float64, requires_grad=True)
        return xk.clone().requires_grad_(True), dt

    a, dt = leaves()
    routes, _ = _counts()
    out, _ = mw.fused_march_gathered(win1, win2, a, oi, oj, dt, spec)
    (out * ct).sum().backward()
    after, launches = _counts()
    assert after == {"kernel": routes["kernel"],
                     "plain": routes["plain"] + 1}
    assert launches == 0
    assert torch.isfinite(a.grad).all()
    if dt_grad:
        b, dt_b = leaves()
        ref, _ = mw.march_gathered_reference(win1, win2, b, oi, oj, dt_b,
                                             spec)
        (ref * ct).sum().backward()
        assert dt.grad is not None and float(dt.grad) != 0.0
        assert torch.equal(dt.grad, dt_b.grad)
        assert torch.equal(a.grad, b.grad)


def _cpu_args(spec=None):
    spec = spec or _spec(2, 1)
    win1, win2, xk, oi, oj, ct = _inputs(spec, 40, seed=5)
    return [win1, win2, xk, oi, oj, 0.1, ct, spec]


def _with(i, value):
    def breaker(args):
        args = list(args)
        args[i] = value(args[i]) if callable(value) else value
        return args
    return breaker


@pytest.mark.parametrize("breaker,kw,match", [
    (None, {}, "CUDA"),
    (_with(7, lambda s: s._replace(tiles_transposed=False)), {},
     "tiles_transposed"),
    (_with(7, lambda s: s._replace(stepper="rk4")), {}, "rk23"),
    (_with(7, lambda s: s._replace(n_substeps=9)), {}, "at most 8"),
    (_with(5, torch.tensor(0.1, dtype=torch.float64, requires_grad=True)),
     {}, "sub_dt"),
    (_with(0, lambda w: w[:, :-1].contiguous()), {}, "`win1` must be"),
    (_with(1, lambda w: w.float()), {}, "`win2` must be"),
    (_with(2, lambda x: x[:3]), {}, "`xk` must be"),
    (_with(3, lambda o: o.long()), {}, "`oi` must be"),
    (_with(6, lambda c: c[:, :-1]), {}, "`ct_xk` must be"),
    (_with(6, lambda c: c.float()), {}, "`ct_xk` must be"),
    (None, {"route": "ring"}, "route must be"),
])
def test_backward_cuda_refuses(breaker, kw, match):
    args = _cpu_args()
    if breaker is not None:
        args = breaker(args)
    with pytest.raises(ValueError, match=match):
        mw.march_gathered_backward_cuda(*args, **kw)
    assert mw.march_gathered_backward_cuda.launches == 0
    assert mw.march_gathered_backward_cuda.launches_by_route == {
        "staged": 0, "direct": 0}
    assert kernels._lib is None  # no build was attempted


@pytest.mark.parametrize("nf,margin,dtype,route", [
    (2, 1, torch.float32, "staged"), (2, 1, torch.float64, "staged"),
    (2, 2, torch.float64, "staged"), (6, 1, torch.float64, "staged"),
    (6, 2, torch.float32, "staged"), (6, 2, torch.float64, "direct")])
def test_backward_route(nf, margin, dtype, route):
    """Staged where one warp's rows fit in one SM's shared memory, as on
    the forward's staged route."""
    spec = _spec(nf, margin)
    assert mw.march_backward_route(spec, dtype) == route
    fits = mw.staged_warp_bytes(spec, dtype) <= mw.SMEM_PER_SM
    assert fits == (route == "staged")


def test_constants_are_the_kernel_source_s():
    src = (pathlib.Path(kernels.__file__).parent / "csrc"
           / "march_backward.cuh").read_text()
    m = re.search(r"constexpr int BWD_MAX_SUBSTEPS = (\d+);", src)
    assert m and int(m.group(1)) == mw.BACKWARD_MAX_SUBSTEPS
    m = re.search(r"constexpr int RECORD = (\d+);", src)
    assert m and int(m.group(1)) == mw.BACKWARD_RECORD


# ---------------------------------------------------------------------------
# the card: the kernel against autograd through the plain march
# ---------------------------------------------------------------------------

TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def _check_kernel(dev, spec, n, dtype, seed, sub_dt=None, crowd=0,
                  overflow=0, route=None):
    args = _inputs(spec, n, seed=seed, crowd=crowd, overflow=overflow,
                   dtype=dtype, device=dev)
    win1, win2, xk, oi, oj, ct = args
    sub_dt = 0.3 * spec.margin * DX if sub_dt is None else sub_dt
    before = mw.march_gathered_backward_cuda.launches
    got = mw.march_gathered_backward_cuda(win1, win2, xk, oi, oj, sub_dt, ct,
                                          spec, route=route)
    torch.cuda.synchronize()
    assert mw.march_gathered_backward_cuda.launches == before + 1
    want = _autograd(win1, win2, xk, oi, oj, ct, sub_dt, spec)
    for name, g, w in zip(("xk", "win1", "win2"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g, w) <= TOL[dtype], (name, _rel(g, w))
    # a cell without a packet: its rows exactly zero, in both
    cells = (oi.long() * NX + oj.long()).cpu().numpy()
    empty = np.setdiff1d(np.arange(NX * NX), cells)
    assert empty.size > 0
    for g in got[1:]:
        assert not g[torch.from_numpy(empty).to(dev)].any()
    return args, got, want


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nf,margin", [(2, 1), (2, 2), (6, 1), (6, 2)])
@pytest.mark.parametrize("n", [1, 37, 700, 5000])
def test_kernel_matches_autograd(card, nf, margin, dtype, n):
    _check_kernel(card, _spec(nf, margin), n, dtype, seed=n + nf + margin)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nf", [2, 6])
def test_kernel_crowded_cell_and_overflow(card, nf, dtype):
    """3000 of 4000 packets in one cell (its row the sum over ~94 batches
    of 32), 20 packets past the margin (clamped shift, overflow > 0)."""
    spec = _spec(nf, 1)
    (win1, win2, xk, oi, oj, _), _, _ = _check_kernel(
        card, spec, 4000, dtype, seed=11, crowd=3000, overflow=20)
    _, ov = mw.march_gathered_cuda(win1, win2, xk, oi, oj, 0.3 * DX, spec)
    assert int(ov.max()) > 0


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_frozen(card, dtype):
    """sub_dt = 0: the packets' cotangent passes through unchanged and the
    windows get none."""
    spec = _spec(2, 1)
    (_, _, _, _, _, ct), got, _ = _check_kernel(card, spec, 500, dtype,
                                                seed=12, sub_dt=0.0)
    assert torch.equal(got[0], ct)
    assert not got[1].any() and not got[2].any()


@pytest.mark.card
@pytest.mark.parametrize("nf,dtype", [(2, torch.float32), (2, torch.float64),
                                      (6, torch.float32)])
def test_kernel_routes_same_bits_and_deterministic(card, nf, dtype):
    """Both routes give the same bits, run after run: every row is summed
    in an order fixed by the cell order."""
    spec = _spec(nf, 1)
    args = _inputs(spec, 3000, seed=13, crowd=1000, dtype=dtype, device=card)
    win1, win2, xk, oi, oj, ct = args
    runs = [mw.march_gathered_backward_cuda(win1, win2, xk, oi, oj, 0.2 * DX,
                                            ct, spec, route=r)
            for r in ("staged", "staged", "direct", "direct")]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_route_in_the_backward(card, dtype):
    """fused_march_gathered's backward on the card: the kernel route for
    rk23 with a float sub_dt, all three cotangents or the packets' alone
    (test_fused_march_gathered_gradient_only_where_asked's case); the plain
    route for a sub_dt that needs a gradient and for rk4."""
    spec = _spec(2, 1)
    win1, win2, xk, oi, oj, ct = _inputs(spec, 600, seed=14, dtype=dtype,
                                         device=card)
    sub_dt = 0.3 * DX
    want = _autograd(win1, win2, xk, oi, oj, ct, sub_dt, spec)

    def run(spec, dt, wanted):
        leaves = [t.clone().requires_grad_(w)
                  for t, w in zip((win1, win2, xk), wanted)]
        routes, launches = _counts()
        out, _ = mw.fused_march_gathered(*leaves, oi, oj, dt, spec)
        (out * ct).sum().backward()
        after, launches_after = _counts()
        took = {k: after[k] - routes[k] for k in after}
        return leaves, took, launches_after - launches

    leaves, took, launched = run(spec, sub_dt, (True, True, True))
    assert took == {"kernel": 1, "plain": 0} and launched == 1
    for leaf, w in zip(leaves, (want[1], want[2], want[0])):
        assert _rel(leaf.grad, w) <= TOL[dtype]
    leaves, took, launched = run(spec, sub_dt, (False, False, True))
    assert took == {"kernel": 1, "plain": 0} and launched == 1
    assert leaves[0].grad is None and leaves[1].grad is None
    assert _rel(leaves[2].grad, want[0]) <= TOL[dtype]
    tdt = torch.tensor(sub_dt, dtype=dtype, device=card, requires_grad=True)
    _, took, launched = run(spec, tdt, (True, True, True))
    assert took == {"kernel": 0, "plain": 1} and launched == 0
    assert tdt.grad is not None
    _, took, launched = run(spec._replace(stepper="rk4"), sub_dt,
                            (True, True, True))
    assert took == {"kernel": 0, "plain": 1} and launched == 0
