"""swraytracing_torch.ops.march_window (the module that holds the march,
transpose and window-build CUDA kernels) against
swraytracing_tpu.ops.pallas_window on the same numpy inputs (CPU, float64). On the CPU the port's wrappers run the kernels'
plain versions; the JAX side runs its XLA reference and, where marked,
the Pallas kernels in interpret mode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swraytracing_tpu.ops import pallas_window as jpw
from swraytracing_torch.ops import march_window as tmw

from torch_parity import (NX, L, to_jax, to_torch, to_numpy, assert_close,
                          assert_equal, smooth_fields)

NP = 128  # one Pallas block on the JAX side
DX = L / NX

# The march is a few hundred float64 multiply-adds per stage on O(1)
# values; the two frameworks differ only in the order of the window sums.
ATOL = 1e-12


def _specs(**kw):
    """The same march configuration for both packages. `combined_gather`
    and `tiles_transposed` choose among the JAX package's gather forms and
    go to its spec only: the port's march reads (ncells, K) rows only."""
    common = dict(nx=NX, ny=NX, dx=DX, dy=DX, f=3.0, Cg=1.0)
    common.update(kw)
    jkw = dict(common, block=NP)
    interpret = jkw.pop("interpret", False)
    for key in ("interpret", "combined_gather", "tiles_transposed"):
        common.pop(key, None)
    return (jpw.MarchSpec(interpret=interpret, **jkw),
            tmw.MarchSpec(**common))


def _state(seed=0, n=NP):
    rng = np.random.default_rng(seed)
    F1 = smooth_fields(rng, 6)
    F2 = smooth_fields(rng, 6)
    x = rng.uniform(0, L, (2, n))
    k = rng.normal(0, 3.0, (2, n))
    return F1, F2, x, k


def _jax_inputs(spec, F1, F2, x, k):
    """(pw1, pw2, xk, oi, oj) on the JAX side, split or combined."""
    F1, F2, x, k = map(to_jax, (F1, F2, x, k))
    W1 = jpw.build_margin_windows(F1, spec)
    W2 = jpw.build_margin_windows(F2, spec)
    oi, oj = jpw.packet_cells(x[0], x[1], spec)
    xk = jnp.concatenate([x, k], axis=0)
    if spec.combined_gather:
        Wc = jnp.concatenate([W1, W2], axis=0)
        Wc = Wc.T if spec.tiles_transposed else Wc
        return (jpw.gather_packet_windows(Wc, oi, oj, spec),
                jnp.zeros((1, 1)), xk, oi, oj)
    if spec.tiles_transposed:
        W1, W2 = W1.T, W2.T
    return (jpw.gather_packet_windows(W1, oi, oj, spec),
            jpw.gather_packet_windows(W2, oi, oj, spec), xk, oi, oj)


def _torch_inputs(spec, F1, F2, x, k):
    """(win1, win2, xk, oi, oj) through the port's own window build: the
    two (ncells, K) window arrays, which the march reads by cell."""
    F1, F2, x, k = map(to_torch, (F1, F2, x, k))
    oi, oj = tmw.packet_cells(x[0], x[1], spec)
    return (tmw.build_gather_windows(F1, spec),
            tmw.build_gather_windows(F2, spec), torch.cat([x, k], dim=0),
            oi, oj)


# ---------------------------------------------------------------------------
# window build, cells, gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nf,margin", [(6, 1), (2, 2)])
def test_build_margin_windows_equal(nf, margin):
    js, ts = _specs(nf=nf, margin=margin, grad_from_interp=nf == 2)
    F1 = _state()[0]
    W = tmw.build_margin_windows(to_torch(F1), ts)
    assert W.shape == (ts.K, NX * NX) and W.is_contiguous()
    assert_equal(W, jpw.build_margin_windows(to_jax(F1), js))


def test_build_gather_windows_layouts_and_limits():
    _, ts = _specs(margin=1)
    F1 = to_torch(_state()[0])
    W = tmw.build_margin_windows(F1, ts)
    tr = tmw.build_gather_windows(F1, ts)
    assert tr.shape == (NX * NX, ts.K) and tr.is_contiguous()
    assert_equal(tr, to_numpy(W).T)
    # the one-pass build: the same rows
    assert_equal(tmw.build_gather_windows(F1, ts._replace(fused_build=True)),
                 to_numpy(W).T)
    for build in (tmw.build_margin_windows, tmw.build_windows_reference,
                  tmw.build_windows_fused):
        with pytest.raises(ValueError, match="exceeds"):
            build(F1, ts._replace(margin=40))


@pytest.mark.parametrize("nf", [2, 6])
@pytest.mark.parametrize("margin", [1, 2, 3])
def test_build_windows_fused_equal(nf, margin):
    """The one-pass window build against the TPU kernel itself
    (build_windows_fused with the Pallas kernel in interpret mode) and
    against the two-pass route: exact, values are only copied."""
    js, ts = _specs(nf=nf, margin=margin, grad_from_interp=nf == 2,
                    tiles_transposed=True, fused_build=True, interpret=True)
    assert js.use_pallas and js.fused_build
    F1 = _state(seed=margin)[0]
    want = jpw.build_windows_fused(to_jax(F1), js)
    for build in (tmw.build_windows_fused, tmw.build_windows_reference,
                  tmw.build_gather_windows):
        got = build(to_torch(F1), ts)
        assert got.shape == (NX * NX, ts.K) and got.is_contiguous()
        assert_equal(got, want)
    assert_equal(got, to_numpy(tmw.build_margin_windows(to_torch(F1), ts)).T)


def test_build_windows_fused_non_square():
    """No side needs to be a multiple of anything (the TPU kernel falls
    back to the two-pass route when nx is not a multiple of its rows)."""
    ts = tmw.MarchSpec(nx=13, ny=22, dx=0.1, dy=0.2, f=3.0, Cg=1.0, margin=2,
                       nf=2, grad_from_interp=True, tiles_transposed=True,
                       fused_build=True)
    F = torch.from_numpy(np.random.default_rng(5).standard_normal((6, 13, 22)))
    got = tmw.build_windows_fused(F, ts)
    assert got.shape == (13 * 22, ts.K)
    assert torch.equal(got, tmw.build_margin_windows(F, ts).t())
    # row of cell (i, j), component (f, sx, sy): F[f, i+sx-lo, j+sy-lo]
    lo, SW = ts.order + ts.margin, ts.SW
    i, j, f, sx, sy = 12, 0, 1, 0, SW - 1
    assert got[i * 22 + j, (f * SW + sx) * SW + sy] == \
        F[f, (i + sx - lo) % 13, (j + sy - lo) % 22]


def test_build_windows_fused_gradient():
    """Its backward is the linear transpose of the plain build, as the JAX
    package's custom VJP (tests/test_pallas_window.py)."""
    js, ts = _specs(nf=2, margin=2, grad_from_interp=True,
                    tiles_transposed=True, fused_build=True, interpret=True)
    F = np.random.default_rng(3).standard_normal((2, NX, NX))
    want = jax.grad(
        lambda F_: jnp.sum(jnp.sin(jpw.build_windows_fused(F_, js))))(
            to_jax(F))
    Ft = to_torch(F).requires_grad_(True)
    torch.sin(tmw.build_windows_fused(Ft, ts)).sum().backward()
    assert_close(Ft.grad, want, rtol=1e-13, atol=1e-13)
    # and it is the gradient of the two-pass route
    Fr = to_torch(F).requires_grad_(True)
    torch.sin(tmw.build_gather_windows(
        Fr, ts._replace(fused_build=False))).sum().backward()
    assert_close(Ft.grad, to_numpy(Fr.grad), rtol=1e-13, atol=1e-13)


# ---------------------------------------------------------------------------
# the window build's route (window_build_route) and its counter
# ---------------------------------------------------------------------------

def _routes_since(before):
    return {r: n - before[r]
            for r, n in tmw.build_gather_windows.routes.items()}


class _OnTheCard:
    """What window_build_route reads of a CUDA tensor, on a machine
    without one."""

    is_cuda = True

    def __init__(self, requires_grad):
        self.requires_grad = requires_grad


# case -> (fields: "cpu" or "cuda", F requires grad, grad mode,
#          spec.fused_build, the route)
ROUTE_RULE = {
    "card, no gradient, two-pass field": ("cuda", False, True, False,
                                          "one_pass"),
    "card, grad mode off": ("cuda", True, False, False, "one_pass"),
    "card, grad mode off, one-pass field": ("cuda", True, False, True,
                                            "one_pass"),
    "card, needs a gradient": ("cuda", True, True, False, "two_pass"),
    "card, needs a gradient, one-pass field": ("cuda", True, True, True,
                                               "one_pass"),
    "cpu, two-pass field": ("cpu", False, True, False, "two_pass"),
    "cpu, grad mode off": ("cpu", False, False, False, "two_pass"),
    "cpu, one-pass field": ("cpu", False, True, True, "one_pass"),
    "cpu, needs a gradient": ("cpu", True, True, False, "two_pass"),
}


@pytest.mark.parametrize("case", list(ROUTE_RULE))
def test_window_build_route_rule(case):
    """A build on the card that needs no gradient is one pass whatever
    spec.fused_build says; a build that needs one, and a CPU build,
    follow spec.fused_build."""
    where, requires_grad, grad, fused, want = ROUTE_RULE[case]
    _, ts = _specs(fused_build=fused)
    F = (_OnTheCard(requires_grad) if where == "cuda"
         else torch.zeros(6, NX, NX, requires_grad=requires_grad))
    with torch.set_grad_enabled(grad):
        assert tmw.window_build_route(F, ts) == want


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("fused_build", [False, True])
def test_cpu_build_follows_fused_build(fused_build, batched):
    """On the CPU spec.fused_build still picks the form, counted once a
    call under its route, and either form gives the JAX package's rows
    bit for bit (member by member for an ensemble's fields)."""
    js, ts = _specs(nf=2, margin=2, grad_from_interp=True,
                    tiles_transposed=True, fused_build=fused_build,
                    interpret=True)
    F1, F2 = _state(seed=4)[:2]
    members = [F1, F2] if batched else [F1]
    F = to_torch(np.stack(members)) if batched else to_torch(F1)
    before = dict(tmw.build_gather_windows.routes)
    got = tmw.build_gather_windows(F, ts)
    route = "one_pass" if fused_build else "two_pass"
    assert _routes_since(before) == {"one_pass": 0, "two_pass": 0,
                                     route: 1}
    rows = got if batched else got[None]
    assert rows.shape == (len(members), NX * NX, ts.K)
    for w, Fm in zip(rows, members):
        assert_equal(w, jpw.build_gather_windows(to_jax(Fm), js))


@pytest.mark.parametrize("fused_build", [False, True])
def test_build_that_needs_a_gradient_keeps_its_form(fused_build):
    """A build that needs a gradient is counted under the form
    spec.fused_build names, and gives that form's rows and gradient."""
    _, ts = _specs(nf=2, margin=1, grad_from_interp=True,
                   fused_build=fused_build)
    F = to_torch(_state(seed=6)[0][:2]).requires_grad_(True)
    before = dict(tmw.build_gather_windows.routes)
    W = tmw.build_gather_windows(F, ts)
    route = "one_pass" if fused_build else "two_pass"
    assert _routes_since(before) == {"one_pass": 0, "two_pass": 0,
                                     route: 1}
    assert W.requires_grad
    assert torch.equal(W.detach(),
                       tmw.build_margin_windows(F.detach(), ts).t())
    # each row entry is a copy of one field value: the gradient of the sum
    # counts how often each value is copied, SW^2 times
    (g,) = torch.autograd.grad(W.sum(), F)
    assert torch.equal(g, torch.full_like(g, float(ts.SW ** 2)))


def test_build_routes_count_into_one_table():
    """The counter's keys are the two routes; every call adds one to one
    of them, single and batched, also through a wrapper put in the
    function's place (as a profiler's span wrapper is)."""
    _, ts = _specs(nf=2, margin=1, grad_from_interp=True)
    assert tmw.build_gather_windows.routes is tmw._BUILD_ROUTES_TAKEN
    assert set(tmw.build_gather_windows.routes) == {"one_pass", "two_pass"}
    F = to_torch(_state(seed=7)[0][:2])
    inner = tmw.build_gather_windows

    def wrapped(*args):
        return inner(*args)

    before = dict(tmw.build_gather_windows.routes)
    inner(F, ts)
    inner(torch.stack([F, F]), ts)
    wrapped(F, ts._replace(fused_build=True))
    wrapped(torch.stack([F, F, F]), ts._replace(fused_build=True))
    with torch.no_grad():
        inner(F, ts)
    assert _routes_since(before) == {"one_pass": 2, "two_pass": 3}


def test_margins_equal():
    for args in [(0.1, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 0.5)]:
        assert tmw.required_margin(*args) == jpw.required_margin(*args)
    assert tmw.required_margin(1.0, 1.0, 1.0, 0.5, headroom=1.0) == 4
    assert tmw.required_margin(5.0, 1.0, 1.0, 0.1, nx=32) == \
        jpw.required_margin(5.0, 1.0, 1.0, 0.1, nx=32) == 13
    for nx in (8, 9, 32, 512):
        assert tmw.max_margin(nx) == jpw.max_margin(nx)
    _, ts = _specs(margin=2, nf=2, grad_from_interp=True)
    assert (ts.S, ts.SW, ts.K) == (6, 10, 200)


def test_packet_cells_equal_with_edges():
    """Floored modulo and its floating-point edge: x = -1e-18 gives
    mod(x/dx, nx) == nx exactly, so the cell is wrapped from nx to 0;
    x = L sits at cell 0 too."""
    js, ts = _specs()
    rng = np.random.default_rng(1)
    x = rng.uniform(-3 * L, 3 * L, (2, 500))
    x[:, 0] = [-1e-18, L]
    x[:, 1] = [L, -1e-18]
    x[:, 2] = [0.0, np.nextafter(L, 0)]
    x[:, 3] = [DX, -DX]
    oi, oj = tmw.packet_cells(to_torch(x[0]), to_torch(x[1]), ts)
    joi, joj = jpw.packet_cells(to_jax(x[0]), to_jax(x[1]), js)
    assert oi.dtype == torch.int32
    assert_equal(oi, joi)
    assert_equal(oj, joj)
    assert oi[:2].tolist() == [0, 0] and oj[:2].tolist() == [0, 0]
    assert 0 <= int(oi.min()) and int(oi.max()) < NX


@pytest.mark.parametrize("transposed", [False, True])
def test_gather_packet_windows_equal(transposed):
    """The port's row gather from (ncells, K) rows against the JAX
    package's gather of columns (K, ncells) or of rows."""
    js, ts = _specs(tiles_transposed=transposed)
    F1, _, x, _ = _state()
    W = jpw.build_margin_windows(to_jax(F1), js)
    oi, oj = jpw.packet_cells(to_jax(x[0]), to_jax(x[1]), js)
    want = jpw.gather_packet_windows(W.T if transposed else W, oi, oj, js)
    got = tmw.gather_packet_windows(to_torch(W.T), to_torch(oi),
                                    to_torch(oj), ts)
    assert got.shape == (NP, ts.K)
    assert_equal(got, want if transposed else want.T)


# ---------------------------------------------------------------------------
# the march's plain version against JAX
# ---------------------------------------------------------------------------

def test_lagrange_weights_equal():
    fr = np.random.default_rng(7).uniform(0, 1, 64)
    for tf, jf in ((tmw._lagrange_ws, jpw._lagrange_ws),
                   (tmw._lagrange_dws, jpw._lagrange_dws)):
        got = torch.stack(tf(to_torch(fr), 2))
        assert_close(got, jnp.stack(jf(to_jax(fr), 2)), rtol=1e-15,
                     atol=1e-16)
    np.testing.assert_allclose(
        to_numpy(torch.stack(tmw._lagrange_ws(to_torch(fr), 2)).sum(0)), 1.0,
        rtol=1e-14)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("combined", [False, True])
@pytest.mark.parametrize("nf", [2, 6])
@pytest.mark.parametrize("stepper", ["rk23", "rk4", "symplectic"])
def test_march_reference_matches_jax(stepper, nf, combined, transposed):
    js, ts = _specs(stepper=stepper, margin=2, nf=nf,
                    grad_from_interp=nf == 2, combined_gather=combined,
                    tiles_transposed=transposed)
    state = _state()
    sub_dt = 0.2 * DX
    want, ov_want = jpw.march_reference(*_jax_inputs(js, *state), sub_dt, js)
    win1, win2, xk, oi, oj = tin = _torch_inputs(ts, *state)
    got, ov = tmw.march_reference(tmw.gather_packet_windows(win1, oi, oj, ts),
                                  tmw.gather_packet_windows(win2, oi, oj, ts),
                                  xk, oi, oj, sub_dt, ts)
    assert_close(got, want, atol=ATOL)
    assert ov.dtype == torch.int32
    assert_equal(ov, ov_want)
    assert int(ov.max()) == 0
    # the differentiable entry point takes the same path on a CPU tensor
    fused, ov_f = tmw.fused_march_gathered(*tin, sub_dt, ts)
    assert_equal(fused, to_numpy(got))
    assert_equal(ov_f, to_numpy(ov))


@pytest.mark.parametrize("stepper,transposed", [("rk23", False),
                                                ("rk23", True),
                                                ("symplectic", False),
                                                ("symplectic", True)])
def test_march_matches_pallas_interpret(stepper, transposed):
    """Against the TPU kernel itself: march_pallas in interpret mode."""
    js, ts = _specs(stepper=stepper, margin=1, interpret=True,
                    tiles_transposed=transposed)
    state = _state()
    sub_dt = 0.1 * DX
    jin = _jax_inputs(js, *state)
    want, ov_want = jax.jit(lambda *a: jpw.march_pallas(*a, js))(*jin, sub_dt)
    got, ov = tmw.fused_march_gathered(*_torch_inputs(ts, *state), sub_dt,
                                       ts)
    assert_close(got, want, atol=ATOL)
    assert_equal(ov, ov_want)


@pytest.mark.parametrize("nf", [2, 6])
def test_march_matches_pallas_interpret_combined(nf):
    """The JAX main path's layout (combined gather, transposed tiles, uv
    windows) against march_pallas in interpret mode."""
    js, ts = _specs(stepper="rk23", margin=1, interpret=True,
                    tiles_transposed=True, combined_gather=True, nf=nf,
                    grad_from_interp=nf == 2, n_substeps=2)
    state = _state(seed=3)
    sub_dt = 0.1 * DX
    jin = _jax_inputs(js, *state)
    want, ov_want = jax.jit(lambda *a: jpw.march_pallas(*a, js))(*jin, sub_dt)
    got, ov = tmw.fused_march_gathered(*_torch_inputs(ts, *state), sub_dt,
                                       ts)
    assert_close(got, want, atol=ATOL)
    assert_equal(ov, ov_want)


@pytest.mark.parametrize("stepper", ["rk23", "rk4", "symplectic"])
def test_forced_overflow_equal(stepper):
    """A substep so long that packets leave the margin: the overflow is
    the MAX excess over stages and substeps, and the clamped arithmetic
    still agrees."""
    js, ts = _specs(stepper=stepper, margin=1)
    state = _state()
    sub_dt = 5.0 * DX
    want, ov_want = jpw.march_reference(*_jax_inputs(js, *state), sub_dt, js)
    got, ov = tmw.march_gathered_reference(*_torch_inputs(ts, *state), sub_dt,
                                           ts)
    assert int(ov.max()) > 0
    assert_equal(ov, ov_want)
    assert_close(got, want, atol=1e-10)  # |x| has grown to O(100)


def test_mod_floor_edges_in_march():
    """Packets at x = -1e-18 (mod gives exactly nx), x = L, and just
    inside a cell edge: origin cell and in-march cell must agree, so the
    drift is 0 and nothing overflows at sub_dt = 0; a moving step agrees
    with JAX."""
    js, ts = _specs(margin=1)
    F1, F2, x, k = _state()
    x[:, 0] = [-1e-18, L]
    x[:, 1] = [L, -1e-18]
    x[:, 2] = [np.nextafter(DX, 0), np.nextafter(DX, 1)]
    x[:, 3] = [3 * DX, 7 * DX]
    for sub_dt in (0.0, 0.1 * DX):
        want, ov_want = jpw.march_reference(
            *_jax_inputs(js, F1, F2, x, k), sub_dt, js)
        got, ov = tmw.march_gathered_reference(
            *_torch_inputs(ts, F1, F2, x, k), sub_dt, ts)
        assert_close(got, want, atol=ATOL)
        assert_equal(ov, ov_want)
    assert int(ov.max()) == 0


@pytest.mark.parametrize("stepper", ["rk23", "rk4", "symplectic"])
def test_freeze_is_identity(stepper):
    _, ts = _specs(stepper=stepper, nf=2, grad_from_interp=True,
                   combined_gather=True, tiles_transposed=True)
    F1, F2, x, k = _state()
    out, ov = tmw.fused_march_gathered(*_torch_inputs(ts, F1, F2, x, k), 0.0,
                                       ts)
    assert_equal(out[:2], x)   # bit for bit
    assert_equal(out[2:], k)
    assert int(ov.max()) == 0


def test_bad_specs_raise():
    _, ts = _specs()
    tin = _torch_inputs(ts, *_state())
    with pytest.raises(ValueError, match="nf"):
        tmw.march_gathered_reference(*tin, 0.1,
                                     ts._replace(grad_from_interp=True))
    with pytest.raises(ValueError, match="stepper"):
        tmw.march_gathered_reference(*tin, 0.1, ts._replace(stepper="euler"))


# ---------------------------------------------------------------------------
# transpose
# ---------------------------------------------------------------------------

def test_transpose_matches_pallas_transpose_interpret():
    W = np.random.default_rng(0).standard_normal((24, 64))
    want = jpw.pallas_transpose(to_jax(W), block=16, interpret=True)
    for fn in (tmw.transpose_reference, tmw.window_transpose):
        got = fn(to_torch(W))
        assert got.is_contiguous()
        assert_equal(got, want)
    back = jpw.pallas_transpose(want, block=16, interpret=True)
    assert_equal(tmw.window_transpose(tmw.window_transpose(to_torch(W))),
                 back)


def test_window_transpose_gradient():
    W = np.random.default_rng(1).standard_normal((24, 64))

    def loss_j(W_):
        return jnp.sum(jnp.sin(jpw.pallas_transpose(W_, 16, True)) ** 2)

    Wt = to_torch(W).requires_grad_(True)
    (torch.sin(tmw.window_transpose(Wt)) ** 2).sum().backward()
    assert_close(Wt.grad, jax.grad(loss_j)(to_jax(W)), rtol=1e-12,
                 atol=1e-12)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _loss_j(out):
    return jnp.sum(out[2:] ** 2) + jnp.sum(jnp.sin(out[:2]))


def _loss_t(out):
    return (out[2:] ** 2).sum() + torch.sin(out[:2]).sum()


def test_fused_march_gradients_split():
    """Gradients w.r.t. both field stacks, positions and wavevectors
    through window build, transpose and the march that reads its rows by
    cell, against jax.grad of JAX's window build, gather and march (its
    custom-VJP path, Pallas forward in interpret mode). Sums of O(100)
    float64 terms per entry: rtol 1e-9."""
    js, ts = _specs(margin=2, interpret=True, tiles_transposed=True,
                    n_substeps=1)
    F1, F2, x, k = _state()
    sub_dt = 0.2 * DX

    def loss_jax(F1_, F2_, x_, k_):
        W1 = jpw.build_margin_windows(F1_, js).T
        W2 = jpw.build_margin_windows(F2_, js).T
        oi, oj = jpw.packet_cells(x_[0], x_[1], js)
        pw1 = jpw.gather_packet_windows(W1, oi, oj, js)
        pw2 = jpw.gather_packet_windows(W2, oi, oj, js)
        out, _ = jpw.fused_march(pw1, pw2, jnp.concatenate([x_, k_]), oi, oj,
                                 sub_dt, js, True)
        return _loss_j(out)

    want = jax.jit(jax.grad(loss_jax, argnums=(0, 1, 2, 3)))(
        *map(to_jax, (F1, F2, x, k)))

    leaves = [to_torch(a).requires_grad_(True) for a in (F1, F2, x, k)]
    tF1, tF2, tx, tk = leaves
    W1 = tmw.build_gather_windows(tF1, ts)
    W2 = tmw.build_gather_windows(tF2, ts)
    oi, oj = tmw.packet_cells(tx[0], tx[1], ts)
    out, ov = tmw.fused_march_gathered(W1, W2, torch.cat([tx, tk]), oi, oj,
                                       sub_dt, ts)
    assert not ov.requires_grad
    _loss_t(out).backward()
    for leaf, w, name in zip(leaves, want, "F1 F2 x k".split()):
        assert_close(leaf.grad, w, rtol=1e-9, atol=1e-10, err_msg=name)


def test_fused_march_gradients_uv_combined_and_dt():
    """uv windows against the JAX main path's combined gather: gradients
    w.r.t. the fields, xk and the substep length."""
    js, ts = _specs(margin=2, interpret=True, tiles_transposed=True, nf=2,
                    grad_from_interp=True, combined_gather=True,
                    n_substeps=1)
    F1, F2, x, k = _state()
    xk = np.concatenate([x, k])
    sub_dt = 0.2 * DX
    joi, joj = jpw.packet_cells(to_jax(x[0]), to_jax(x[1]), js)

    def loss_jax(F1_, F2_, xk_, dt_):
        W1 = jpw.build_margin_windows(F1_, js)
        W2 = jpw.build_margin_windows(F2_, js)
        pwc = jpw.gather_packet_windows(
            jnp.concatenate([W1, W2], axis=0).T, joi, joj, js)
        out, _ = jpw.fused_march(pwc, jnp.zeros((1, 1)), xk_, joi, joj, dt_,
                                 js, True)
        return _loss_j(out)

    want = jax.jit(jax.grad(loss_jax, argnums=(0, 1, 2, 3)))(
        to_jax(F1), to_jax(F2), to_jax(xk), jnp.asarray(sub_dt))

    tF1, tF2, txk = (to_torch(a).requires_grad_(True) for a in (F1, F2, xk))
    tdt = torch.tensor(sub_dt, dtype=torch.float64, requires_grad=True)
    toi, toj = to_torch(joi), to_torch(joj)
    out, _ = tmw.fused_march_gathered(tmw.build_gather_windows(tF1, ts),
                                      tmw.build_gather_windows(tF2, ts),
                                      txk, toi, toj, tdt, ts)
    _loss_t(out).backward()
    for leaf, w, name in zip((tF1, tF2, txk, tdt), want,
                             "F1 F2 xk sub_dt".split()):
        assert_close(leaf.grad, w, rtol=1e-9, atol=1e-10, err_msg=name)


# ---------------------------------------------------------------------------
# the CUDA wrappers cannot be reached from CPU tensors
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    _, ts = _specs()
    tin = _torch_inputs(ts, *_state())
    with pytest.raises(ValueError, match="CUDA"):
        tmw.march_gathered_cuda(*tin, 0.1, ts)
    with pytest.raises(ValueError, match="CUDA"):
        tmw.transpose_cuda(torch.zeros(4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tmw.build_windows_cuda(torch.zeros(6, NX, NX, dtype=torch.float64),
                               ts)
    assert tmw.march_gathered_cuda.launches == 0
    assert tmw.transpose_cuda.launches == 0
    assert tmw.build_windows_cuda.launches == 0
