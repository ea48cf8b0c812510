"""The march that reads its window rows by cell
(swraytracing_torch.ops.march_window.march_gathered_reference,
fused_march_gathered, and the lock-step that calls them) against the JAX
package's gather + march on the same numpy inputs (CPU, float64). On the
CPU the port runs the kernel's plain version; the JAX side runs its XLA
reference and the Pallas march kernel in interpret mode."""

import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swraytracing_tpu.ops import pallas_window as jpw
from swraytracing_torch import kernels
from swraytracing_torch.models import coupled as tcp
from swraytracing_torch.models import coupled2 as tc2
from swraytracing_torch.ops import march_window as tmw

from torch_parity import (L, to_jax, to_torch, to_numpy, assert_close,
                          assert_equal, smooth_fields)

NX = 16          # 256 cells
NP = 512         # two packets a cell on average; four Pallas blocks
DX = L / NX

# A few hundred float64 multiply-adds per stage on O(1) values; the two
# frameworks differ only in the order of the window sums.
ATOL = 1e-12


def _specs(**kw):
    """The same march configuration for both packages, (ncells, K) rows."""
    common = dict(nx=NX, ny=NX, dx=DX, dy=DX, f=3.0, Cg=1.0, n_substeps=2,
                  tiles_transposed=True)
    common.update(kw)
    common["grad_from_interp"] = common.get("nf", 6) == 2
    return (jpw.MarchSpec(interpret=True, block=128, **common),
            tmw.MarchSpec(**common))


def _state(seed=0, n=NP):
    rng = np.random.default_rng(seed)
    F1 = smooth_fields(rng, 6, NX)
    F2 = smooth_fields(rng, 6, NX)
    x = rng.uniform(0, L, (2, n))
    k = rng.normal(0, 3.0, (2, n))
    # mod/floor edges: just below 0, exactly L, around a cell edge; and
    # eight packets in one cell
    x[:, 0] = [-1e-18, L]
    x[:, 1] = [L, -1e-18]
    x[:, 2] = [np.nextafter(DX, 0), np.nextafter(DX, 1)]
    x[:, 8:16] = (np.array([[3.0], [5.0]])
                  + rng.uniform(0.05, 0.95, (2, 8))) * DX
    return F1, F2, x, k


def _jax_gathered(js, F1, F2, x, k):
    """(pw1, pw2, xk, oi, oj): the JAX package's two row gathers."""
    F1, F2, x, k = map(to_jax, (F1, F2, x, k))
    W1 = jpw.build_margin_windows(F1, js).T
    W2 = jpw.build_margin_windows(F2, js).T
    oi, oj = jpw.packet_cells(x[0], x[1], js)
    return (jpw.gather_packet_windows(W1, oi, oj, js),
            jpw.gather_packet_windows(W2, oi, oj, js),
            jnp.concatenate([x, k], axis=0), oi, oj)


def _torch_windows(ts, F1, F2, x, k):
    """(win1, win2, xk, oi, oj): the two cell-window arrays themselves."""
    F1, F2, x, k = map(to_torch, (F1, F2, x, k))
    oi, oj = tmw.packet_cells(x[0], x[1], ts)
    return (tmw.build_gather_windows(F1, ts), tmw.build_gather_windows(F2, ts),
            torch.cat([x, k], dim=0), oi, oj)


# ---------------------------------------------------------------------------
# (a) the plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("margin", [1, 2])
@pytest.mark.parametrize("nf", [2, 6])
@pytest.mark.parametrize("stepper", ["rk23", "rk4", "symplectic"])
def test_gathered_reference_matches_jax_and_pallas(stepper, nf, margin):
    js, ts = _specs(stepper=stepper, nf=nf, margin=margin)
    state = _state(seed=margin)
    sub_dt = 0.1 * margin * DX
    jin = _jax_gathered(js, *state)
    want, ov_want = jpw.march_reference(*jin, sub_dt, js)
    tin = _torch_windows(ts, *state)
    assert tin[0].shape == (NX * NX, ts.K)
    got, ov = tmw.march_gathered_reference(*tin, sub_dt, ts)
    assert_close(got, want, atol=ATOL)
    assert ov.dtype == torch.int32
    assert_equal(ov, ov_want)
    assert int(ov.max()) == 0
    # against the TPU kernel itself, in interpret mode
    kern, ov_kern = jax.jit(lambda *a: jpw.march_pallas(*a, js))(*jin, sub_dt)
    assert_close(got, kern, atol=ATOL)
    assert_equal(ov, ov_kern)
    # the differentiable entry point takes the same path on CPU tensors
    fused, ov_f = tmw.fused_march_gathered(*tin, sub_dt, ts)
    assert_equal(fused, to_numpy(got))
    assert_equal(ov_f, to_numpy(ov))


@pytest.mark.parametrize("stepper", ["rk23", "symplectic"])
def test_gathered_forced_overflow_and_freeze(stepper):
    """A substep that leaves the margin: equal overflow (the MAX over stages
    and substeps) and agreeing clamped arithmetic; sub_dt = 0 returns xk
    bit for bit."""
    js, ts = _specs(stepper=stepper, nf=2, margin=1)
    state = _state(seed=5)
    jin = _jax_gathered(js, *state)
    tin = _torch_windows(ts, *state)
    want, ov_want = jpw.march_reference(*jin, 5.0 * DX, js)
    got, ov = tmw.march_gathered_reference(*tin, 5.0 * DX, ts)
    assert int(ov.max()) > 0
    assert_equal(ov, ov_want)
    assert_close(got, want, rtol=1e-12, atol=1e-10)  # |x| grows to O(1000)
    same, ov0 = tmw.fused_march_gathered(*tin, 0.0, ts)
    assert_equal(same, to_numpy(tin[2]))
    assert int(ov0.max()) == 0


# ---------------------------------------------------------------------------
# (b) bit equality with the port's pre-gathered route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combined", [True, False])
@pytest.mark.parametrize("stepper", ["rk23", "rk4", "symplectic"])
def test_gathered_reference_equals_pregathered_bits(stepper, combined):
    """Stacking the two snapshots before one gather and splitting them
    again moves no bit, so the gathered march equals the pre-gathered one
    for either value of combined_gather; and spec.combined_gather is not
    read by the gathered entry."""
    _, ts = _specs(stepper=stepper, nf=2, margin=2, combined_gather=combined)
    win1, win2, xk, oi, oj = _torch_windows(ts, *_state(seed=2))
    sub_dt = 0.2 * DX
    if combined:
        pwc = tmw.gather_packet_windows(torch.cat([win1, win2], dim=-1),
                                        oi, oj, ts)
        want, ov_want = tmw.march_reference(
            pwc, torch.zeros((1, 1), dtype=xk.dtype), xk, oi, oj, sub_dt, ts)
    else:
        want, ov_want = tmw.march_reference(
            tmw.gather_packet_windows(win1, oi, oj, ts),
            tmw.gather_packet_windows(win2, oi, oj, ts), xk, oi, oj, sub_dt,
            ts)
    got, ov = tmw.march_gathered_reference(win1, win2, xk, oi, oj, sub_dt,
                                           ts)
    assert torch.equal(got, want) and torch.equal(ov, ov_want)
    other, _ = tmw.march_gathered_reference(
        win1, win2, xk, oi, oj, sub_dt,
        ts._replace(combined_gather=not combined))
    assert torch.equal(other, got)


def test_gathered_reference_takes_the_column_layout_too():
    """(K, ncells) arrays: the plain version gathers columns. Same values;
    the window sums run over another memory order, so not the same bits."""
    _, ts = _specs(nf=6, margin=1)
    win1, win2, xk, oi, oj = _torch_windows(ts, *_state(seed=4))
    want, ov_want = tmw.march_gathered_reference(win1, win2, xk, oi, oj,
                                                 0.1 * DX, ts)
    cols = ts._replace(tiles_transposed=False)
    got, ov = tmw.march_gathered_reference(
        win1.t().contiguous(), win2.t().contiguous(), xk, oi, oj, 0.1 * DX,
        cols)
    assert_close(got, to_numpy(want), atol=1e-13)
    assert torch.equal(ov, ov_want)


# ---------------------------------------------------------------------------
# (c) gradients
# ---------------------------------------------------------------------------

def _loss_j(out):
    return jnp.sum(out[2:] ** 2) + jnp.sum(jnp.sin(out[:2]))


def _loss_t(out):
    return (out[2:] ** 2).sum() + torch.sin(out[:2]).sum()


@pytest.mark.parametrize("nf,stepper", [(2, "rk23"), (6, "rk23"),
                                        (2, "symplectic")])
def test_fused_march_gathered_gradients(nf, stepper):
    """Cotangents of win1, win2 (a scatter-add over the packets that share
    a cell: 512 packets on 256 cells, eight planted in one), xk and a
    tensor sub_dt against jax.grad through gather + fused_march (Pallas
    forward in interpret mode, its custom VJP backward). Sums of O(100)
    float64 terms per entry: rtol 1e-10."""
    js, ts = _specs(stepper=stepper, nf=nf, margin=2, n_substeps=1)
    F1, F2, x, k = _state(seed=7)
    win1, win2, xk, oi, oj = _torch_windows(ts, F1, F2, x, k)
    sub_dt = 0.2 * DX
    cells = to_numpy(oi).astype(np.int64) * NX + to_numpy(oj)
    assert np.bincount(cells, minlength=NX * NX).max() >= 8
    joi, joj = to_jax(to_numpy(oi)), to_jax(to_numpy(oj))

    def loss_jax(W1, W2, xk_, dt_):
        pw1 = jpw.gather_packet_windows(W1, joi, joj, js)
        pw2 = jpw.gather_packet_windows(W2, joi, joj, js)
        out, _ = jpw.fused_march(pw1, pw2, xk_, joi, joj, dt_, js, True)
        return _loss_j(out)

    want = jax.jit(jax.grad(loss_jax, argnums=(0, 1, 2, 3)))(
        to_jax(to_numpy(win1)), to_jax(to_numpy(win2)), to_jax(to_numpy(xk)),
        jnp.asarray(sub_dt))

    leaves = [t.clone().requires_grad_(True) for t in (win1, win2, xk)]
    tdt = torch.tensor(sub_dt, dtype=torch.float64, requires_grad=True)
    out, ov = tmw.fused_march_gathered(*leaves, oi, oj, tdt, ts)
    assert not ov.requires_grad
    _loss_t(out).backward()
    for leaf, w, name in zip((*leaves, tdt), want,
                             "win1 win2 xk sub_dt".split()):
        assert_close(leaf.grad, w, rtol=1e-10, atol=1e-12, err_msg=name)
    # rows of cells without a packet get no cotangent
    empty = np.setdiff1d(np.arange(NX * NX), cells)
    assert empty.size > 0
    assert not to_numpy(leaves[0].grad)[empty].any()


def test_fused_march_gathered_gradient_only_where_asked():
    """A float sub_dt and window arrays that need no gradient: only xk's
    cotangent is formed, and it equals the pre-gathered route's."""
    _, ts = _specs(nf=2, margin=1, n_substeps=1)
    win1, win2, xk, oi, oj = _torch_windows(ts, *_state(seed=9))
    a = xk.clone().requires_grad_(True)
    out, _ = tmw.fused_march_gathered(win1, win2, a, oi, oj, 0.1 * DX, ts)
    _loss_t(out).backward()
    b = xk.clone().requires_grad_(True)
    out_b, _ = tmw.fused_march(tmw.gather_packet_windows(win1, oi, oj, ts),
                               tmw.gather_packet_windows(win2, oi, oj, ts),
                               b, oi, oj, 0.1 * DX, ts)
    _loss_t(out_b).backward()
    assert torch.equal(a.grad, b.grad)
    assert win1.grad is None and win2.grad is None


# ---------------------------------------------------------------------------
# (d) the lock-step
# ---------------------------------------------------------------------------

_SMALL = dict(nx=32, n_packets=256, window_min_np=1, T_Fr_days=20.0,
              packet_delay_days=0.0, packet_steps_per_save=3)

_MODELS = {
    "two_layer": (tc2.Coupled2Config, tc2.setup_coupled2,
                  tc2.run_coupled2_chunk),
    "one_layer": (tcp.CoupledConfig, tcp.setup_coupled,
                  tcp.run_coupled_chunk),
}


def _run(model, monkeypatch=None, **kw):
    Config, setup, run_chunk = _MODELS[model]
    cfg = Config(**dict(_SMALL, **kw))
    s, carry = setup(cfg, device="cpu", dtype=torch.float64)
    cats = []
    if monkeypatch is not None:
        real_cat = torch.cat

        def recording_cat(tensors, *a, **k):
            cats.append([tuple(t.shape) for t in tensors])
            return real_cat(tensors, *a, **k)

        monkeypatch.setattr(torch, "cat", recording_cat)
    carry, (px, pk, _) = run_chunk(carry, s, cfg, 2)
    if monkeypatch is not None:
        monkeypatch.undo()
    return s, carry, px, pk, cats


@pytest.mark.parametrize("model", ["two_layer", "one_layer"])
def test_lockstep_same_bits_for_either_combined_gather(model, monkeypatch):
    """With (ncells, K) rows the lock-step marches straight from the two
    window arrays: march_combined_gather changes no bit, and torch.cat
    never sees a window array."""
    s, carry, px, pk, cats = _run(model, monkeypatch,
                                  march_combined_gather=True)
    s2, carry2, px2, pk2, _ = _run(model, march_combined_gather=False)
    assert s.march.combined_gather and not s2.march.combined_gather
    assert s.march.tiles_transposed
    assert torch.equal(px, px2) and torch.equal(pk, pk2)
    assert torch.equal(carry.flow_state.qk, carry2.flow_state.qk)
    assert int(carry.overflow) == int(carry2.overflow) == 0
    assert float((px[-1] - px[0]).abs().max()) > 0
    win = tuple(carry.prev_win.shape)
    assert win == (32 * 32, s.march.K)
    assert cats and not any(win in shapes for shapes in cats)


@pytest.mark.parametrize("combined", [True, False])
def test_lockstep_column_layout_keeps_its_gathers(combined):
    """A hand-made spec with (K, ncells) windows still gathers first (one
    gather or two) and reaches the same values (the window sums run over
    another memory order: 1e-13)."""
    cfg = tc2.Coupled2Config(**_SMALL)
    s, carry0 = tc2.setup_coupled2(cfg, device="cpu", dtype=torch.float64)
    want = tc2.coupled2_flow_packet_step(carry0, s, cfg)
    cols = s._replace(march=s.march._replace(tiles_transposed=False,
                                             combined_gather=combined))
    before = tmw.gather_packet_windows.calls
    got = tc2.coupled2_flow_packet_step(carry0, cols, cfg)
    assert tmw.gather_packet_windows.calls - before == (1 if combined else 2)
    assert_close(got.packet_x, to_numpy(want.packet_x), atol=1e-13)
    assert_close(got.packet_k, to_numpy(want.packet_k), atol=1e-13)
    assert float((got.packet_x - carry0.packet_x).abs().max()) > 0


# ---------------------------------------------------------------------------
# (e) the CUDA wrapper refuses what its kernel does not take
# ---------------------------------------------------------------------------

def _bad_win_shape(a):
    return (a[0][:, :-1].contiguous(), *a[1:])


def _bad_win_dtype(a):
    return (a[0], a[1].float(), *a[2:])


def _bad_xk(a):
    return (a[0], a[1], a[2][:3], a[3], a[4])


@pytest.mark.parametrize("breaker,spec_kw,match", [
    (None, {}, "CUDA"),
    (None, {"tiles_transposed": False}, "tiles_transposed"),
    (_bad_win_shape, {}, "`win1` must be"),
    (_bad_win_dtype, {}, "`win2` must be"),
    (_bad_xk, {}, "`xk` must be"),
])
def test_march_gathered_cuda_refuses(breaker, spec_kw, match):
    _, ts = _specs(nf=2, margin=1, **spec_kw)
    args = _torch_windows(ts._replace(tiles_transposed=True), *_state())
    if breaker is not None:
        args = breaker(args)
    with pytest.raises(ValueError, match=match):
        tmw.march_gathered_cuda(*args, 0.1, ts)
    assert tmw.march_gathered_cuda.launches == 0
    assert kernels._lib is None  # no build was attempted


def test_staged_launch_refuses_a_block_that_does_not_fit():
    """On the staged route a block's warps keep their rows in shared
    memory: too large a block raises and says what fits, before any
    build."""
    _, ts = _specs(nf=2, margin=1)
    xk = torch.zeros((4, 8), dtype=torch.float32)
    cells = torch.zeros((8,), dtype=torch.int32)
    launch = (tmw.march_gathered_cuda, 0, 0, ts.K, 1, True, xk, cells, cells,
              0.1)
    with pytest.raises(ValueError, match="at most 224"):
        tmw._launch_march(*launch, ts._replace(block=256), "staged")
    with pytest.raises(ValueError, match="multiple of 32"):
        tmw._launch_march(*launch, ts._replace(block=48), "direct")
    with pytest.raises(ValueError, match="route must be"):
        tmw._launch_march(*launch, ts, "fastest")
    assert kernels._lib is None
    assert tmw.march_gathered_cuda.launches_by_route == {"staged": 0,
                                                         "direct": 0,
                                                         "ring": 0}


def test_shared_memory_size_is_the_kernel_source_s():
    """The route rule and the kernel's own refusal rest on one number,
    written once in Python and once in the CUDA header."""
    header = (pathlib.Path(kernels.__file__).parent / "csrc"
              / "march.cuh").read_text()
    (found,) = re.findall(r"constexpr size_t SMEM_PER_SM = (\d+);", header)
    assert int(found) == tmw.SMEM_PER_SM == 227 * 1024


# ---------------------------------------------------------------------------
# (f) the route rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nf,margin,dtype,transposed,route", [
    (2, 1, torch.float32, True, "ring"),      # both coupled main paths
    (2, 2, torch.float32, True, "staged"),
    (6, 1, torch.float32, True, "staged"),    # two warps' rows an SM
    (2, 1, torch.float64, True, "staged"),    # three
    (6, 2, torch.float32, True, "staged"),    # 154 KB a warp: one
    (6, 2, torch.float64, True, "direct"),    # 307 KB a warp: fits nowhere
    (2, 1, torch.float32, False, "direct"),   # (K, Np): coalesced already
])
def test_march_route(nf, margin, dtype, transposed, route):
    spec = tmw.MarchSpec(nx=512, ny=512, dx=DX, dy=DX, f=3.0, Cg=1.0, nf=nf,
                         margin=margin, grad_from_interp=nf == 2,
                         tiles_transposed=transposed)
    assert tmw.march_route(spec, dtype) == route
    # the rule reads (2K, element size) and the layout, nothing else
    assert tmw.march_route(spec._replace(nx=64, ny=48, block=32,
                                         combined_gather=True,
                                         stepper="rk4"), dtype) == route
    warp_bytes = 32 * (2 * spec.K + 1) * (4 if dtype == torch.float32 else 8)
    assert tmw.staged_warp_bytes(spec, dtype) == warp_bytes
    limit = tmw.staged_block_limit(spec, dtype)
    assert limit == min(256, 32 * (tmw.SMEM_PER_SM // warp_bytes))
    # the default block fits wherever the rule says staged or ring (whose
    # rows fit a warp of the staged route too), and only there
    assert (spec.block <= limit) == (route in ("staged", "ring")
                                     or not transposed)
