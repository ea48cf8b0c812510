"""models/frozen.raytrace_rsw_restart's two routes, by the device alone:
on a CUDA device the x-k-a march kernel, one ops/march_rays.march_xka
call a frame (a dtype it has no kernel for raises, nothing falls back);
on the CPU the plain rk4_xka_step loop, bit for bit what it was. Also
rsw_restart_fields (the seven grids), march_xka's plain versions and the
spans.

The tests marked `card` need a CUDA device and skip without one. This
file imports no JAX, so on a machine with a card it runs on its own:
`python -m pytest tests/test_torch_rsw_route.py --noconftest -q`.
"""

import numpy as np
import pytest
import torch

from swraytracing_torch.models import examples, frozen, rays
from swraytracing_torch.models.dispersion import Dispersion
from swraytracing_torch.models.fields import GriddedFlow
from swraytracing_torch.models.rsw import RSWParams, wave_vortex_decompose
from swraytracing_torch.ops import march_rays as mr
from swraytracing_torch.ops import spectral as sp
from swraytracing_torch.ops.grid import SpectralGrid
from swraytracing_torch.utils import profiling

DISP = Dispersion(f=3.0, Cg=1.0)
P = RSWParams(f=3.0, Cg=1.0)
F64 = torch.float64
NX = 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def frame(nx=NX, seed=4):
    """A restart frame: the run_swkU.m wave bath and geostrophic flow."""
    (u, v, h), _ = examples.wave_and_geostrophic_spectrum_ic(
        SpectralGrid.square(nx), DISP.f, DISP.Cg, seed=seed)
    return u, v, h


def packets(n, device="cpu", dtype=F64, seed=3):
    x0, k0 = frozen.ring_ics(n, 2.0, DISP, seed=seed, device=device,
                             dtype=dtype)
    a0 = torch.as_tensor(np.random.default_rng(seed).uniform(0.5, 1.5, n),
                         dtype=dtype, device=device)
    return x0, k0, a0


def grids(nx=NX, device="cpu", dtype=F64):
    grid = SpectralGrid.square(nx)
    u, v, h = (torch.as_tensor(a, dtype=dtype, device=device)
               for a in frame(nx))
    return frozen.rsw_restart_fields(u, v, h, grid, P), grid


def fields_before(u, v, h, grid):
    """The grids raytrace_rsw_restart built before rsw_restart_fields:
    the six velocity grids and H."""
    (ug, vg, hg), _ = wave_vortex_decompose(u, v, h, grid, P)
    Sk = sp.to_spectral(torch.stack([ug, vg]), grid)
    fields = torch.cat([
        torch.stack([ug, vg]),
        sp.to_grid(torch.stack([sp.ddx(Sk[0], grid), sp.ddy(Sk[0], grid),
                                sp.ddx(Sk[1], grid), sp.ddy(Sk[1], grid)]),
                   grid)])
    return fields, 1.0 + hg


def before(u, v, h, grid, x0, k0, a0, dt, nsteps, save_every):
    """raytrace_rsw_restart as it stood before it had a kernel route (CPU,
    float64 tensors in)."""
    fields, H = fields_before(u, v, h, grid)
    flow = GriddedFlow(fields=fields, grid=grid)
    x, k, a = x0, k0, a0
    xs, ks, as_ = [], [], []
    for _ in range(nsteps // save_every):
        for _ in range(save_every):
            x, k, a = rays.rk4_xka_step(x, k, a, dt, DISP, flow, H=H)
        xs.append(x)
        ks.append(k)
        as_.append(a)
    ts = torch.tensor([dt * save_every * (1 + j)
                       for j in range(nsteps // save_every)],
                      dtype=torch.float64)

    def stack(frames, like):
        return (torch.stack(frames) if frames
                else like.new_zeros((0,) + tuple(like.shape)))

    return stack(xs, x), stack(ks, k), stack(as_, a), ts


def assert_same_bits(got, want):
    for name, a, b in zip("xkat", got, want):
        assert a.shape == b.shape and torch.equal(a, b), name


# -- on the CPU: the plain route, the rule, the grids, the spans -------------

def test_seven_grids_are_the_decomposition_used_before():
    grid = SpectralGrid.square(NX)
    u, v, h = (torch.as_tensor(a, dtype=F64) for a in frame())
    got = frozen.rsw_restart_fields(u, v, h, grid, P)
    fields, H = fields_before(u, v, h, grid)
    assert got.shape == (7, NX, NX)
    assert torch.equal(got[:6], fields) and torch.equal(got[6], H)
    # the depth factor is 1 + eta_g, and the balanced flow is not zero
    assert 0.5 < float(got[6].min()) < 1.0 < float(got[6].max()) < 1.5
    assert float(got[0].abs().max()) > 0.1


@pytest.mark.parametrize("with_a0", [False, True])
@pytest.mark.parametrize("nsteps, save_every", [(40, 10), (45, 20), (0, 10),
                                                (7, 20)])
def test_plain_route_is_bit_for_bit_what_it_was(with_a0, nsteps,
                                                save_every):
    grid = SpectralGrid.square(NX)
    u, v, h = (torch.as_tensor(a, dtype=F64) for a in frame())
    x0, k0, a0 = packets(48)
    kept = dict(frozen.raytrace_rsw_restart.routes)
    got = frozen.raytrace_rsw_restart(
        u, v, h, DISP, grid, x0, k0, a0 if with_a0 else None, dt=2e-3,
        nsteps=nsteps, save_every=save_every, device="cpu", dtype=F64)
    want = before(u, v, h, grid, x0, k0,
                  a0 if with_a0 else torch.ones_like(x0[0]), 2e-3, nsteps,
                  save_every)
    assert_same_bits(got, want)
    assert got[0].shape == (nsteps // save_every, 2, 48)
    assert frozen.raytrace_rsw_restart.routes == dict(
        kept, plain=kept["plain"] + 1)


def test_route_rule():
    for device in ("cuda", "cuda:0", torch.device("cuda", 1)):
        assert frozen.rsw_route(device) == "kernel", device
    for device in ("cpu", torch.device("cpu")):
        assert frozen.rsw_route(device) == "plain", device


def test_routes_count_every_call():
    grid = SpectralGrid.square(32)
    u, v, h = frame(32)
    x0, k0, _ = packets(16)
    kept = dict(frozen.raytrace_rsw_restart.routes)
    for dtype in (torch.float32, F64, torch.float32):
        frozen.raytrace_rsw_restart(u, v, h, DISP, grid, x0, k0, dt=2e-3,
                                    nsteps=4, save_every=2, device="cpu",
                                    dtype=dtype)
    assert frozen.raytrace_rsw_restart.routes == {
        "kernel": kept["kernel"], "plain": kept["plain"] + 3}


@pytest.mark.parametrize("nsteps, save_every", [(40, 10), (45, 20), (0, 10)])
def test_kernel_route_frames_on_the_cpu(nsteps, save_every, monkeypatch):
    """The kernel route's body on CPU tensors, where march_xka runs its
    plain version: the plain route's frames bit for bit, at 64^2 with 4096
    packets in float64."""
    grid = SpectralGrid.square(NX)
    u, v, h = frame()
    x0, k0, a0 = packets(4096)
    want = frozen.raytrace_rsw_restart(u, v, h, DISP, grid, x0, k0, a0,
                                       dt=1e-3, nsteps=nsteps,
                                       save_every=save_every, device="cpu",
                                       dtype=F64)
    kept = dict(frozen.raytrace_rsw_restart.routes)
    monkeypatch.setattr(frozen, "rsw_route", lambda *a: "kernel")
    got = frozen.raytrace_rsw_restart(u, v, h, DISP, grid, x0, k0, a0,
                                      dt=1e-3, nsteps=nsteps,
                                      save_every=save_every, device="cpu",
                                      dtype=F64)
    assert frozen.raytrace_rsw_restart.routes == dict(
        kept, kernel=kept["kernel"] + 1)
    assert_same_bits(got, want)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_reference_is_the_step_loop(order):
    fields, grid = grids()
    x0, k0, a0 = packets(200)
    flow = GriddedFlow(fields=fields[:6].clone(), grid=grid, order=order)
    x, k, a = x0, k0, a0
    for _ in range(30):
        x, k, a = rays.rk4_xka_step(x, k, a, 2e-3, DISP, flow,
                                    H=fields[6].clone())
    got = mr.march_xka_reference(fields, x0, k0, a0, grid, DISP, 2e-3, 30,
                                 order)
    for g, w in zip(got, (x, k, a)):
        assert torch.equal(g, w)
    # march_xka on CPU tensors is the plain version
    for g, w in zip(mr.march_xka(fields, x0, k0, a0, grid, DISP, 2e-3, 30,
                                 order), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("segment", [1, 7, 30, 100])
def test_segmented_reference(segment):
    """The split of the steps alone is the step loop bit for bit; ordered
    by cell, the same to the rounding of the stencil sum (PyTorch's CPU
    sum groups its terms by an element's place in the vector)."""
    fields, grid = grids()
    x0, k0, a0 = packets(300)
    want = mr.march_xka_reference(fields, x0, k0, a0, grid, DISP, 5e-3, 30)
    split = mr.march_xka_segmented_reference(
        fields, x0, k0, a0, grid, DISP, 5e-3, 30, segment=segment,
        ordered=False)
    for g, w in zip(split, want):
        assert torch.equal(g, w)
    ordered = mr.march_xka_segmented_reference(
        fields, x0, k0, a0, grid, DISP, 5e-3, 30, segment=segment)
    for g, w in zip(ordered, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    assert float((want[0] - x0).abs().max()) > 1e-2


def test_kernel_wrapper_refuses_cpu_tensors():
    fields, grid = grids(32)
    x0, k0, a0 = packets(10)
    with pytest.raises(ValueError, match="CUDA"):
        mr.march_xka_cuda(fields, x0, k0, a0, grid, DISP, 1e-3, 5)
    with pytest.raises(ValueError, match="order"):
        mr.march_xka_cuda(fields, x0, k0, a0, grid, DISP, 1e-3, 5, order=4)
    with pytest.raises(ValueError, match=r"\(7, 32, 32\)"):
        mr.march_xka_cuda(fields[:6], x0, k0, a0, grid, DISP, 1e-3, 5)


def test_node_major_fields_puts_h_in_lane_6():
    fields, _ = grids(16)
    nodes = mr.node_major_fields(fields)
    assert nodes.shape == (16, 16, 8)
    assert torch.equal(nodes[..., 6], fields[6])
    assert torch.equal(nodes[..., :6], fields[:6].permute(1, 2, 0))
    assert not nodes[..., 7].any()
    with pytest.raises(ValueError, match="at most 8"):
        mr.node_major_fields(torch.zeros(9, 4, 4))


def test_spans_only_while_open():
    grid = SpectralGrid.square(32)
    u, v, h = frame(32)
    x0, k0, _ = packets(20)
    kw = dict(dt=2e-3, nsteps=30, save_every=10, device="cpu", dtype=F64)
    with profiling.spans() as table:
        frozen.raytrace_rsw_restart(u, v, h, DISP, grid, x0, k0, **kw)
    assert {n: r["calls"] for n, r in table.items()} == {
        "swr.rsw": 1, "swr.rsw.fields": 1, "swr.rsw.march": 3}
    with profiling.spans() as after:
        pass
    frozen.raytrace_rsw_restart(u, v, h, DISP, grid, x0, k0, **kw)
    assert after == {} and profiling._table is None


# -- on the card: the kernel against its plain version -----------------------

# 256^2 and dt 1e-3 give segments of 24 steps, so 60 steps are three
# launches. float64 to 1e-10 absolute on x and k and relative on a; float32
# to 2e-5 absolute on x (O(2 pi)) and k (O(5)) and relative on a (O(1)):
# ~30 float32 rounding steps of each, over four stencils a step
CARD_NX = 256
TOL = {torch.float64: 1e-10, torch.float32: 2e-5}


def card_inputs(card, dtype, n, nx=CARD_NX):
    fields, grid = grids(nx, card, dtype)
    return (fields, grid) + packets(n, card, dtype, seed=n)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_kernel_matches_its_plain_version(card, dtype, order):
    fields, grid, x0, k0, a0 = card_inputs(card, dtype, 3000)
    launches = mr.march_xka_cuda.launches
    got = mr.march_xka_cuda(fields, x0, k0, a0, grid, DISP, 1e-3, 60, order)
    segments = mr.split_steps(60, mr.segment_steps(1e-3, grid, DISP))
    assert mr.march_xka_cuda.launches - launches == len(segments) > 1
    want = mr.march_xka_reference(fields, x0, k0, a0, grid, DISP, 1e-3, 60,
                                  order)
    tol = TOL[dtype]
    for name, g, w in zip("xka", got, want):
        assert g.dtype == dtype and g.is_cuda, name
        rtol, atol = (tol, 0) if name == "a" else (0, tol)
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=name)
    assert float((got[0] - x0).abs().max()) > 1e-2
    assert float((got[2] - a0).abs().max()) > 1e-6


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ordered_segments_are_one_launch_bit_for_bit(card, dtype):
    fields, grid, x0, k0, a0 = card_inputs(card, dtype, 2 ** 16 + 37)
    one = mr.march_xka_cuda_by(fields, x0, k0, a0, grid, DISP, 1e-3, 70,
                               segment=70, ordered=False)
    for segment in (None, 9):
        got = mr.march_xka_cuda_by(fields, x0, k0, a0, grid, DISP, 1e-3,
                                   70, segment=segment)
        for name, g, w in zip("xka", got, one):
            assert torch.equal(g, w), (name, segment)


@pytest.mark.card
@pytest.mark.parametrize("nsteps, save_every", [(40, 10), (45, 20), (0, 10),
                                                (100, 45)])
def test_kernel_route_matches_the_plain_route(card, nsteps, save_every):
    """At 64^2 with 4096 packets in float64: the kernel route's frames
    against the plain route's, on the card."""
    grid = SpectralGrid.square(NX)
    u, v, h = frame()
    x0, k0, a0 = packets(4096, card)
    kept = dict(frozen.raytrace_rsw_restart.routes)
    launches = mr.march_xka_cuda.launches
    kw = dict(dt=1e-3, nsteps=nsteps, save_every=save_every, device=card,
              dtype=F64)
    got = frozen.raytrace_rsw_restart(u, v, h, DISP, grid, x0, k0, a0, **kw)
    assert frozen.raytrace_rsw_restart.routes == dict(
        kept, kernel=kept["kernel"] + 1)
    segments = mr.split_steps(save_every, mr.segment_steps(1e-3, grid, DISP))
    assert mr.march_xka_cuda.launches - launches == \
        nsteps // save_every * len(segments)
    x, k, a = x0, k0, a0
    fields = frozen.rsw_restart_fields(
        *(torch.as_tensor(t, dtype=F64, device=card) for t in (u, v, h)),
        grid, P)
    want = []
    for _ in range(nsteps // save_every):
        x, k, a = mr.march_xka_reference(fields, x, k, a, grid, DISP, 1e-3,
                                         save_every)
        want.append((x, k, a))
    assert got[0].shape == (nsteps // save_every, 2, 4096)
    for j, (x, k, a) in enumerate(want):
        torch.testing.assert_close(got[0][j], x, rtol=0, atol=1e-10)
        torch.testing.assert_close(got[1][j], k, rtol=0, atol=1e-10)
        torch.testing.assert_close(got[2][j], a, rtol=1e-10, atol=0)


@pytest.mark.card
def test_kernel_route_spans_on_the_card(card):
    grid = SpectralGrid.square(CARD_NX)
    u, v, h = frame(CARD_NX)
    x0, k0, _ = packets(5000, card, torch.float32)
    with profiling.spans() as table:
        frozen.raytrace_rsw_restart(u, v, h, DISP, grid, x0, k0, dt=1e-3,
                                    nsteps=90, save_every=45, device=card)
    segments = len(mr.split_steps(45, mr.segment_steps(1e-3, grid, DISP)))
    assert {n: r["calls"] for n, r in table.items()} == {
        "swr.rsw": 1, "swr.rsw.fields": 1, "swr.rsw.march": 2,
        "swr.rays.order": 2 * segments}


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_kernel_route_raises_for_a_dtype_without_a_kernel(card, dtype,
                                                          monkeypatch):
    """On the card the route is the kernel's whatever the dtype: a dtype
    the kernel is not built for raises, and the plain version never
    runs."""
    def plain(*args, **kw):
        raise AssertionError("the plain route ran on the card")

    monkeypatch.setattr(mr, "march_xka_reference", plain)
    grid = SpectralGrid.square(32)
    u, v, h = frame(32)
    x0, k0, _ = packets(64, card, torch.float32)
    kept = dict(frozen.raytrace_rsw_restart.routes)
    with pytest.raises((ValueError, RuntimeError)):
        frozen.raytrace_rsw_restart(u, v, h, DISP, grid, x0, k0, dt=2e-3,
                                    nsteps=4, save_every=2, device=card,
                                    dtype=dtype)
    assert frozen.raytrace_rsw_restart.routes == dict(
        kept, kernel=kept["kernel"] + 1)
    # the entry the route calls: the kernel's wrapper refuses it by name
    fields, grid = grids(32, card, torch.float32)
    x0, k0, a0 = (t.to(dtype) for t in packets(64, card, torch.float32))
    with pytest.raises(ValueError, match="float32 or float64"):
        mr.march_xka(fields.to(dtype), x0, k0, a0, grid, DISP, 2e-3, 4)
    with pytest.raises(ValueError, match="order"):
        mr.march_xka(fields, *packets(64, card, torch.float32), grid, DISP,
                     2e-3, 4, order=4)
