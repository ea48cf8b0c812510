"""The host-side pieces the frozen-flow march gained around its kernel
(swraytracing_torch.ops.march_rays): the packets' cell key, the ordering by
it, and the split of the steps into segments. CPU, float64 and float32,
inputs from a numpy seed. The key is held to the cell the JAX package's
interp.cell_and_weights gives; the split into segments must not move a bit
of the plain march, and the ordering nothing but the rounding of the
stencil sum (PyTorch's sum on the CPU groups its terms by an element's
place in the vector; the kernel's sum on the card has one order, and
chip_smoke.py holds the ordered march to exact equality there); the entry
point still agrees with the JAX package."""

import numpy as np
import pytest
import torch

from swraytracing_tpu.ops import interp as jinterp
from swraytracing_tpu.ops import pallas_ray as jpr
from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.models.dispersion import Dispersion as JDispersion
from swraytracing_tpu.models.fields import flow_from_psi_grid as j_flow
from swraytracing_torch.ops import march_rays as tmr
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.models.dispersion import Dispersion as TDispersion
from swraytracing_torch.models.fields import flow_from_psi_grid as t_flow

from torch_parity import to_jax, to_torch, to_numpy, assert_close, assert_equal

JD, TD = JDispersion(f=3.0, Cg=1.0), TDispersion(f=3.0, Cg=1.0)
L = 2 * np.pi

# as tests/test_torch_march_rays.py: 50 Strang steps on |x| < 10, |k| = 8
ATOL = 1e-10

# A packet marched at another place in the vector: the 36-term stencil sum
# rounds differently in its last bit, once a step, on fields of size 0.1
# and |k| = 8; a few ulp of the state over a dozen steps.
ORDER_ATOL = {torch.float64: 1e-13, torch.float32: 2e-5}


def _flow(tg, dtype=torch.float64):
    X, Y = tg.meshgrid()
    psi = 0.1 * (np.sin(X) * np.sin(Y) + 0.25 * np.cos(X) * np.cos(Y))
    return psi, t_flow(torch.as_tensor(psi, dtype=dtype), tg).fields


def _packets(n_packets, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, L, (2, n_packets))
    ang = 2 * np.pi * np.arange(n_packets) / n_packets
    k0 = 8.0 * np.stack([np.cos(ang), np.sin(ang)], 0)
    return (torch.as_tensor(x0, dtype=dtype), torch.as_tensor(k0, dtype=dtype))


@pytest.mark.parametrize("nx,ny", [(64, 64), (24, 40)])
def test_packet_cell_keys_equal_jax_cells(nx, ny):
    """The key is i0*ny + j0 of the JAX package's cell, edges included:
    just below 0 (the modulo gives exactly n), exactly L, one ulp either
    side of a cell edge, far outside the domain."""
    tg = TGrid(nx=nx, ny=ny, Lx=L, Ly=L)
    jg = JGrid(nx=nx, ny=ny, Lx=L, Ly=L)
    rng = np.random.default_rng(3)
    x = rng.uniform(-2 * L, 3 * L, (2, 500))
    x[:, 0] = [-1e-18, L]
    x[:, 1] = [L, -1e-18]
    for col, cells in ((2, 1.0), (3, 5.0), (4, float(nx - 1))):
        x[:, col] = [np.nextafter(cells * tg.dx, 0),
                     np.nextafter(cells * tg.dx, 10)]
    x[:, 5] = [3 * tg.dx, 7 * tg.dy]          # on a node
    x[:, 6] = [0.0, -0.0]
    i0, j0, _, _ = jinterp.cell_and_weights(to_jax(x[0]), to_jax(x[1]), jg)
    key = tmr.packet_cell_keys(to_torch(x), tg)
    assert key.dtype == torch.int32 and key.shape == (500,)
    assert_equal(key, np.asarray(i0) * ny + np.asarray(j0))
    assert int(key.min()) >= 0 and int(key.max()) < nx * ny
    assert int(key[0]) == 0 * ny + 0           # -1e-18 and L fold to 0
    assert int(key[6]) == 0


def test_packet_cell_keys_float32_in_range():
    tg = TGrid.square(64)
    x = torch.tensor([[-1e-30, L, 0.0, 6.2831855], [L, -1e-30, 6.2831855, 0.0]],
                     dtype=torch.float32)
    key = tmr.packet_cell_keys(x, tg)
    assert key.dtype == torch.int32
    assert int(key.min()) >= 0 and int(key.max()) < 64 * 64


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_march_by_cell_order(dtype):
    """Permute by the key, march, undo the permutation: the unpermuted
    march, up to the rounding of the stencil sum; a packet marched all
    alone agrees as closely."""
    tg = TGrid.square(32)
    _, F = _flow(tg, dtype)
    x0, k0 = _packets(300, 1, dtype)
    want = tmr.march_rays_reference(F, x0, k0, tg, TD, 0.005, 12)
    perm = torch.argsort(tmr.packet_cell_keys(x0, tg))
    keys = tmr.packet_cell_keys(x0[:, perm], tg)
    assert bool((keys[1:] >= keys[:-1]).all())
    assert sorted(perm.tolist()) == list(range(300))
    xs, ks = tmr.march_rays_reference(F, x0[:, perm].contiguous(),
                                      k0[:, perm].contiguous(), tg, TD,
                                      0.005, 12)
    x, k = torch.empty_like(xs), torch.empty_like(ks)
    x[:, perm], k[:, perm] = xs, ks
    atol = ORDER_ATOL[dtype]
    assert_close(x, to_numpy(want[0]), atol=atol)
    assert_close(k, to_numpy(want[1]), atol=atol)
    alone = tmr.march_rays_reference(F, x0[:, 7:8].contiguous(),
                                     k0[:, 7:8].contiguous(), tg, TD, 0.005,
                                     12)
    assert_close(alone[0], to_numpy(want[0][:, 7:8]), atol=atol)
    assert_close(alone[1], to_numpy(want[1][:, 7:8]), atol=atol)


SPLITS = [(12, 4), (13, 5), (3, 8), (0, 4), (7, 1), (9, None)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nsteps,segment", SPLITS)
def test_segmented_march_is_bit_identical(nsteps, segment, dtype):
    """The plain march run segment by segment through the splitting rule
    equals the single-run plain march bit for bit: nsteps that the segment
    divides, does not divide, is smaller than, and 0; one step a segment;
    the rule's own segment."""
    tg = TGrid.square(32)
    _, F = _flow(tg, dtype)
    x0, k0 = _packets(200, 2, dtype)
    x0[:, 0] = torch.tensor([-1e-18, L], dtype=dtype)
    want = tmr.march_rays_reference(F, x0, k0, tg, TD, 0.02, nsteps)
    got = tmr.march_rays_segmented_reference(F, x0, k0, tg, TD, 0.02, nsteps,
                                             segment=segment, ordered=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (2, 200)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nsteps,segment", SPLITS)
def test_segmented_ordered_march(nsteps, segment, dtype):
    """The same with the packets ordered by cell anew before each segment,
    as march_rays_cuda marches them: equal up to the rounding of the
    stencil sum, and exactly the input for no steps."""
    tg = TGrid.square(32)
    _, F = _flow(tg, dtype)
    x0, k0 = _packets(200, 2, dtype)
    x0[:, 0] = torch.tensor([-1e-18, L], dtype=dtype)
    want = tmr.march_rays_reference(F, x0, k0, tg, TD, 0.02, nsteps)
    got = tmr.march_rays_segmented_reference(F, x0, k0, tg, TD, 0.02, nsteps,
                                             segment=segment)
    atol = ORDER_ATOL[dtype] if nsteps else 0.0
    assert_close(got[0], to_numpy(want[0]), atol=atol)
    assert_close(got[1], to_numpy(want[1]), atol=atol)


@pytest.mark.parametrize("nsteps,segment,want", [
    (50, 12, [10, 10, 10, 10, 10]), (50, 50, [50]), (50, 70, [50]),
    (13, 5, [5, 4, 4]), (7, 1, [1] * 7), (0, 4, []), (1, 1, [1]),
    (500, 12, [12] * 38 + [11] * 4)])
def test_split_steps(nsteps, segment, want):
    got = tmr.split_steps(nsteps, segment)
    assert got == want
    assert sum(got) == nsteps and all(1 <= s <= segment for s in got)
    assert len(got) == -(-nsteps // segment)   # the fewest segments


def test_split_steps_refuses_an_empty_segment():
    with pytest.raises(ValueError, match="at least 1"):
        tmr.split_steps(5, 0)


@pytest.mark.parametrize("dt,nx,Cg", [
    (1e-3, 512, 1.0), (-1e-3, 512, 1.0), (0.5, 64, 1.0), (1e-3, 512, 40.0),
    (0.0, 64, 1.0), (1e-9, 16, 1e-6), (float("inf"), 64, 1.0)])
def test_segment_steps_is_a_host_function_of_scalars(dt, nx, Cg):
    """From dt, the grid and the dispersion alone (nothing of the packets
    or the fields enters), an int, at least 1, and shorter where packets
    cross cells faster."""
    tg = TGrid.square(nx)
    disp = TDispersion(f=3.0, Cg=Cg)
    seg = tmr.segment_steps(dt, tg, disp)
    assert isinstance(seg, int) and seg >= 1
    assert seg == tmr.segment_steps(dt, tg, disp)
    assert seg == tmr.segment_steps(-dt, tg, disp)
    faster = tmr.segment_steps(dt, tg, TDispersion(f=3.0, Cg=2 * Cg))
    assert 1 <= faster <= seg
    if 0 < abs(dt) < float("inf"):
        cells = Cg * abs(dt) / tg.dx
        assert seg == max(1, min(2 ** 31 - 1,
                                 int(tmr.SEGMENT_CELLS / cells)))
    # a non-square grid: the finer spacing counts
    wide = TGrid(nx=nx, ny=2 * nx, Lx=L, Ly=L)
    assert tmr.segment_steps(dt, wide, disp) <= seg


def test_march_rays_entry_still_matches_jax():
    """march_rays on CPU tensors (the plain version) against the JAX
    reference, and the segmented plain march with it."""
    tg, jg = TGrid.square(64), JGrid.square(64)
    psi, F = _flow(tg)
    x0, k0 = _packets(100, 0)
    x0[:, 0] = torch.tensor([-1e-18, L], dtype=torch.float64)
    want = jpr.march_rays_reference(
        j_flow(to_jax(psi), jg).fields, to_jax(to_numpy(x0)),
        to_jax(to_numpy(k0)), jg, JD, 0.005, 50)
    got = tmr.march_rays(F, x0, k0, tg, TD, 0.005, 50)
    assert_close(got[0], want[0], atol=ATOL)
    assert_close(got[1], want[1], atol=ATOL)
    seg = tmr.march_rays_segmented_reference(F, x0, k0, tg, TD, 0.005, 50,
                                             ordered=False)
    assert torch.equal(seg[0], got[0]) and torch.equal(seg[1], got[1])
    seg = tmr.march_rays_segmented_reference(F, x0, k0, tg, TD, 0.005, 50)
    assert_close(seg[0], want[0], atol=ATOL)
    assert_close(seg[1], want[1], atol=ATOL)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("segment", [7, 1])
def test_segmented_ordered_march_matches_jax(order, segment):
    """The plain version of what march_rays_cuda does around its kernel
    (ordering by cell, segments that do not divide the steps) against the
    JAX reference march, at every stencil order."""
    tg, jg = TGrid(nx=24, ny=40, Lx=L, Ly=L), JGrid(nx=24, ny=40, Lx=L, Ly=L)
    psi, F = _flow(tg)
    x0, k0 = _packets(64, 5)
    x0[:, 0] = torch.tensor([-1e-18, L], dtype=torch.float64)
    want = jpr.march_rays_reference(
        j_flow(to_jax(psi), jg).fields, to_jax(to_numpy(x0)),
        to_jax(to_numpy(k0)), jg, JD, 0.005, 20, order=order)
    got = tmr.march_rays_segmented_reference(F, x0, k0, tg, TD, 0.005, 20,
                                             order=order, segment=segment)
    assert_close(got[0], want[0], atol=ATOL)
    assert_close(got[1], want[1], atol=ATOL)


def test_cuda_routes_refuse_cpu_tensors_and_count_nothing():
    tg = TGrid.square(32)
    _, F = _flow(tg)
    x0, k0 = _packets(10, 4)
    for kw in ({}, {"segment": 3}, {"ordered": False, "segment": 5}):
        with pytest.raises(ValueError, match="CUDA"):
            tmr.march_rays_cuda_by(F, x0, k0, tg, TD, 0.005, 5, **kw)
    with pytest.raises(ValueError, match="order"):
        tmr.march_rays_cuda_by(F, x0, k0, tg, TD, 0.005, 5, order=0)
    assert tmr.march_rays_cuda.launches == 0
    assert tmr.march_rays_cuda.last_segments == []
