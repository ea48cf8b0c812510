"""The march kernel's ring route (kernels/csrc/march_ring.cuh): its slot
and consumer counts, the route rule, the launch checks and the wrappers'
counts. The kernel itself runs only on the card, where chip_smoke.py holds
it bit for bit against the staged route and against the plain version;
here every check runs before a build."""

from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

from swraytracing_torch import kernels
from swraytracing_torch.ops import march_window as tmw

DX = 2.0 * np.pi / 512
CSRC = pathlib.Path(kernels.__file__).parent / "csrc"


def _spec(nf=2, margin=1, **kw):
    return tmw.MarchSpec(nx=512, ny=512, dx=DX, dy=DX, f=3.0, Cg=1.0, nf=nf,
                         margin=margin, grad_from_interp=nf == 2,
                         tiles_transposed=True, **kw)


# (nf, margin, dtype, K, slots)
SLOTS = [
    (2, 1, torch.float32, 128, 7),    # both coupled main paths, Run I
    (2, 1, torch.float64, 128, 3),
    (6, 1, torch.float32, 384, 2),
    (6, 1, torch.float64, 384, 1),    # the ring route refuses
]


@pytest.mark.parametrize("nf,margin,dtype,K,slots", SLOTS)
def test_ring_slots(nf, margin, dtype, K, slots):
    spec = _spec(nf, margin)
    assert spec.K == K
    assert tmw.ring_slots(spec, dtype) == slots
    # floor(SMEM_PER_SM / a warp's rows): the barriers take no slot here
    assert slots == tmw.SMEM_PER_SM // tmw.staged_warp_bytes(spec, dtype)


@pytest.mark.parametrize("sw", [6, 8, 10, 12, 14])
@pytest.mark.parametrize("nf", [2, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ring_block_fits_the_kernel(sw, nf, dtype):
    """On every row size the march takes, the barriers cost no slot, and
    the default block (RING_PRODUCERS + ring_consumers warps) stays within
    what the kernel is compiled for."""
    spec = _spec(nf, (sw - 6) // 2)
    item = torch.finfo(dtype).bits // 8
    assert tmw.ring_slots(spec, dtype) == (
        tmw.SMEM_PER_SM // tmw.staged_warp_bytes(spec, dtype))
    if tmw.ring_slots(spec, dtype) < 2:
        return
    consumers = tmw.ring_consumers(spec, dtype)
    assert 1 <= consumers < tmw.ring_slots(spec, dtype)
    threads = 32 * (tmw.RING_PRODUCERS + consumers)
    assert threads <= (384 if item == 4 else 288)
    top = min(tmw.ring_slots(spec, dtype) - 1, tmw.RING_MAX_CONSUMERS)
    assert 32 * (tmw.RING_PRODUCERS + top) <= (384 if item == 4 else 288)


@pytest.mark.parametrize("nf,margin,dtype,consumers", [
    (2, 1, torch.float32, 4),    # S - 3 of 7 slots
    (2, 1, torch.float64, 1),
    (6, 1, torch.float32, 1),
    (2, 0, torch.float32, 8),    # 12 slots: capped at RING_MAX_CONSUMERS
])
def test_ring_consumers(nf, margin, dtype, consumers):
    assert tmw.ring_consumers(_spec(nf, margin), dtype) == consumers


# The shapes phase_march_routes times: the main shape, then the others.
@pytest.mark.parametrize("nf,margin,dtype,route", [
    (2, 1, torch.float32, "ring"),     # main shape: 4 consumer warps
    (2, 2, torch.float32, "staged"),   # 4 slots, 1 consumer
    (6, 1, torch.float32, "staged"),   # 2 slots
    (6, 2, torch.float32, "staged"),   # 1 slot: no ring
    (2, 1, torch.float64, "staged"),   # 3 slots
    (2, 2, torch.float64, "staged"),   # 2 slots
    (6, 1, torch.float64, "staged"),   # 1 slot; one warp stages
])
def test_march_route_on_the_timed_shapes(nf, margin, dtype, route):
    spec = _spec(nf, margin)
    assert tmw.march_route(spec, dtype) == route
    # the rule reads (2K, element size), nothing else
    assert tmw.march_route(spec._replace(nx=64, ny=48, block=64,
                                         stepper="rk4"), dtype) == route
    # and takes (ncells, K) rows only
    with pytest.raises(ValueError, match=r"\(ncells, K\) window rows only"):
        tmw.march_route(spec._replace(tiles_transposed=False), dtype)


@pytest.mark.parametrize("nf,margin,dtype,K,slots", SLOTS)
def test_checked_route_ring(nf, margin, dtype, K, slots):
    spec = _spec(nf, margin)
    name = "march_gathered_cuda"
    if slots < 2:
        with pytest.raises(ValueError, match="ring route needs two slots"):
            tmw._checked_route(name, spec, dtype, "ring")
        return
    route, threads = tmw._checked_route(name, spec, dtype, "ring")
    assert route == "ring"
    assert threads == 32 * (tmw.RING_PRODUCERS
                            + tmw.ring_consumers(spec, dtype))
    # a named consumer count: 1 to slots - 1
    for c in range(1, slots):
        assert tmw._checked_route(name, spec, dtype, "ring", c) == (
            "ring", 32 * (tmw.RING_PRODUCERS + c))
    for c in (0, slots):
        with pytest.raises(ValueError, match="consumer warps"):
            tmw._checked_route(name, spec, dtype, "ring", c)
    # consumers are a setting of the ring route only
    with pytest.raises(ValueError, match="ring route"):
        tmw._checked_route(name, spec, dtype, "staged", 2)
    # MarchSpec.block is checked on every route, read on two
    assert tmw._checked_route(name, spec._replace(block=64), dtype,
                              "ring") == (route, threads)
    with pytest.raises(ValueError, match="multiple of 32"):
        tmw._checked_route(name, spec._replace(block=48), dtype, "ring")


@pytest.mark.parametrize("wrapper,routes", [
    (tmw.march_gathered_cuda, {"staged", "direct", "ring"}),
    (tmw.march_gathered_batched_cuda, {"staged", "direct", "ring"}),
    (tmw.march_gathered_backward_cuda, {"staged", "direct"}),
], ids=["march_gathered_cuda", "march_gathered_batched_cuda",
        "march_gathered_backward_cuda"])
def test_wrappers_count_ring_launches(wrapper, routes):
    """Each march wrapper counts its launches by route; the backward has
    no ring route."""
    assert set(wrapper.launches_by_route) == routes


def _cpu_args(wrapper, spec, dtype=torch.float32, E=2, Np=40):
    K, ncells = spec.K, spec.nx * spec.ny
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype)
    cells = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    if wrapper is tmw.march_gathered_batched_cuda:
        return (zeros(E, ncells, K), zeros(E, ncells, K), zeros(E, 4, Np),
                cells(E, Np), cells(E, Np),
                torch.full((E,), 0.1, dtype=torch.float64))
    return (zeros(ncells, K), zeros(ncells, K), zeros(4, Np), cells(Np),
            cells(Np), 0.1)


_NAMED_RING = {"route": "ring", "consumers": 4}


@pytest.mark.parametrize("wrapper,kw", [
    pytest.param(tmw.march_gathered_cuda, {}, id="march_gathered_cuda_rule"),
    pytest.param(tmw.march_gathered_cuda, _NAMED_RING,
                 id="march_gathered_cuda"),
    pytest.param(tmw.march_gathered_batched_cuda, _NAMED_RING,
                 id="march_gathered_batched_cuda"),
])
def test_ring_entries_refuse_cpu_tensors(wrapper, kw):
    """On CPU tensors a ring launch (named, or the rule's at the main
    shape) raises before any build and counts nothing."""
    spec = _spec(2, 1)._replace(nx=16, ny=16)
    assert tmw.march_route(spec, torch.float32) == "ring"
    before = dict(wrapper.launches_by_route)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        wrapper(*_cpu_args(wrapper, spec), spec, **kw)
    assert wrapper.launches_by_route == before
    assert kernels._lib is None


def test_ring_constants_are_the_kernel_source_s():
    """The Python rule and the CUDA header rest on the same numbers."""
    ring = (CSRC / "march_ring.cuh").read_text()
    (producers,) = re.findall(r"constexpr int RING_PRODUCERS = (\d+);", ring)
    (barrier,) = re.findall(
        r"constexpr size_t RING_BARRIER_BYTES = (\d+);", ring)
    (threads,) = re.findall(
        r"RING_MAX_THREADS = sizeof\(T\) == 4 \? (\d+) : (\d+);", ring)
    assert int(producers) == tmw.RING_PRODUCERS
    assert int(barrier) == tmw.RING_BARRIER_BYTES
    assert (int(threads[0]), int(threads[1])) == (384, 288)
    assert 32 * (tmw.RING_PRODUCERS + tmw.RING_MAX_CONSUMERS) == 384
    # the ring route's sources instantiate the one header
    for t in ("f32", "f64"):
        src = (CSRC / f"march_ring_{t}.cu").read_text()
        assert '#include "march_ring.cuh"' in src
        assert f"swr_march_ring_{t}, swr_march_batched_ring_{t}" in src
        assert "ROUTE_RING" in src


@pytest.mark.parametrize("entry,what", [
    ("swr_march_batched_ring_f32", "two ring slots of 32 rows"),
    ("swr_march_ring_f64", "two ring slots of 32 rows"),
    ("swr_march_staged_f32", "the block's rows"),
])
def test_check_names_what_does_not_fit(entry, what):
    with pytest.raises(RuntimeError, match=f"{entry}: {what} do not fit"):
        kernels.check(-2, entry)
    assert kernels._lib is None
