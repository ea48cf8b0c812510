"""The index arithmetic of the window-build kernel
(swraytracing_torch/kernels/csrc/build_windows.cu), emulated thread by
thread in Python and held equal to build_windows_reference. The kernel
itself runs only on a CUDA device; what can be wrong in it before its first
launch is the mapping block -> run of cells, thread -> (cell, the
components of one 16-byte piece: four in float32, two in float64) ->
source index, which is written out here as the kernel has it, for both of
its routes (field rows staged in a shared-memory tile, or read per
thread)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from swraytracing_tpu.ops import pallas_window as jpw
from swraytracing_torch import kernels
from swraytracing_torch.ops import march_window as tmw

from torch_parity import NX, L, to_jax, to_numpy, smooth_fields

SOURCE = (pathlib.Path(kernels.__file__).parent / "csrc"
          / "build_windows.cu").read_text()


def source_constant(name):
    """`constexpr int NAME = value;` as the kernel's source has it."""
    (found,) = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    return int(found)


THREADS, RUN, MIN_RUN, STATIC_SMEM = map(
    source_constant, ("THREADS", "RUN", "MIN_RUN", "STATIC_SMEM"))


def launch_plan(nf, sw, itemsize):
    """`launch` of build_windows.cu: (run, pitch, staged, (qx, cy))."""
    KN = nf * sw * sw // (16 // itemsize)
    run = RUN
    while run > MIN_RUN and \
            nf * sw * ((run + sw - 1) | 1) * itemsize > STATIC_SMEM:
        run //= 2
    pitch = (run + sw - 1) | 1
    staged = nf * sw * pitch * itemsize <= STATIC_SMEM
    if not staged:
        run = RUN
    qx = min(KN, THREADS)
    cy = min(THREADS // qx, run)
    return run, pitch, staged, (qx, cy)


def wrap_once(v, n):
    if v < 0:
        v += n
    if v >= n:
        v -= n
    assert 0 <= v < n, "one wrap was not enough"
    return v


def emulate_build_windows(F, sw, lo, itemsize, staged=None):
    """`build_windows_kernel`, block by block and thread by thread. Returns
    the flat window array and how often each of its elements was written."""
    nf, nx, ny = F.shape
    K = nf * sw * sw
    N = 16 // itemsize
    KN = K // N
    run_max, pitch, plan_staged, (qx, cy) = launch_plan(nf, sw, itemsize)
    if staged is None:
        staged = plan_staged
    assert qx * cy <= THREADS and K % N == 0
    Fflat = F.reshape(-1)
    ncells = nx * ny
    W = np.full(ncells * K, np.nan)
    written = np.zeros(ncells * K, dtype=np.int64)
    runs_per_row = (ny + run_max - 1) // run_max
    for block in range(nx * runs_per_row):
        i = block // runs_per_row
        j0 = (block - i * runs_per_row) * run_max
        run = run_max if j0 + run_max <= ny else ny - j0
        tile = None
        if staged:
            tile = np.full(nf * sw * pitch, np.nan)
            cols = run + sw - 1
            assert cols <= pitch
            for ty in range(cy):
                for r in range(ty, nf * sw, cy):
                    f, sx = divmod(r, sw)
                    row = f * ncells + wrap_once(i + sx - lo, nx) * ny
                    for tx in range(qx):
                        for col in range(tx, cols, qx):
                            tile[r * pitch + col] = Fflat[
                                row + wrap_once(j0 + col - lo, ny)]
        wrun = (i * ny + j0) * K
        for ty in range(cy):
            for tx in range(qx):
                for q in range(tx, KN, qx):
                    f = (N * q) // (sw * sw)
                    r = N * q - f * sw * sw
                    sx = r // sw
                    sy = r - sx * sw
                    tile_off, row_off, col_off = [], [], []
                    for _ in range(N):
                        tile_off.append((f * sw + sx) * pitch + sy)
                        # f can pass nf - 1 only after the row's last
                        # component: no element uses that value
                        row_off.append(
                            f * ncells + wrap_once(i + sx - lo, nx) * ny
                            if f < nf else None)
                        col_off.append(j0 + sy - lo)
                        sy += 1
                        if sy == sw:
                            sy = 0
                            sx += 1
                            if sx == sw:
                                sx = 0
                                f += 1
                    for dj in range(ty, run, cy):
                        for e in range(N):
                            if staged:
                                v = tile[tile_off[e] + dj]
                            else:
                                v = Fflat[row_off[e]
                                          + wrap_once(col_off[e] + dj, ny)]
                            at = wrun + dj * K + N * q + e
                            W[at] = v
                            written[at] += 1
    return W.reshape(ncells, K), written


@pytest.mark.parametrize("nx,ny", [(13, 22), (16, 16), (9, 71)])
@pytest.mark.parametrize("nf", [2, 6])
@pytest.mark.parametrize("margin", [1, 2, 3])
@pytest.mark.parametrize("staged,itemsize", [(True, 4), (False, 4), (True, 8)])
def test_build_windows_kernel_indices(nx, ny, nf, margin, staged, itemsize):
    """SW = 8, 10 (a float4 straddles a window row) and 12; nx != ny, odd
    sizes, a row longer than one run of cells (71 > 32), a window wider
    than a side (margin 3 at nx = 9); both routes, both piece sizes."""
    spec = tmw.MarchSpec(nx=nx, ny=ny, dx=1.0, dy=1.0, f=3.0, Cg=1.0,
                         margin=margin, nf=nf, grad_from_interp=nf == 2,
                         tiles_transposed=True, fused_build=True)
    F = np.random.default_rng(nx + margin).standard_normal((nf, nx, ny))
    got, written = emulate_build_windows(F, spec.SW, spec.order + spec.margin,
                                         itemsize, staged=staged)
    assert (written == 1).all()   # every element once: no gap, no overlap
    want = tmw.build_windows_reference(torch.from_numpy(F), spec)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("nf,sw,itemsize,want", [
    (2, 8, 4, (32, 39, True, (32, 8))),        # the main shape
    (2, 8, 8, (32, 39, True, (64, 4))),
    (2, 10, 4, (32, 41, True, (50, 5))),
    (6, 12, 8, (32, 43, True, (256, 1))),
    (6, 22, 8, (16, 37, True, (256, 1))),      # the run halved to fit
    (6, 30, 8, (32, 37, False, (256, 1))),     # too large to stage
    (2, 6, 4, (32, 37, True, (18, 14))),
])
def test_build_windows_launch_plan(nf, sw, itemsize, want):
    run, pitch, staged, block = launch_plan(nf, sw, itemsize)
    assert (run, pitch, staged, block) == want
    assert block[0] * block[1] <= THREADS
    if staged:
        assert nf * sw * pitch * itemsize <= STATIC_SMEM and pitch % 2 == 1


def test_build_windows_launch_plan_is_the_source_s():
    """launch_plan above is a transcript of `launch` in build_windows.cu:
    the constants are read from the source, and the statements that pick
    the run, the pitch, the route and the block stand there as here."""
    assert (THREADS, RUN, MIN_RUN, STATIC_SMEM) == (256, 32, 8, 49152)
    flat = " ".join(SOURCE.split())
    for statement in (
            "const int KN = nf * sw * sw / Piece<T>::N;",
            "int run = RUN; while (run > MIN_RUN && (size_t)nf * sw * "
            "((run + sw - 1) | 1) * sizeof(T) > STATIC_SMEM) run /= 2;",
            "const int pitch = (run + sw - 1) | 1;",
            "const size_t smem = (size_t)nf * sw * pitch * sizeof(T);",
            "const bool staged = smem <= STATIC_SMEM;",
            "if (!staged) run = RUN;",
            "const int qx = KN < THREADS ? KN : THREADS;",
            "const int cy = THREADS / qx < run ? THREADS / qx : run;",
            "const dim3 block(qx, cy);",
            "static constexpr int N = 16 / sizeof(T);"):
        assert statement in flat, statement


@pytest.mark.parametrize("nf", [2, 6])
@pytest.mark.parametrize("staged", [True, False])
def test_build_windows_kernel_indices_vs_tpu_kernel(nf, staged):
    """The emulation against the TPU kernel itself (build_windows_fused of
    the JAX package, its Pallas kernel in interpret mode) at SW = 10, where
    a 16-byte piece straddles a window row: exact, values are only copied."""
    common = dict(nx=NX, ny=NX, dx=L / NX, dy=L / NX, f=3.0, Cg=1.0, margin=2,
                  nf=nf, grad_from_interp=nf == 2, tiles_transposed=True,
                  fused_build=True)
    js = jpw.MarchSpec(interpret=True, block=128, **common)
    ts = tmw.MarchSpec(**common)
    assert js.use_pallas and js.fused_build and ts.SW == js.SW == 10
    F = smooth_fields(np.random.default_rng(7), 6)[:nf]
    want = to_numpy(jpw.build_windows_fused(to_jax(F), js))
    got, written = emulate_build_windows(F, ts.SW, ts.order + ts.margin, 4,
                                         staged=staged)
    assert (written == 1).all()
    np.testing.assert_array_equal(got, want)


def test_build_windows_kernel_indices_unstaged_plan():
    """A window the launch itself sends down the per-thread route (float64,
    nf = 6, margin 12: no run of 8 cells fits the tile)."""
    spec = tmw.MarchSpec(nx=31, ny=33, dx=1.0, dy=1.0, f=3.0, Cg=1.0,
                         margin=12, nf=6, tiles_transposed=True,
                         fused_build=True)
    assert launch_plan(6, spec.SW, 8)[2] is False
    F = np.random.default_rng(1).standard_normal((6, 31, 33))
    got, written = emulate_build_windows(F[:, :, :], spec.SW,
                                         spec.order + spec.margin, 8)
    assert (written == 1).all()
    want = tmw.build_windows_reference(torch.from_numpy(F), spec)
    np.testing.assert_array_equal(got, want.numpy())
