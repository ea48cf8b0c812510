"""Loader for the hand-written CUDA kernels under ``csrc/``.

``load()`` compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` (one
compiler process per source, started together; the march kernel is one
header instantiated by one source per scalar type and route for that
reason), links
the objects into one shared library with a plain C interface, and opens
it with ``ctypes``. The library goes into ``build/`` beside this file,
named by a hash of the sources, headers and flags, so an unchanged tree
builds once and a changed source never meets a stale library.

Nothing here runs at import: ``nvcc`` and ``ctypes`` are reached only
from ``load()``, which the kernel wrappers in ops/march_window.py and
ops/march_rays.py call at their first launch. A failed build or launch
raises; there is no fallback.

Kernels (C entry -> wrapper):
  swr_march_f32, swr_march_f64  csrc/march.cuh (march_f32.cu, march_f64.cu):
                                every thread reads its own window row
  swr_march_staged_f32, _f64    csrc/march.cuh (march_staged_f32.cu,
                                march_staged_f64.cu): each warp's rows
                                copied into shared memory first
  swr_march_ring_f32, _f64      csrc/march_ring.cuh (march_ring_f32.cu,
                                march_ring_f64.cu): one persistent block an
                                SM, producer warps copying the rows into a
                                ring of shared-memory slots while consumer
                                warps march
                                ops.march_window.march_gathered_cuda (rows
                                read by cell from the window arrays), by
                                the route ops.march_window.march_route
                                gives
  swr_march_batched_f32, _f64,  the same kernels over the members of an
  swr_march_batched_staged_f32, ensemble in one launch, each member's
  _f64, swr_march_batched_      substep length read from a float64 device
  ring_f32, _f64                array: ops.march_window.
                                march_gathered_batched_cuda
  swr_march_backward_f32, _f64  csrc/march_backward.cuh
                                (march_backward_f32.cu, march_backward_f64.cu):
                                the gathered march's rk23 backward, the
                                cotangents of the packets and of both window
                                arrays (a kernel over the packets, then one
                                over the cells' rows):
                                ops.march_window.march_gathered_backward_cuda
  swr_transpose                 csrc/transpose.cu
                                ops.march_window.transpose_cuda
  swr_transpose_batched         csrc/transpose.cu, E matrices in one launch:
                                ops.march_window.transpose_batched_cuda
  swr_build_windows             csrc/build_windows.cu
                                ops.march_window.build_windows_cuda
  swr_build_windows_batched     csrc/build_windows.cu, E members in one
                                launch: ops.march_window.
                                build_windows_batched_cuda
  swr_march_rays_f32, _f64      csrc/march_rays.cu
                                ops.march_rays.march_rays_cuda
  swr_rays_cell_histogram,      csrc/march_rays.cu: the packets' order by
  swr_rays_cell_scatter         cell (a counting sort), for the same wrapper
csrc/scalar.cuh holds the scalar helpers the march kernels share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "check", "sources", "NVCC_FLAGS", "build_info"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# seconds the build took (0.0 when the library was already built) and the
# compiler's output (registers, spills per kernel)
build_info = {"seconds": None, "log": ""}


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc was not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built")


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _build(srcs, lib_path: Path) -> None:
    nvcc = _nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [_BUILD / f"{tag}.{s.stem}.o" for s in srcs]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_info["log"] = "".join(logs)
    for s, p, log in zip(srcs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
    tmp = _BUILD / f"{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {lib_path.name}:\n"
                           f"{link.stdout}")
    os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
    for o in objs:
        o.unlink()


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
    for march in (lib.swr_march_f32, lib.swr_march_f64,
                  lib.swr_march_staged_f32, lib.swr_march_staged_f64,
                  lib.swr_march_ring_f32, lib.swr_march_ring_f64):
        march.restype = i32
        march.argtypes = [
            vp, vp,              # snapshot-1 / snapshot-2 (ncells, K) windows
            vp, vp, vp,          # xk, oi, oj
            vp, vp,              # out, overflow
            i64, f64,            # Np, sub_dt
            i32, i32, f64, f64,  # nx, ny, 1/dx, 1/dy
            f64, f64,            # f^2, Cg^2
            i32, i32, i32,       # margin, n_substeps, nf
            i32, i32,            # stepper, threads per block
            vp]                  # stream
    for march in (lib.swr_march_batched_f32, lib.swr_march_batched_f64,
                  lib.swr_march_batched_staged_f32,
                  lib.swr_march_batched_staged_f64,
                  lib.swr_march_batched_ring_f32,
                  lib.swr_march_batched_ring_f64):
        march.restype = i32
        march.argtypes = [
            vp, vp,              # the members' window arrays, both snapshots
            i32, i64, i32,       # members, ncells, K
            vp, vp, vp,          # xk, oi, oj
            vp, vp,              # out, overflow
            i64, vp,             # Np, sub_dt (members,) float64
            i32, i32, f64, f64,  # nx, ny, 1/dx, 1/dy
            f64, f64,            # f^2, Cg^2
            i32, i32, i32,       # margin, n_substeps, nf
            i32, i32,            # stepper, threads per block
            vp]                  # stream
    for backward in (lib.swr_march_backward_f32, lib.swr_march_backward_f64):
        backward.restype = i32
        backward.argtypes = [
            vp, vp, vp,          # win1, win2, xk
            vp, vp, vp,          # cell a position, packet a position,
                                 # positions up to each cell's end
            vp, vp,              # cotangent of the output, of xk
            vp, vp, vp,          # stage records, cotangents of win1, win2
            i64, i64, f64,       # Np, ncells, sub_dt
            i32, i32, f64, f64,  # nx, ny, 1/dx, 1/dy
            f64, f64,            # f^2, Cg^2
            i32, i32, i32,       # margin, n_substeps, nf
            i32,                 # rows staged
            vp]                  # stream
    lib.swr_transpose.restype = i32
    lib.swr_transpose.argtypes = [i32, vp, vp, i64, i64, vp]
    lib.swr_transpose_batched.restype = i32
    lib.swr_transpose_batched.argtypes = [i32, vp, vp, i32, i64, i64, vp]
    lib.swr_build_windows.restype = i32
    lib.swr_build_windows.argtypes = [
        i32, vp, vp,             # dtype, F, W
        i32, i32, i32,           # nf, nx, ny
        i32, i32,                # SW, order + margin
        vp]                      # stream
    lib.swr_build_windows_batched.restype = i32
    lib.swr_build_windows_batched.argtypes = [
        i32, vp, vp,             # dtype, F, W
        i32, i64,                # members, elements between members' fields
        i32, i32, i32,           # nf, nx, ny
        i32, i32,                # SW, order + margin
        vp]                      # stream
    for rays in (lib.swr_march_rays_f32, lib.swr_march_rays_f64):
        rays.restype = i32
        rays.argtypes = [
            vp, vp, vp,          # fields, x0, k0
            vp, vp,              # xN, kN
            vp,                  # permutation by cell, or null
            i64, i32, i32,       # Np, nx, ny
            f64, f64, f64,       # dx, dy, dt
            f64, f64,            # f^2, Cg^2
            i32, i32, i32,       # nsteps, order, threads per block
            vp]                  # stream
    lib.swr_rays_cell_histogram.restype = i32
    lib.swr_rays_cell_histogram.argtypes = [
        i32, vp, i64,            # dtype, x, Np
        i32, i32, f64, f64,      # nx, ny, dx, dy
        vp, vp, vp]              # key, count, stream
    lib.swr_rays_cell_scatter.restype = i32
    lib.swr_rays_cell_scatter.argtypes = [vp, i64, vp, vp, vp]
    lib.swr_error_string.restype = ctypes.c_char_p
    lib.swr_error_string.argtypes = [i32]


def load() -> ctypes.CDLL:
    """The kernel library, built from csrc/ on first use."""
    global _lib
    if _lib is None:
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {_CSRC}")
        lib_path = _BUILD / f"libswr_kernels_{_digest(srcs)}.so"
        t0 = time.perf_counter()
        built = not lib_path.exists()
        if built:
            _build(srcs, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        _bind(lib)
        build_info["seconds"] = time.perf_counter() - t0 if built else 0.0
        _lib = lib
    return _lib


def check(err: int, entry: str) -> None:
    """Raise if the C entry named `entry` returned a CUDA error (or -1: a
    configuration the library has no kernel for; -2: a block whose rows,
    or on the ring route its two slots of rows, do not fit in an SM's
    shared memory)."""
    if err == 0:
        return
    if err == -2:
        what = ("two ring slots of 32 rows" if "_ring_" in entry
                else "the block's rows")
        raise RuntimeError(f"{entry}: {what} do not fit in one SM's shared "
                           "memory")
    if err < 0:
        raise RuntimeError(f"{entry}: no kernel for this configuration")
    msg = load().swr_error_string(err).decode()
    raise RuntimeError(f"{entry}: CUDA error {err}: {msg}")
