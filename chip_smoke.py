"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

builds the CUDA kernels of swraytracing_torch from the sources in this
checkout (march, transpose, build_windows, march_rays, and the first three
batched over the members of an ensemble, one launch for all), holds each
against its plain PyTorch version on the card (the march through both of its
entries: rows read by cell from the window arrays, and pre-gathered rows,
and by each of its three routes, which give the same bits: each warp's rows
staged in shared memory, a ring of slots that producer warps fill while
consumer warps march, and rows read per thread; each batched kernel also
member by member against a single-member launch, bit for bit), runs every
path once on the card and
once on the CPU at a small size and compares them (the per-stage packet path
too), then drives the main paths at full width, each with the launch counts
set to 0 just before it and read just after:

  main_path      the two-layer coupled model at 512^2 with 2^20 wave
                 packets, rk23 with 2 substeps, uv windows, (ncells, K)
                 window rows read by cell inside the march kernel, float32
                 (march + transpose);
  main_path_qg1  the one-layer coupled model at the same size with the
                 one-kernel window build (march + build_windows);
  frozen_path    2^20 packets marched 50 symplectic steps through a frozen
                 512^2 one-layer snapshot, ordered by cell, one launch per
                 segment of steps (march_rays); then a sweep of the segment
                 length, which the constant in the splitting rule is read
                 from, and the float64 time at full width;
  driver_cli     `python -m swraytracing_torch qg2` at 512^2 with 2^20
                 packets, 100 flow steps, in a subprocess: its frames,
                 run.log and metrics;
  driver_path    the two-layer production driver in diagnostic mode (omega
                 histograms on the card), 150 flow steps with a checkpoint
                 every 2 chunks (march + transpose once a flow step); then
                 100 steps resumed from their checkpoint to 150, against the
                 uninterrupted run;
  driver_reference_config
                 the reference's own configuration (256^2, 50 packets) on
                 the per-stage path, which launches no kernel of the port,
                 and 20 steps of the windowed per-stage path at full width;
  ensemble_path  the JAX package's Run I sweep (12 members, 256^2, 2^14
                 packets each) through run_sweep(ensemble=True), 300 flow
                 steps with one launch of the batched march and of the
                 batched transpose a step for all members (then a resume,
                 100 steps with the batched one-pass window build as its
                 own path, ensemble_path_fused_build, and the same members
                 one after another through the solo chunk beside it);
  grad_path      the differentiable path: the two-layer main path's
                 configuration differentiated through one flow step and a
                 chunk of 5, rematerialised and not, w.r.t. the packets'
                 wavevectors and the PV spectrum (march + transpose in the
                 forward, again in remat's recompute, the transpose in the
                 flow gradient's backward; the march's backward is autograd
                 through its plain version, timed alone as
                 march_backward_plain), one flow-gradient step of the
                 one-layer model with the one-pass window build, and the
                 JAX package's GRAD_r05 configuration (256^2, 2^14 packets,
                 50 and 250 steps) in float64 and float32 against its
                 float64 adjoints in GRAD_r05.json;
  analytic_path  the analytic and spectral evaluators, which launch no
                 kernel of the port: a frozen run through the
                 Childress-Soward flow at 2^20 packets against the CPU, the
                 O(1)-memory reversible integrator against plain autograd,
                 a gridded frozen run through prebuilt windows and through
                 the stencil, the bicubic and direct spectral evaluations
                 against the CPU;
  solvers_path   the remaining solvers, which launch no kernel of the port
                 (torch.fft and the plain stencil): every RSW variant,
                 swknd with particles, the 1-D solvers, the C-grid model,
                 QG passive particles, RSW-restart raytracing and the
                 wave/vortex spectra on the card against the CPU in float64
                 at nx=64 / n=128; then at 512^2: the nonlinear RSW 500
                 steps (float32, beside float64), swkU_tc 200 steps,
                 raytrace_rsw_restart through its final state with 2^20
                 packets, QG with 2^20 passive particles, and the C-grid
                 model in float64 with walls, beta and topography;
  multirank_path packets and members sharded over torch.distributed ranks:
                 at world size 1 over NCCL (in this process) the two- and
                 one-layer main paths through the sharded chunk (equal bit
                 for bit to main_path's and main_path_qg1's), Run I's sweep
                 on a mesh with the one-pass build, and the scaling harness
                 at 2^20 packets; then two ranks that share the card over
                 gloo (spawned processes): the two-layer main path with
                 2^19 packets a rank, gathered and held to world 1, and Run
                 I's sweep with its members split over the ranks (each
                 sweep's histograms and times equal to the one-rank sweep's;
                 the two ranks' checkpoint resumed on one rank equal to the
                 one-rank sweep resumed); last, one chunk of each coupled
                 model traced by utils.profiling.trace, for the card's idle
                 share and the five device operations that take the most.

Each phase prints one JSON line. Any failed phase raises, so the exit code
is non-zero; without a CUDA device the script fails at once and runs
nothing on the CPU in its place.

Last lines of the output: a {"kernels": [...]} line (per kernel: its time
at the main path's shapes, per call inside a run of calls queued back to
back (`single_launch_ms`: one call between two events, which also counts
the host's way to the launch), the least time the card could take for the same
bytes and operations, the plain version's time, a library call's time
where there is one, its launches on the main paths, its error against the
plain version; the march rows also hold `ms_by_route`, the kernel by each of
its routes in the same run, and `march_batched` a stepper split by route
(2, 6 and 8 stage evaluations on the same rows); the march row holds
`replaced_ms`, the time of the
stacked copy, the row gather and the pre-gathered march that the gathered
march took the place of, measured in the same run; the march_rays row the
unordered single launch of the same kernel as `replaced_ms` and the time of
its orderings and copies as `ordering_ms`), the card's name and
power limit as nvidia-smi gives them, and {"ok": true, "device": {...}}. The `kernel_bounds` line before them
holds what each bound was computed from (bytes, operations, shapes) and
the tolerances the errors were held to. The script takes no arguments.
"""

import contextlib
import dataclasses
import io
import json
import multiprocessing as mp
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from swraytracing_torch import drivers, kernels
from swraytracing_torch.analysis.device_diag import (OmegaHistSpec,
                                                     omega_hist_counts)
from swraytracing_torch.io import binio, runmeta
from swraytracing_torch.models import (cgrid, examples, examples_1d, qg, qg2,
                                       rays, rsw, sw1d)
from swraytracing_torch.models.analytic import childress_soward
from swraytracing_torch.models.coupled import (CoupledConfig,
                                               coupled_flow_packet_step,
                                               prepare_carry_windows,
                                               run_coupled_chunk,
                                               setup_coupled,
                                               window_threshold)
from swraytracing_torch.models.coupled2 import (Coupled2Config,
                                                run_coupled2_chunk,
                                                setup_coupled2)
from swraytracing_torch.models.dispersion import Dispersion
from swraytracing_torch.models.fields import (BlendedFlow, GriddedFlow,
                                              flow_from_psi_grid, flow_from_qk)
from swraytracing_torch.models.exact_linear import plane_wave_ic
from swraytracing_torch.models.frozen import (raytrace_frozen,
                                              raytrace_rsw_restart, ring_ics)
from swraytracing_torch.models.reversible import make_reversible_integrator
from swraytracing_torch.ops import march_rays as mr
from swraytracing_torch.ops import interp
from swraytracing_torch.ops.interp import interpolate_cubic
from swraytracing_torch.ops.nufft import eval_spectrum_and_grad_at
from swraytracing_torch.ops import march_window as mw
from swraytracing_torch.ops import spectral as sp
from swraytracing_torch.ops.grid import SpectralGrid
from swraytracing_torch.parallel import ensemble as ens
from swraytracing_torch.parallel import multihost
from swraytracing_torch.parallel import sharding as shd
from swraytracing_torch.parallel.scaling import measure_packet_scaling
from swraytracing_torch.utils import profiling

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and float32 / float64 rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

# The TPU kernels the CUDA kernels replace (file:line of the function
# that reaches pl.pallas_call).
# The batched kernels replace the same functions as the JAX package runs
# them under jax.vmap over an ensemble's members (parallel/ensemble.py).
REPLACES = {
    "march": "swraytracing_tpu/ops/pallas_window.py:622",
    "transpose": "swraytracing_tpu/ops/pallas_window.py:181",
    "build_windows": "swraytracing_tpu/ops/pallas_window.py:246",
    "march_rays": "swraytracing_tpu/ops/pallas_ray.py:80",
}
REPLACES.update({f"{name}_batched": REPLACES[name]
                 for name in ("march", "transpose", "build_windows")})
SOURCES = {
    "march": "swraytracing_torch/kernels/csrc/march.cuh",
    "transpose": "swraytracing_torch/kernels/csrc/transpose.cu",
    "build_windows": "swraytracing_torch/kernels/csrc/build_windows.cu",
    "march_rays": "swraytracing_torch/kernels/csrc/march_rays.cu",
}
SOURCES.update({f"{name}_batched": SOURCES[name]
                for name in ("march", "transpose", "build_windows")})
# The march kernel's sources by route: the ring route's kernel is in its own
# header, which includes march.cuh. A march row's `source` is the file of
# the route its timed launches took, `sources` both.
MARCH_SOURCES = {"staged": SOURCES["march"], "direct": SOURCES["march"],
                 "ring": "swraytracing_torch/kernels/csrc/march_ring.cuh"}
# "march" is the entry the coupled paths launch (rows read by cell);
# "march_pregathered" is the same kernel behind march_cuda, which no main
# path launches (it has no row of its own in the `kernels` line);
# "cell_order" is the counting sort of march_rays.cu that march_rays_cuda
# runs before each of its launches (counted in the march_rays row);
# "*_batched" are the kernels of an ensemble's members, one launch for all.
WRAPPERS = {
    "march": mw.march_gathered_cuda,
    "march_pregathered": mw.march_cuda,
    "transpose": mw.transpose_cuda,
    "build_windows": mw.build_windows_cuda,
    "march_rays": mr.march_rays_cuda,
    "cell_order": mr.cell_order_cuda,
    "march_batched": mw.march_gathered_batched_cuda,
    "transpose_batched": mw.transpose_batched_cuda,
    "build_windows_batched": mw.build_windows_batched_cuda,
}

# float32 tolerance of the march kernel against its plain version. Both do
# the same float32 arithmetic in the same order; the kernel contracts
# multiply-adds into FMAs (one rounding instead of two) and skips window
# entries of weight zero, so results differ by a few ulp per operation:
# |k| ~ 10 gives ~1e-6 absolute. A packet whose stage position rounds to
# the other side of a cell edge switches stencil, which moves the
# interpolant's derivative by its truncation error; that stays below this
# tolerance too.
F32_RTOL, F32_ATOL = 2e-5, 2e-6
F64_ATOL = 1e-12

# Tolerances of the frozen-flow march kernel against its plain version over
# 50 steps. float64: the 1e-10 the JAX package holds its TPU kernel to
# against its own plain version. float32: both sides round |x| < 8 (ulp
# 4.8e-7) three times and |k| ~ 5..8 once per step, in a different order
# (FMA contraction, the 36-term stencil sum, reciprocal denominators), so
# the two states random-walk apart by a few 1e-6 over 50 steps and 10^6
# packets; a stencil switch at a cell edge changes nothing to this
# accuracy, because the interpolant is continuous through the nodes.
RAYS_F32_ATOL = 2e-5
RAYS_F64_ATOL = 1e-10
RAYS_STEPS = 50

# Timed chunks of packet_steps_per_save flow steps on the main path, after
# two warm-up chunks.
N_CHUNKS = 5


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Median time of fn() in ms over `reps` launches, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_run(fn, launches=20, reps=5):
    """Time of one fn() in ms inside a run of `launches` calls queued back
    to back between two CUDA events (median of `reps` runs). One call
    between two events also counts the host's way from the first event to
    the launch (about 0.05 ms through a kernel wrapper here), which is as
    long as the shortest kernels; in a run the launches queue up and the
    card's own time per call remains, or the host's time per call where
    that is the longer."""
    return cuda_ms(lambda: [fn() for _ in range(launches)], reps) / launches


MARCH_WRAPPERS = (mw.march_gathered_cuda, mw.march_cuda,
                  mw.march_gathered_batched_cuda)


def reset_launches():
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    mw.transpose_cuda.launches_by_direction = dict.fromkeys(
        mw.transpose_cuda.launches_by_direction, 0)
    for wrapper in MARCH_WRAPPERS:
        wrapper.launches_by_route = dict.fromkeys(
            wrapper.launches_by_route, 0)
    mw.gather_packet_windows.calls = 0


def read_launches():
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    kernels.load()
    regs = [int(line.split("Used ")[1].split(" registers")[0])
            for line in kernels.build_info["log"].splitlines()
            if "Used " in line and " registers" in line]
    spills = sum(int(line.split(" bytes spill stores")[0].split()[-1])
                 for line in kernels.build_info["log"].splitlines()
                 if "bytes spill stores" in line)
    # registers per kernel, keyed by the kernel's name and template
    # arguments as they stand in the mangled name (scalar type f/d, then
    # for the march gradient-from-interpolant and stepper, for the ray
    # march the order)
    def kernel_name(symbol):
        found = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?)EEv", symbol)
        return found.group(1) if found else symbol

    names = [kernel_name(line.split("'")[1])
             for line in kernels.build_info["log"].splitlines()
             if "Compiling entry function" in line]
    by_kernel = dict(zip(names, regs))
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=kernels.build_info["seconds"],
         sources=[s.name for s in kernels.sources()],
         nvcc_flags=" ".join(kernels.NVCC_FLAGS),
         kernels_compiled=len(regs), max_registers=max(regs, default=None),
         spill_store_bytes=spills, registers=by_kernel)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def smooth_fields(rng, n, nx):
    def smooth():
        f = rng.standard_normal((nx, nx))
        fk = np.fft.rfft2(f)
        kx = np.fft.fftfreq(nx)[:, None]
        ky = np.fft.rfftfreq(nx)[None, :]
        fk *= np.exp(-((kx * nx / 6) ** 2 + (ky * nx / 6) ** 2))
        return np.fft.irfft2(fk, s=(nx, nx))

    return np.stack([smooth() for _ in range(n)])


def march_inputs(spec, F1, F2, x, k):
    """(pw1, pw2, xk, oi, oj) through the port's own build and gather."""
    W1 = mw.build_gather_windows(F1, spec)
    W2 = mw.build_gather_windows(F2, spec)
    oi, oj = mw.packet_cells(x[0], x[1], spec)
    xk = torch.cat([x, k], dim=0)
    if spec.combined_gather:
        Wc = torch.cat([W1, W2], dim=-1 if spec.tiles_transposed else 0)
        return (mw.gather_packet_windows(Wc, oi, oj, spec),
                xk.new_zeros((1, 1)), xk, oi, oj)
    return (mw.gather_packet_windows(W1, oi, oj, spec),
            mw.gather_packet_windows(W2, oi, oj, spec), xk, oi, oj)


def gathered_inputs(spec, F1, F2, x, k):
    """(win1, win2, xk, oi, oj): the two cell-window arrays themselves."""
    oi, oj = mw.packet_cells(x[0], x[1], spec)
    return (mw.build_gather_windows(F1, spec),
            mw.build_gather_windows(F2, spec), torch.cat([x, k], dim=0),
            oi, oj)


def route_taken(fn, wrapper=mw.march_gathered_cuda):
    """Run fn() and read, from the march wrapper's own counts, the one
    route its launches took. Returns (fn's result, route)."""
    counts = wrapper.launches_by_route
    before = dict(counts)
    result = fn()
    took = [route for route in counts if counts[route] > before[route]]
    if len(took) != 1:
        raise AssertionError(f"the march launches took the routes {took}")
    return result, took[0]


def compare_march(inputs, sub_dt, spec, rtol, atol, label,
                  kernel=mw.march_cuda, plain=mw.march_reference):
    """A march entry's kernel against its plain version on the same CUDA
    tensors. Returns (max abs error, largest error as a share of the
    tolerance, largest overflow, the kernel's output, the route its launch
    took)."""
    (got, ov), route = route_taken(lambda: kernel(*inputs, sub_dt, spec),
                                   kernel)
    want, ov_want = plain(*inputs, sub_dt, spec)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel output is not finite")
    if not torch.equal(ov, ov_want):
        raise AssertionError(
            f"{label}: overflow differs at "
            f"{int((ov != ov_want).sum())} of {ov.numel()} packets")
    err = (got - want).abs()
    share = float((err / (atol + rtol * want.abs())).max())
    if share > 1.0:
        raise AssertionError(
            f"{label}: max abs err {float(err.max()):.3e} exceeds "
            f"atol={atol} rtol={rtol} ({share:.2f}x)")
    return float(err.max()), share, int(ov.max()), got, route


def fits_staged(spec, dtype):
    """Whether a block of spec.block threads can stage its rows."""
    return spec.block <= mw.staged_block_limit(spec, dtype)


def fits_ring(spec, dtype):
    """Whether two ring slots of 32 rows fit in an SM's shared memory."""
    return mw.ring_slots(spec, dtype) >= 2


def ring_sweep(spec, dtype):
    """The ring route's consumer warps to time: S - 1, S - 2 and S - 3 of
    S slots, as many of them as the route takes."""
    slots = mw.ring_slots(spec, dtype)
    top = min(slots - 1, mw.RING_MAX_CONSUMERS)
    return sorted({c for c in (slots - 1, slots - 2, slots - 3)
                   if 1 <= c <= top}, reverse=True)


def march_by_route(win1, win2, xk, oi, oj, sub_dt, spec, route,
                   consumers=None):
    """The gathered march by a named route (on the ring route with
    `consumers` consumer warps), whatever march_route would pick: to hold
    one route against another and to time them."""
    return mw.march_gathered_cuda(win1, win2, xk, oi, oj, sub_dt, spec,
                                  route=route, consumers=consumers)


def check_gathered_march(dtype, rtol, atol, F1, F2, x, k, xr, kr, spec_for,
                         dx):
    """The march with the gather inside the kernel, against its plain
    version, against the pre-gathered entry on index_select-ed rows (bit
    for bit), and one route against the other (bit for bit)."""
    worst_err, worst_share, cases, routes = 0.0, 0.0, 0, {}

    def one(spec, xx, kk, sub_dt, label, overflow_wanted=False, rtol=rtol):
        nonlocal worst_err, worst_share, cases
        inputs = gathered_inputs(spec, F1, F2, xx, kk)
        err, share, ovmax, got, route = compare_march(
            inputs, sub_dt, spec, rtol, atol, label,
            kernel=mw.march_gathered_cuda,
            plain=mw.march_gathered_reference)
        if (ovmax > 0) != overflow_wanted:
            raise AssertionError(f"{label}: overflow {ovmax}")
        win1, win2, xk, oi, oj = inputs
        split = spec._replace(combined_gather=False)
        pre, ov_pre = mw.march_cuda(
            mw.gather_packet_windows(win1, oi, oj, split),
            mw.gather_packet_windows(win2, oi, oj, split), xk, oi, oj,
            sub_dt, split)
        if not torch.equal(pre, got):
            raise AssertionError(f"{label}: the gathered kernel differs from "
                                 "the pre-gathered kernel on gathered rows")
        for other in ("staged", "direct", "ring"):
            if other == route or (other == "staged"
                                  and not fits_staged(spec, dtype)) or (
                                      other == "ring"
                                      and not fits_ring(spec, dtype)):
                continue
            alt, ov_alt = march_by_route(*inputs, sub_dt, spec, other)
            if not (torch.equal(alt, got) and int(ov_alt.max()) == ovmax):
                raise AssertionError(f"{label}: the {other} route differs "
                                     f"from the {route} route")
        routes[label] = route
        worst_err, worst_share = max(worst_err, err), max(worst_share, share)
        cases += 1
        return inputs, got

    for stepper in ("rk23", "rk4", "symplectic"):
        for nf in (2, 6):
            for margin in (1, 2):
                spec = spec_for(stepper=stepper, nf=nf, margin=margin,
                                tiles_transposed=True, combined_gather=True)
                one(spec, x, k, 0.1 * margin * dx,
                    f"gathered {stepper} nf={nf} m={margin}")
    # a packet count that no warp or block divides
    for nf, margin in ((2, 1), (6, 2)):
        spec = spec_for(stepper="rk23", nf=nf, margin=margin,
                        tiles_transposed=True)
        one(spec, xr, kr, 0.1 * margin * dx,
            f"gathered ragged Np={xr.shape[1]} nf={nf} m={margin}")
    spec = spec_for(stepper="rk23", nf=2, margin=1, tiles_transposed=True)
    # frozen packets: xk comes back bit for bit
    inputs, got = one(spec, xr, kr, 0.0, "gathered sub_dt=0")
    if not torch.equal(got, inputs[2]):
        raise AssertionError(f"{dtype}: gathered sub_dt=0 is not the identity")
    if dtype == torch.float64:
        # a substep long enough to leave the margin: overflow > 0, equal
        # on both sides (|x| grows to O(100): relative tolerance)
        one(spec, x, k, 5.0 * dx, "gathered forced overflow",
            overflow_wanted=True, rtol=1e-12)
    return {"cases": cases, "max_abs_err": worst_err, "rtol": rtol,
            "atol": atol, "worst_share_of_tolerance": worst_share,
            "equals_pregathered_kernel_bit_for_bit": True,
            "routes_equal_bit_for_bit": True, "routes": routes}


def check_build_windows(dev):
    """K3 against its plain version and the two-pass route: exact. SW = 8,
    10 (a thread's four components straddle a window row) and 12; two and
    six fields; nx != ny; sides that no run of cells or block divides; a
    row longer than one run (150 > 64); a window as wide as the grid (SW =
    8 on 8 x 12) and wider (SW = 12 on 9 x 71); a window too large for the
    shared-memory tile (float64, six fields, SW = 30), which the kernel
    reads per thread."""
    g = torch.Generator(device=dev).manual_seed(11)
    grids = [(64, 64), (48, 80), (37, 53), (24, 150), (9, 71), (8, 12)]
    cases, unstaged = 0, 0
    for dtype in (torch.float32, torch.float64):
        for nx, ny in grids:
            F = torch.randn((6, nx, ny), dtype=dtype, device=dev, generator=g)
            for nf in (2, 6):
                margins = [1, 2, 3]
                if (nx, ny) == (37, 53) and nf == 6:
                    margins.append(12)
                for margin in margins:
                    if 3 + margin > min(nx, ny):
                        continue  # the window does not fit this grid
                    spec = mw.MarchSpec(
                        nx=nx, ny=ny, dx=1.0, dy=1.0, f=3.0, Cg=1.0, nf=nf,
                        grad_from_interp=nf == 2, margin=margin,
                        tiles_transposed=True, fused_build=True)
                    got = mw.build_windows_cuda(F, spec)
                    torch.cuda.synchronize()
                    label = f"build_windows {dtype} {nx}x{ny} nf={nf} m={margin}"
                    if not (got.is_contiguous()
                            and got.shape == (nx * ny, spec.K)):
                        raise AssertionError(f"{label}: layout")
                    if not torch.equal(got,
                                       mw.build_windows_reference(F, spec)):
                        raise AssertionError(f"{label}: differs from the "
                                             "plain version")
                    if not torch.equal(
                            got, mw.build_margin_windows(F, spec).t()):
                        raise AssertionError(f"{label}: differs from the "
                                             "two-pass route")
                    if not torch.equal(got,
                                       mw.build_gather_windows(F, spec)):
                        raise AssertionError(f"{label}: build_gather_windows "
                                             "took another route")
                    cases += 1
                    unstaged += margin == 12 and dtype == torch.float64
    if unstaged != 1:
        raise AssertionError("the window too large to stage was not built")
    return {"cases": cases, "grids": grids, "margins": [1, 2, 3, 12],
            "nf": [2, 6], "exact": True, "dtypes": ["float32", "float64"]}


def analytic_flow_fields(nx, dtype, dev):
    """The six grids of a steady cellular flow (the flow of the JAX
    package's own test of its ray-march kernel)."""
    grid = SpectralGrid.square(nx)
    X, Y = grid.meshgrid()
    psi = 0.1 * (np.sin(X) * np.sin(Y) + 0.25 * np.cos(X) * np.cos(Y))
    flow = flow_from_psi_grid(torch.as_tensor(psi, dtype=dtype, device=dev),
                              grid)
    return grid, flow.fields


def compare_rays(got, want, atol, label):
    """Kernel state (x, k) against the plain version's. Returns the max
    abs error."""
    worst = 0.0
    for name, g, w in zip("xk", got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: kernel {name} is not finite")
        err = float((g - w).abs().max())
        if err > atol:
            raise AssertionError(f"{label}: {name} max abs err {err:.3e} "
                                 f"exceeds atol={atol}")
        worst = max(worst, err)
    return worst


def unordered_march(fields, x0, k0, grid, disp, dt, nsteps, order=2):
    """K4 as one launch on the packets as they come: what the ordered,
    segmented march is held equal to, bit for bit."""
    return mr.march_rays_cuda_by(fields, x0, k0, grid, disp, dt, nsteps,
                                 order, segment=max(1, nsteps),
                                 ordered=False)


def require_same_bits(got, want, label):
    for name, g, w in zip("xk", got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"{label}: {name} differs in {int((g != w).sum())} of "
                f"{g.numel()} values")


def check_cell_order(x, grid, label):
    """The counting sort of march_rays.cu against its plain version: a
    permutation of all packets that puts the plain keys in order."""
    perm = mr.cell_order_cuda(x, grid).long()
    keys = mr.packet_cell_keys(x, grid)
    n_p = x.shape[1]
    if not torch.equal(torch.sort(perm).values,
                       torch.arange(n_p, device=x.device)):
        raise AssertionError(f"{label}: not a permutation")
    if not torch.equal(keys[perm], keys[mr.cell_order_reference(x, grid)]):
        raise AssertionError(f"{label}: the keys are not in order")


def check_march_rays(dev):
    """K4 against its plain version: orders 1-3, a ragged packet count,
    packets planted on the mod/floor edges; and in every case the ordered,
    segmented march (the entry itself, and named segment lengths) against
    one launch on the unordered packets, bit for bit."""
    nx, n_p = 64, 2 ** 16 + 37   # not a multiple of the block
    L = 2.0 * np.pi
    dx = L / nx
    disp = Dispersion(f=3.0, Cg=1.0)
    rng = np.random.default_rng(20240602)
    xh = rng.uniform(0.0, L, (2, n_p))
    ang = 2 * np.pi * np.arange(n_p) / n_p
    kh = 8.0 * np.stack([np.cos(ang), np.sin(ang)])
    # just below 0 (mod gives exactly nx), exactly L, one ulp either side
    # of a cell edge
    xh[:, 0] = [-1e-18, L]
    xh[:, 1] = [L, -1e-18]
    report = {}
    for dtype, atol in ((torch.float64, RAYS_F64_ATOL),
                        (torch.float32, RAYS_F32_ATOL)):
        grid, fields = analytic_flow_fields(nx, dtype, dev)
        x0 = torch.as_tensor(xh, dtype=dtype, device=dev)
        k0 = torch.as_tensor(kh, dtype=dtype, device=dev)
        # the neighbours of two cell edges in the working precision
        for col, cells in ((2, 1.0), (3, 5.0)):
            edge = torch.tensor(cells * dx, dtype=dtype, device=dev)
            x0[0, col] = torch.nextafter(edge, torch.zeros_like(edge))
            x0[1, col] = torch.nextafter(edge, 10.0 * torch.ones_like(edge))
        check_cell_order(x0, grid, f"cell_order {dtype}")
        worst, cases = 0.0, 0
        for order in (1, 2, 3):
            args = (fields, x0, k0, grid, disp, 0.005, RAYS_STEPS, order)
            got = mr.march_rays_cuda(*args)
            segments = list(mr.march_rays_cuda.last_segments)
            torch.cuda.synchronize()
            if len(segments) < 2 or sum(segments) != RAYS_STEPS:
                raise AssertionError(f"march_rays {dtype}: segments "
                                     f"{segments}")
            label = f"march_rays {dtype} order={order}"
            worst = max(worst, compare_rays(
                got, mr.march_rays_reference(*args), atol, label))
            single = unordered_march(*args)
            require_same_bits(got, single, label + " ordered vs unordered")
            cases += 1
        # a segment that does not divide the steps (8 launches of 7 and 6),
        # one step a segment, segments without the ordering
        args = (fields, x0, k0, grid, disp, 0.005, RAYS_STEPS)
        single = unordered_march(*args)
        for kw in ({"segment": 7}, {"segment": 1},
                   {"segment": 7, "ordered": False}):
            require_same_bits(mr.march_rays_cuda_by(*args, **kw), single,
                              f"march_rays {dtype} {kw}")
            cases += 1
        if mr.march_rays_cuda.last_segments != [7, 7, 6, 6, 6, 6, 6, 6]:
            raise AssertionError("segments of 50 steps by 7: "
                                 f"{mr.march_rays_cuda.last_segments}")
        # all packets in one cell (every atomic of the ordering on one
        # counter), spread inside it
        xc = 10.05 * dx + 0.9 * dx * (x0 / L)
        check_cell_order(xc, grid, f"cell_order one cell {dtype}")
        if int(torch.unique(mr.packet_cell_keys(xc, grid)).numel()) != 1:
            raise AssertionError("the one-cell case covers several cells")
        args = (fields, xc, k0, grid, disp, 0.005, 20)
        got = mr.march_rays_cuda(*args)
        require_same_bits(got, unordered_march(*args),
                          f"march_rays {dtype} one cell")
        worst = max(worst, compare_rays(
            got, mr.march_rays_reference(*args), atol,
            f"march_rays {dtype} one cell"))
        cases += 1
        # no steps: the state comes back bit for bit, nothing is launched
        before = mr.march_rays_cuda.launches
        same = mr.march_rays_cuda(fields, x0, k0, grid, disp, 0.005, 0)
        if not (torch.equal(same[0], x0) and torch.equal(same[1], k0)):
            raise AssertionError(f"{dtype}: nsteps=0 is not the identity")
        if mr.march_rays_cuda.launches != before:
            raise AssertionError(f"{dtype}: nsteps=0 launched a kernel")
        cases += 1
        report[str(dtype)] = {"cases": cases, "max_abs_err": worst,
                              "atol": atol, "share_of_tolerance": worst / atol,
                              "ordered_equals_unordered_bit_for_bit": True,
                              "segments_of_the_entry": segments}
    # an order the library has no kernel for: the wrapper raises, and so
    # does the C entry's -1
    before = mr.march_rays_cuda.launches
    try:
        mr.march_rays_cuda(fields, x0, k0, grid, disp, 0.005, 1, order=4)
    except ValueError:
        pass
    else:
        raise AssertionError("march_rays_cuda accepted order=4")
    err = kernels.load().swr_march_rays_f32(
        fields.data_ptr(), x0.data_ptr(), k0.data_ptr(), x0.data_ptr(),
        k0.data_ptr(), None, n_p, nx, nx, dx, dx, 0.005, 9.0, 1.0, 1, 4, 128,
        torch.cuda.current_stream().cuda_stream)
    try:
        kernels.check(err, "swr_march_rays")
    except RuntimeError:
        pass
    else:
        raise AssertionError("swr_march_rays_f32 launched order=4")
    if mr.march_rays_cuda.launches != before:
        raise AssertionError("a refused launch was counted")
    report.update(n_packets=n_p, nx=nx, steps=RAYS_STEPS, orders=[1, 2, 3],
                  unsupported_order_raises=True)
    return report


def require_one_launch(wrapper, fn, label):
    """Run fn() and check that it launched `wrapper`'s kernel exactly once."""
    before = wrapper.launches
    result = fn()
    if wrapper.launches != before + 1:
        raise AssertionError(f"{label}: {wrapper.launches - before} launches, "
                             "expected one for all members")
    return result


def check_batched_kernels(dev):
    """The three batched kernels (one launch for all members of an
    ensemble) at Run I's shape (12 members, 256^2, 2^14 packets each, rk23
    with 2 substeps, uv windows, margin 1, K = 128, float32) and in float64
    on a small case: each against its plain version, and each member
    against a single-member launch of the solo kernel on its own arrays,
    bit for bit. The batched march by each of its routes (staged, ring,
    direct) against the single-member launch of the same route, and the
    ring's output, at each consumer count of the sweep, equal to the
    staged route's bit for bit and within the tolerance of the plain
    version. Every member has its own substep length; member 0 has
    sub_dt = 0 and its packets come back unchanged."""
    report = {}
    for dtype, rtol, atol, E, nx, n_p in (
            (torch.float32, F32_RTOL, F32_ATOL, 12, 256, 2 ** 14),
            (torch.float64, 0.0, F64_ATOL, 3, 64, 4096)):
        L = 2.0 * np.pi
        dx = L / nx
        rng = np.random.default_rng(20240603)
        F = torch.as_tensor(np.stack([smooth_fields(rng, 4, nx)
                                      for _ in range(E)]),
                            dtype=dtype, device=dev)
        xh = rng.uniform(0.0, L, (E, 2, n_p))
        xh[:, :, 0] = [-1e-18, L]
        xh[:, :, 1] = [L, -1e-18]
        xh[:, :, 2] = [np.nextafter(dx, 0), np.nextafter(dx, 1)]
        x = torch.as_tensor(xh, dtype=dtype, device=dev)
        k = torch.as_tensor(rng.normal(0.0, 3.0, (E, 2, n_p)), dtype=dtype,
                            device=dev)
        spec = mw.MarchSpec(nx=nx, ny=nx, dx=dx, dy=dx, f=3.0, Cg=1.0,
                            n_substeps=2, nf=2, grad_from_interp=True,
                            margin=1, tiles_transposed=True)
        label = f"batched {dtype} E={E}"
        wins = []
        for F_ in (F[:, :2].contiguous(), F[:, 2:].contiguous()):
            W = mw.build_margin_windows(F_, spec).contiguous()
            win = require_one_launch(mw.transpose_batched_cuda,
                                     lambda: mw.transpose_batched_cuda(W),
                                     label)
            built = require_one_launch(
                mw.build_windows_batched_cuda,
                lambda: mw.build_windows_batched_cuda(F_, spec), label)
            torch.cuda.synchronize()
            if tuple(win.shape) != (E, nx * nx, spec.K):
                raise AssertionError(f"{label}: window shape {win.shape}")
            if not torch.equal(win, mw.transpose_batched_reference(W)):
                raise AssertionError(f"{label}: transpose_batched differs "
                                     "from its plain version")
            if not torch.equal(built, mw.build_windows_batched_reference(
                    F_, spec)) or not torch.equal(built, win):
                raise AssertionError(f"{label}: build_windows_batched differs "
                                     "from its plain version or the two-pass "
                                     "route")
            for e in range(E):
                if not (torch.equal(win[e], mw.transpose_cuda(W[e]))
                        and torch.equal(built[e],
                                        mw.build_windows_cuda(F_[e], spec))):
                    raise AssertionError(f"{label}: member {e} differs from "
                                         "its single-member launch")
            wins.append(win)
            del W, built
        oi, oj = mw.packet_cells(x[:, 0], x[:, 1], spec)
        xk = torch.cat([x, k], dim=1)
        sub_dt = torch.tensor([0.1 * dx * e / E for e in range(E)],
                              dtype=torch.float64, device=dev)
        inputs = (*wins, xk, oi, oj)
        err, share, ovmax, got, route = require_one_launch(
            mw.march_gathered_batched_cuda,
            lambda: compare_march(inputs, sub_dt, spec, rtol, atol, label,
                                  kernel=mw.march_gathered_batched_cuda,
                                  plain=mw.march_gathered_batched_reference),
            label)
        if ovmax != 0:
            raise AssertionError(f"{label}: overflow {ovmax}")
        if not torch.equal(got[0], xk[0]):
            raise AssertionError(f"{label}: the member at sub_dt = 0 moved")
        want, ov_want = mw.march_gathered_batched_reference(*inputs, sub_dt,
                                                            spec)
        routes, by_route = {}, {}
        for r in ("staged", "ring", "direct"):
            if (r == "staged" and not fits_staged(spec, dtype)) or (
                    r == "ring" and not fits_ring(spec, dtype)):
                continue
            out, ov = mw.march_gathered_batched_cuda(*inputs, sub_dt, spec,
                                                     route=r)
            by_route[r] = (out, ov)
            for e in range(E):
                solo, ov_solo = mw.march_gathered_cuda(
                    wins[0][e], wins[1][e], xk[e], oi[e], oj[e],
                    float(sub_dt[e]), spec, route=r)
                if not (torch.equal(out[e], solo)
                        and torch.equal(ov[e], ov_solo)):
                    raise AssertionError(f"{label} {r}: member {e} differs "
                                         "from its single-member launch")
            routes[r] = f"{E} members equal their single-member launches"
        ring_check = {}
        if "ring" in by_route and "staged" in by_route:
            staged, ov_staged = by_route["staged"]
            for c in ring_sweep(spec, dtype):
                out, ov = mw.march_gathered_batched_cuda(
                    *inputs, sub_dt, spec, route="ring", consumers=c)
                torch.cuda.synchronize()
                if not (torch.equal(out, staged)
                        and torch.equal(ov, ov_staged)):
                    raise AssertionError(f"{label}: the ring route with {c} "
                                         "consumers differs from the staged "
                                         "route")
                ring_share = float(((out - want).abs()
                                    / (atol + rtol * want.abs())).max())
                if ring_share > 1.0 or not torch.equal(ov, ov_want):
                    raise AssertionError(
                        f"{label}: the ring route with {c} consumers is "
                        f"{ring_share:.2f}x the tolerance from the plain "
                        "version")
                ring_check[f"consumers={c}"] = {
                    "equals_staged_bit_for_bit": True,
                    "share_of_tolerance": ring_share}
        report[str(dtype)] = {
            "members": E, "nx": nx, "n_packets_per_member": n_p,
            "K": spec.K, "sub_dt_over_dx": [float(v) / dx for v in sub_dt],
            "march_max_abs_err": err, "rtol": rtol, "atol": atol,
            "share_of_tolerance": share, "route_by_the_rule": route,
            "routes_against_solo": routes, "ring_slots":
                mw.ring_slots(spec, dtype), "ring_against_staged": ring_check,
            "transpose_and_build_exact": True,
            "members_equal_solo_launches_bit_for_bit": True,
            "member_at_sub_dt_0_unchanged": True, "launches_per_call": 1}
        del wins, inputs, got, want, by_route
    return report


def phase_kernels_vs_plain(dev):
    nx, n_p = 64, 2 ** 16
    L = 2.0 * np.pi
    dx = L / nx
    rng = np.random.default_rng(20240601)
    F1h, F2h = smooth_fields(rng, 6, nx), smooth_fields(rng, 6, nx)
    xh = rng.uniform(0.0, L, (2, n_p))
    kh = rng.normal(0.0, 3.0, (2, n_p))
    # mod/floor edges: just below 0, exactly L, on and around a cell edge
    xh[:, 0] = [-1e-18, L]
    xh[:, 1] = [L, -1e-18]
    xh[:, 2] = [np.nextafter(dx, 0), np.nextafter(dx, 1)]
    # the same with a count that no warp or block divides, as K4's cases
    n_r = n_p + 37
    xrh = np.concatenate([xh, rng.uniform(0.0, L, (2, 37))], axis=1)
    krh = np.concatenate([kh, rng.normal(0.0, 3.0, (2, 37))], axis=1)

    report = {}
    for dtype, rtol, atol in ((torch.float64, 0.0, F64_ATOL),
                              (torch.float32, F32_RTOL, F32_ATOL)):
        F1, F2, x, k, xr, kr = (torch.as_tensor(a, dtype=dtype, device=dev)
                                for a in (F1h, F2h, xh, kh, xrh, krh))
        worst_err, worst_share, cases, routes = 0.0, 0.0, 0, {}

        def spec_for(**kw):
            nf = kw.pop("nf", 6)
            return mw.MarchSpec(nx=nx, ny=nx, dx=dx, dy=dx, f=3.0, Cg=1.0,
                                n_substeps=2, nf=nf,
                                grad_from_interp=nf == 2, **kw)

        for stepper in ("rk23", "rk4", "symplectic"):
            for nf in (2, 6):
                for combined in (True, False):
                    for transposed in (True, False):
                        for margin in (1, 2):
                            spec = spec_for(
                                stepper=stepper, nf=nf, margin=margin,
                                combined_gather=combined,
                                tiles_transposed=transposed)
                            label = (f"{dtype} {stepper} nf={nf} "
                                     f"combined={combined} "
                                     f"transposed={transposed} m={margin}")
                            err, share, ovmax, _, route = compare_march(
                                march_inputs(spec, F1, F2, x, k),
                                0.1 * margin * dx, spec, rtol, atol, label)
                            if ovmax != 0:
                                raise AssertionError(
                                    f"{label}: unexpected overflow {ovmax}")
                            routes[label] = route
                            worst_err = max(worst_err, err)
                            worst_share = max(worst_share, share)
                            cases += 1
        # ragged packet count, row layout (combined) and (K, Np) layout
        for transposed in (True, False):
            spec = spec_for(stepper="rk23", nf=2, margin=1,
                            combined_gather=transposed,
                            tiles_transposed=transposed)
            label = f"{dtype} ragged Np={n_r} transposed={transposed}"
            err, share, ovmax, _, route = compare_march(
                march_inputs(spec, F1, F2, xr, kr), 0.1 * dx, spec, rtol,
                atol, label)
            if ovmax != 0:
                raise AssertionError(f"{label}: unexpected overflow {ovmax}")
            routes[label] = route
            worst_err, worst_share = max(worst_err, err), max(worst_share,
                                                              share)
            cases += 1
        spec = spec_for(stepper="rk23", nf=2, margin=1, combined_gather=True,
                        tiles_transposed=True)
        inputs = march_inputs(spec, F1, F2, x, k)
        # frozen packets: xk comes back bit for bit
        got, ov = mw.march_cuda(*inputs, 0.0, spec)
        if not (torch.equal(got, inputs[2]) and int(ov.max()) == 0):
            raise AssertionError(f"{dtype}: sub_dt=0 is not the identity")
        cases += 1
        extra = {}
        if dtype == torch.float64:
            # a substep long enough to leave the margin: overflow > 0,
            # equal on both sides (the MAX over stages and substeps)
            err, share, ovmax, _, _ = compare_march(
                inputs, 5.0 * dx, spec, 1e-12, F64_ATOL,
                "float64 forced overflow")
            if ovmax <= 0:
                raise AssertionError("forced-overflow case did not overflow")
            extra = {"forced_overflow_max": ovmax,
                     "forced_overflow_max_abs_err": err}
            cases += 1
        report[str(dtype)] = {
            "cases": cases, "max_abs_err": worst_err, "rtol": rtol,
            "atol": atol, "worst_share_of_tolerance": worst_share, **extra,
            "routes": routes,
            "gathered": check_gathered_march(dtype, rtol, atol, F1, F2, x, k,
                                             xr, kr, spec_for, dx)}

    # transpose: exact equality
    shapes = [(128, 262144), (262144, 128), (130, 1000)]
    g = torch.Generator(device=dev).manual_seed(7)
    for dtype in (torch.float32, torch.float64):
        for shape in shapes:
            W = torch.randn(shape, dtype=dtype, device=dev, generator=g)
            got = mw.transpose_cuda(W)
            torch.cuda.synchronize()
            if not (got.is_contiguous()
                    and torch.equal(got, mw.transpose_reference(W))):
                raise AssertionError(f"transpose differs at {shape} {dtype}")
    report["transpose"] = {"shapes": shapes, "exact": True,
                           "dtypes": ["float32", "float64"]}
    report["build_windows"] = check_build_windows(dev)
    report["march_rays"] = check_march_rays(dev)
    report["batched"] = check_batched_kernels(dev)
    emit("kernels_vs_plain", n_packets=n_p, nx=nx, **report)


# ---------------------------------------------------------------------------
# every path, card against CPU
# ---------------------------------------------------------------------------

def coupled_card_vs_cpu(dev, cfg, setup, run_chunk, march=True):
    """Two chunks of 5 flow steps of a coupled model in float64 on the card
    and on the CPU, compared. march: whether the fused march is engaged (the
    per-stage path when not)."""
    out = {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        s, carry = setup(cfg, device=device, dtype=torch.float64)
        carry, (px, pk, ts) = run_chunk(carry, s, cfg, 2)
        out[name] = (s, carry, px.cpu(), pk.cpu(), ts)
    (sg, cg, pxg, pkg, tsg), (sc, cc, pxc, pkc, tsc) = out["cuda"], out["cpu"]
    if sg.march != sc.march or (sg.march is not None) != march:
        raise AssertionError("march specs differ between card and CPU, or "
                             "the march is (not) engaged")
    # cuFFT and the CPU FFT differ in the last bits; 10 steps keep that
    # far below these tolerances
    torch.testing.assert_close(pxg, pxc, rtol=0, atol=1e-9)
    torch.testing.assert_close(pkg, pkc, rtol=0, atol=1e-9)
    qg_, qc_ = cg.flow_state.qk.cpu(), cc.flow_state.qk
    if not float((qg_ - qc_).abs().max()) <= 1e-9 * float(qc_.abs().max()):
        raise AssertionError("qk differs between card and CPU")
    if not float((pxc[-1] - pxc[0]).abs().max()) > 0:
        raise AssertionError("packets did not move in path_vs_cpu")
    result = dict(nx=cfg.nx, n_packets=cfg.n_packets, flow_steps=10,
                  max_abs_dx=float((pxg - pxc).abs().max()),
                  max_abs_dk=float((pkg - pkc).abs().max()),
                  max_rel_dqk=float((qg_ - qc_).abs().max()
                                    / qc_.abs().max()))
    if not march:
        if cg.overflow is not None or cc.overflow is not None:
            raise AssertionError("the per-stage path carries an overflow")
        return dict(result, windowed=cg.prev_win is not None)
    if int(cg.overflow) != int(cc.overflow):
        raise AssertionError("overflow differs between card and CPU")
    return dict(result, overflow=int(cg.overflow), margin=sg.march.margin,
                fused_build=sg.march.fused_build)


def rays_card_vs_cpu(dev):
    """march_rays on the card (the kernel) and on the CPU (the plain
    version) through a frozen one-layer snapshot, float64."""
    nx, n_p = 64, 4096
    grid = SpectralGrid.square(nx)
    disp = Dispersion(f=3.0, Cg=1.0)
    qk = qg.initial_q_ring(146, grid, 0.4, 3.0, device="cpu",
                           dtype=torch.float64)
    fields = flow_from_qk(qk, grid, 3.0).fields
    x0, k0 = ring_ics(n_p, 2.0, disp, device="cpu", dtype=torch.float64)
    args = (grid, disp, 0.01, RAYS_STEPS)
    xc, kc = mr.march_rays(fields, x0, k0, *args)
    xg, kg = mr.march_rays(fields.to(dev), x0.to(dev), k0.to(dev), *args)
    err = compare_rays((xg.cpu(), kg.cpu()), (xc, kc), RAYS_F64_ATOL,
                       "march_rays card vs CPU")
    if not float((xc - x0).abs().max()) > 1e-2:
        raise AssertionError("packets did not move in rays_card_vs_cpu")
    return dict(nx=nx, n_packets=n_p, steps=RAYS_STEPS, max_abs_err=err,
                atol=RAYS_F64_ATOL)


def ensemble_card_vs_cpu(dev, base, march):
    """Two chunks of 5 flow steps of a 3-member ensemble in float64 on the
    card and on the CPU, compared; member 0 is past its T from the start
    and must keep its state bit for bit on both. march: whether the fused
    march is engaged (one launch of the batched march and of the batched
    window build a flow step on the card), else the per-stage stencil
    path (no kernel)."""
    cfgs = ens.sweep_configs(base, w0s=(2.0, 4.0, 8.0), ugs=(0.6,))
    out = {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        s, es, carry0 = ens.setup_ensemble(cfgs, device=device,
                                           dtype=torch.float64)
        es = es.replace(T=np.concatenate([[0.0], es.T[1:]]))
        before = read_launches()
        carry, (px, pk, ts) = ens.run_ensemble_chunk(carry0, es, s, base, 2)
        after = read_launches()
        fs0, fs = carry0.flow_state, carry.flow_state
        frozen = (all(torch.equal(getattr(fs, f)[0], getattr(fs0, f)[0])
                      for f in ("qk", "rhs_m1", "rhs_m2"))
                  and torch.equal(carry.packet_x[0], carry0.packet_x[0])
                  and torch.equal(carry.packet_k[0], carry0.packet_k[0])
                  and torch.equal(carry.prev_fields[0], carry0.prev_fields[0])
                  and fs.t[0] == 0.0 and fs.step[0] == 0)
        if not frozen:
            raise AssertionError(f"ensemble {name}: the frozen member moved")
        if not (fs.step[1:] == 10).all():
            raise AssertionError(f"ensemble {name}: steps {fs.step}")
        out[name] = (s, carry, px.cpu(), pk.cpu(), ts,
                     {key: after[key] - before[key] for key in after})
    (sg, cg, pxg, pkg, tsg, lg), (sc, cc, pxc, pkc, tsc, lc) = (out["cuda"],
                                                              out["cpu"])
    if sg.march != sc.march or (sg.march is not None) != march:
        raise AssertionError("ensemble: march specs differ between card and "
                             "CPU, or the march is (not) engaged")
    torch.testing.assert_close(pxg, pxc, rtol=0, atol=1e-9)
    torch.testing.assert_close(pkg, pkc, rtol=0, atol=1e-9)
    if not torch.equal(tsg, tsc):
        raise AssertionError("ensemble: times differ between card and CPU")
    qg_, qc_ = cg.flow_state.qk.cpu(), cc.flow_state.qk
    rel = float((qg_ - qc_).abs().max() / qc_.abs().max())
    if not rel <= 1e-9:
        raise AssertionError(f"ensemble: qk differs by {rel:.3e} (relative)")
    if not float((pxc[1:, -1] - pxc[1:, 0]).abs().max()) > 0:
        raise AssertionError("ensemble: packets did not move")
    expected = dict.fromkeys(WRAPPERS, 0)
    if march:
        expected["march_batched"] = 10
        window = ("build_windows_batched" if sg.march.fused_build
                  else "transpose_batched")
        expected[window] = 11
    if lg != expected:
        raise AssertionError(f"ensemble: card launches {lg}, expected "
                             f"{expected}")
    result = dict(members=3, nx=base.nx, n_packets=base.n_packets,
                  flow_steps=10, frozen_member_bit_for_bit=True,
                  launches_on_the_card=lg,
                  max_abs_dx=float((pxg - pxc).abs().max()),
                  max_abs_dk=float((pkg - pkc).abs().max()),
                  max_rel_dqk=rel)
    if not march:
        return result
    ov_g, ov_c = cg.overflow.cpu().tolist(), cc.overflow.tolist()
    if ov_g != ov_c or max(ov_g) != 0:
        raise AssertionError(f"ensemble overflow card {ov_g}, CPU {ov_c}")
    return dict(result, overflow=ov_g, margin=sg.march.margin)


def phase_path_vs_cpu(dev):
    small = dict(nx=64, n_packets=4096, window_min_np=1, T_Fr_days=20.0,
                 packet_delay_days=0.05, packet_steps_per_save=5)
    two = coupled_card_vs_cpu(dev, Coupled2Config(**small), setup_coupled2,
                              run_coupled2_chunk)
    before = mw.build_windows_cuda.launches
    one = coupled_card_vs_cpu(
        dev, CoupledConfig(march_fused_build=True, **small), setup_coupled,
        run_coupled_chunk)
    if mw.build_windows_cuda.launches != before + 11:
        raise AssertionError("the one-layer path did not build its windows "
                             "with the build kernel")
    # the per-stage path (no march): stencil below window_min_np, and from
    # prebuilt windows with the march off and the threshold lowered; it
    # launches no kernel of the port
    per_stage = {}
    for branch, kw in (("stencil", dict(small, window_min_np=65536)),
                       ("windowed", dict(small, fused_march=False))):
        before = read_launches()
        per_stage[branch] = coupled_card_vs_cpu(
            dev, Coupled2Config(**kw), setup_coupled2, run_coupled2_chunk,
            march=False)
        if per_stage[branch]["windowed"] != (branch == "windowed"):
            raise AssertionError(f"per-stage {branch}: wrong branch taken")
        if read_launches() != before:
            raise AssertionError(f"per-stage {branch} launched a kernel")
    ensemble = {
        "march": ensemble_card_vs_cpu(dev, CoupledConfig(**small), True),
        "stencil": ensemble_card_vs_cpu(
            dev, CoupledConfig(**dict(small, window_min_np=65536)), False)}
    emit("path_vs_cpu", **two, one_layer=one, march_rays=rays_card_vs_cpu(dev),
         per_stage=per_stage, ensemble=ensemble)


# ---------------------------------------------------------------------------
# the main paths at full width
# ---------------------------------------------------------------------------

FULL = dict(nx=512, n_packets=1_048_576, T_Fr_days=6000.0,
            packet_delay_days=0.01, U_g=0.4, f=3.0, Cg=1.0, stepper="rk23",
            n_substeps=2, packet_steps_per_save=20)


def omega_over_f(pk, cfg):
    return torch.sqrt(cfg.f ** 2 + cfg.Cg ** 2 * (pk * pk).sum(0)) / cfg.f


def drive_coupled(phase, cfg, setup, run_chunk, max_speed, per_step, n_chunks):
    """Drive one coupled model at full width: set the launch counts to 0,
    set up on the card, two warm-up chunks, n_chunks timed chunks, read
    the counts, check the state. `per_step` names the kernels the path
    launches once per flow step and, of those, the one that also prepares
    the first carry's windows: (march, window kernel)."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    s, carry = setup(cfg, dtype=torch.float32)  # device=None: CUDA
    if carry.packet_x.device.type != "cuda" or s.march is None:
        raise AssertionError("the main path is not on the card / the march "
                             "is not engaged")
    x_start = carry.packet_x.clone()
    om0 = omega_over_f(carry.packet_k, cfg)
    om0_mean, om0_std = float(om0.mean()), float(om0.std())
    for _ in range(2):  # warm-up: builds the kernels' first launches, cuFFT
        carry, _ = run_chunk(carry, s, cfg, 1)
    torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_chunks):
        carry, (px, pk, ts) = run_chunk(carry, s, cfg, 1)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seconds = start.elapsed_time(end) / 1e3
    launches = read_launches()

    steps = n_chunks * cfg.packet_steps_per_save
    # counted since just before setup: the march and the window kernel once
    # per flow step, warm-up included, plus the one window launch that
    # prepares the first carry's windows; no other kernel at all
    all_steps = (2 + n_chunks) * cfg.packet_steps_per_save
    march, window = per_step
    expected = dict.fromkeys(WRAPPERS, 0)
    expected[march] = all_steps
    expected[window] = all_steps + 1
    if launches != expected:
        raise AssertionError(f"{phase}: launch counts {launches}, expected "
                             f"{expected}")
    # the march reads its rows by cell: nothing gathers them beforehand
    gathers = mw.gather_packet_windows.calls
    if gathers != 0:
        raise AssertionError(f"{phase}: gather_packet_windows was called "
                             f"{gathers} times")
    # by the counts the launches themselves left: every one on the route
    # the rule gives
    rule = mw.march_route(s.march, carry.packet_x.dtype)
    routes = dict(WRAPPERS[march].launches_by_route)
    if routes != {**dict.fromkeys(routes, 0), rule: all_steps}:
        raise AssertionError(f"{phase}: the march launches took the routes "
                             f"{routes}, expected {all_steps} {rule}")
    if any(mw.march_cuda.launches_by_route.values()):
        raise AssertionError(f"{phase}: the pre-gathered march was launched")
    for name, t in (("packet_x", carry.packet_x), ("packet_k", carry.packet_k),
                    ("prev_fields", carry.prev_fields),
                    ("qk", torch.view_as_real(carry.flow_state.qk))):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{phase}: {name} is not finite")
    if px.shape != (1, 2, cfg.n_packets) or pk.shape != px.shape:
        raise AssertionError(f"unexpected save shapes {px.shape} {pk.shape}")
    overflow = int(carry.overflow)
    if overflow != 0:
        raise AssertionError(f"{phase}: march overflow {overflow}")
    moved = float((carry.packet_x - x_start).abs().max())
    if not moved > 1e-3:
        raise AssertionError(f"{phase}: packets did not move ({moved})")
    om1 = omega_over_f(carry.packet_k, cfg)
    if abs(om0_mean - 2.0) > 1e-5 or om0_std > 1e-5:
        raise AssertionError(f"omega/f starts at {om0_mean} +- {om0_std}")
    if not float(om1.std()) > 10 * max(om0_std, 1e-7):
        raise AssertionError(f"{phase}: omega/f did not spread")
    speed = float(max_speed(carry.flow_state.qk, s))
    if not 0.05 < speed < 10.0:
        raise AssertionError(f"{phase}: max speed {speed} is not O(1)")
    emit(phase, nx=cfg.nx, n_packets=cfg.n_packets, dtype="float32",
         stepper=cfg.stepper, n_substeps=cfg.n_substeps,
         margin=s.march.margin, K=s.march.K,
         fused_build=s.march.fused_build, dt=s.dt, U0=s.U0,
         timed_chunks=n_chunks, flow_steps=steps,
         flow_steps_with_warm_up=all_steps, seconds=seconds,
         host_seconds=wall, flow_steps_per_s=steps / seconds,
         packet_steps_per_s=steps * cfg.n_packets / seconds,
         ms_per_flow_step=1e3 * seconds / steps, launches=launches,
         march_launches_by_route=routes, march_block=s.march.block,
         gather_packet_windows_calls=gathers, overflow=overflow,
         max_packet_displacement=moved,
         omega_over_f_start=[om0_mean, om0_std],
         omega_over_f_end=[float(om1.mean()), float(om1.std())],
         max_speed=speed, t_end=carry.flow_state.t,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    summary = dict(packet_steps_per_s=steps * cfg.n_packets / seconds,
                   ms_per_flow_step=1e3 * seconds / steps,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   march_route=rule)
    return (cfg, s, carry), launches, routes, all_steps, summary


def phase_main_path(n_chunks):
    return drive_coupled(
        "main_path", Coupled2Config(**FULL), setup_coupled2,
        run_coupled2_chunk,
        lambda qk, s: qg2.max_speed2(qk, s.grid, s.ops, s.params),
        ("march", "transpose"), n_chunks)


def phase_main_path_qg1(n_chunks):
    return drive_coupled(
        "main_path_qg1", CoupledConfig(march_fused_build=True, **FULL),
        setup_coupled, run_coupled_chunk,
        lambda qk, s: qg.max_speed(qk, s.grid, s.qg_params.Kd2),
        ("march", "build_windows"), n_chunks)


# ---------------------------------------------------------------------------
# the kernels at the main paths' shapes
# ---------------------------------------------------------------------------

def march_flops_per_packet(spec):
    """Floating-point adds and multiplies of the plain algorithm for one
    packet over one flow step (what march_reference does on the live 6x6
    stencil; bookkeeping on integers is not counted)."""
    grad = spec.grad_from_interp
    weights = 2 * (6 + 6 * 5)                      # a = fr - o; 6 products
    if grad:
        weights += 2 * 6 * (5 * 3 + 4 + 1)         # derivative weights
    stencil = spec.nf * 36
    contraction = stencil * 3 + stencil * 2        # blend; y contraction
    contraction += spec.nf * 6 * 2                 # x contraction
    if grad:
        contraction += stencil * 2 + spec.nf * 6 * 4 + 4
    cell = 8                                       # scale, mod, floor, frac
    one_eval = weights + contraction + cell
    rhs = one_eval + 20
    per_substep = {"rk23": 3 * rhs + 4 * 2 * 3 + 4 * 7,
                   "rk4": 4 * rhs + 4 * 2 * 3 + 4 * 7,
                   "symplectic": one_eval + 40}[spec.stepper]
    return spec.n_substeps * per_substep


def march_rays_flops_per_packet_step(order):
    """Floating-point operations of the plain algorithm for one packet over
    one Strang step of march_rays_reference (integer index work is not
    counted)."""
    S = 2 * order + 2
    drift = 5 + 1 + 2 * 4          # f2 + gH (k.k); sqrt; gH k / om * hdt + x
    cell = 2 * 4                   # divide, mod, floor, fraction
    weights = 2 * (S + S * (S - 2) + S)   # a = fr - o; products; / denom
    stencil = S * S + 6 * S * S * 2       # wx wy; multiply-add per field
    kick = 6 + 4 * 2               # refraction; x += dt u, k -= dt r
    return 2 * drift + cell + weights + stencil + kick


def ms_by_route(launch, spec, dtype):
    """ms per call inside a run of calls (cuda_ms_run) of launch(route,
    consumers) by every route these rows take, all in this run and in
    turns: staged, the ring at each consumer count of the sweep, direct,
    and staged again (the spread of one route within the run)."""
    runs = []
    if fits_staged(spec, dtype):
        runs.append(("staged", "staged", None))
    if fits_ring(spec, dtype):
        runs += [(f"ring consumers={c}", "ring", c)
                 for c in ring_sweep(spec, dtype)]
    runs.append(("direct", "direct", None))
    if fits_staged(spec, dtype):
        runs.append(("staged_again", "staged", None))
    return {key: cuda_ms_run(lambda: launch(route, c))
            for key, route, c in runs}


def stepper_split(launch, spec, dtype):
    """The batched march by route at 2, 6 and 8 stage evaluations a flow
    step on the same rows (symplectic, rk23 and rk4 at two substeps), and
    the least-squares line through the three times: its intercept the
    cost of what does not grow with the evaluations (the rows' copy and
    the packets' loads and stores), its slope an evaluation's cost."""
    evals = {"symplectic": 1, "rk23": 3, "rk4": 4}
    routes = [("staged", None)] if fits_staged(spec, dtype) else []
    if fits_ring(spec, dtype):
        routes += [("ring", c) for c in ring_sweep(spec, dtype)]
    out = {}
    for route, c in routes:
        key = route if c is None else f"ring consumers={c}"
        n = [evals[st] * spec.n_substeps for st in evals]
        t = [cuda_ms_run(lambda: launch(route, c, spec._replace(stepper=st)))
             for st in evals]
        slope, intercept = np.polyfit(n, t, 1)
        out[key] = {**{f"{st} ({k} evaluations)": v
                       for st, k, v in zip(evals, n, t)},
                    "ms_not_growing_with_evaluations": float(intercept),
                    "ms_per_evaluation": float(slope)}
    return out


def time_parts(parts, reps=15):
    return {name: cuda_ms(fn, reps) for name, fn in parts.items()}


def march_at_main_shapes(spec, win1, win2, x, k, sub_dt):
    """K1 as the coupled paths launch it (rows read by cell from the two
    window arrays) on a main path's tensors: held against its plain
    version, timed, and beside it what it took the place of in a flow
    step: the stacked copy of the two window arrays, the row gather, and
    the pre-gathered march on the gathered rows (same bits). Returns
    (args, (ms per launch in a run, ms of a single launch), max abs err,
    replaced, the route the timed launches took)."""
    n_p = x.shape[1]
    oi, oj = mw.packet_cells(x[0], x[1], spec)
    args = (win1, win2, torch.cat([x, k], dim=0), oi, oj, sub_dt, spec)
    if (tuple(win1.shape) != (spec.nx * spec.ny, spec.K)
            or win2.shape != win1.shape):
        raise AssertionError(f"unexpected window arrays {tuple(win1.shape)} "
                             f"{tuple(win2.shape)}")
    err, _, ovmax, got, _ = compare_march(
        args[:5], sub_dt, spec, F32_RTOL, F32_ATOL,
        "march at the main shapes", kernel=mw.march_gathered_cuda,
        plain=mw.march_gathered_reference)
    if ovmax != 0:
        raise AssertionError(f"march overflow {ovmax} at the main shapes")

    combined = spec._replace(combined_gather=True)
    winc = torch.cat([win1, win2], dim=-1)
    pwc = mw.gather_packet_windows(winc, oi, oj, combined)
    if tuple(pwc.shape) != (n_p, 2 * spec.K):
        raise AssertionError(f"unexpected window rows {tuple(pwc.shape)}")
    dummy = pwc.new_zeros((1, 1))
    old, _ = mw.march_cuda(pwc, dummy, *args[2:5], sub_dt, combined)
    if not torch.equal(old, got):
        raise AssertionError("the gathered march differs from the "
                             "pre-gathered march at the main shapes")
    del old, got
    replaced = time_parts({
        "cat_windows": lambda: torch.cat([win1, win2], dim=-1),
        "gather_packet_windows": lambda: mw.gather_packet_windows(
            winc, oi, oj, combined),
        "march_cuda": lambda: mw.march_cuda(pwc, dummy, *args[2:5], sub_dt,
                                            combined),
    })
    replaced["replaced_ms"] = sum(replaced.values())
    del winc, pwc
    (ms, single_ms), route = route_taken(
        lambda: (cuda_ms_run(lambda: mw.march_gathered_cuda(*args)),
                 cuda_ms(lambda: mw.march_gathered_cuda(*args), 25)))
    return args, (ms, single_ms), err, replaced, route


def phase_march_routes(args):
    """The three routes of the march kernel at the main shape, the staged
    and direct ones over block sizes and the ring over its consumer warps
    (and the three steppers by the route the rule gives), and at the other
    window sizes and types on random fields of the main grid: what
    march_route's rule and MarchSpec.block's default rest on. Same bits by
    every route."""
    win1, win2, xk, oi, oj, sub_dt, spec = args
    dev, n_p = xk.device, xk.shape[1]
    main = {}
    for route in ("staged", "direct"):
        for block in (32, 64, 96, 128, 192):
            sp = spec._replace(block=block)
            if route == "staged" and not fits_staged(sp, xk.dtype):
                continue
            main[f"{route} block={block}"] = cuda_ms(
                lambda: march_by_route(win1, win2, xk, oi, oj, sub_dt, sp,
                                       route), 15)
    for c in ring_sweep(spec, xk.dtype):
        main[f"ring consumers={c}"] = cuda_ms(
            lambda: march_by_route(win1, win2, xk, oi, oj, sub_dt, spec,
                                   "ring", c), 15)
    # 2, 6 and 8 stage evaluations a flow step on the same rows: what the
    # copy of the rows costs and what an evaluation costs
    steppers = {
        f"{stepper} x{spec.n_substeps}": cuda_ms(
            lambda: mw.march_gathered_cuda(
                win1, win2, xk, oi, oj, sub_dt,
                spec._replace(stepper=stepper)), 15)
        for stepper in ("symplectic", "rk23", "rk4")}
    emit("march_routes_main_shape", unit="ms, median of 15", K=spec.K,
         dtype=str(xk.dtype), rule=mw.march_route(spec, xk.dtype),
         default_block=mw.MarchSpec._field_defaults["block"],
         ring_slots=mw.ring_slots(spec, xk.dtype),
         ring_producers=mw.RING_PRODUCERS,
         ring_default_consumers=mw.ring_consumers(spec, xk.dtype), **main,
         steppers_by_the_rule=steppers)

    g = torch.Generator(device=dev).manual_seed(3)
    other = {}
    for dtype, nf, margin in ((torch.float32, 2, 2), (torch.float32, 6, 1),
                              (torch.float32, 6, 2), (torch.float64, 2, 1),
                              (torch.float64, 2, 2), (torch.float64, 6, 1)):
        sp = spec._replace(nf=nf, grad_from_interp=nf == 2, margin=margin)
        F = 0.1 * torch.randn((2, nf, spec.nx, spec.ny), dtype=dtype,
                              device=dev, generator=g)
        w1 = mw.build_gather_windows(F[0], sp)
        w2 = mw.build_gather_windows(F[1], sp)
        xk_ = xk.to(dtype)
        coi, coj = mw.packet_cells(xk_[0], xk_[1], sp)
        case, outs = {}, []
        for route in ("staged", "direct"):
            for block in (32, 64, 128):
                spb = sp._replace(block=block)
                if route == "staged" and not fits_staged(spb, dtype):
                    continue
                run = lambda: march_by_route(w1, w2, xk_, coi, coj, sub_dt,
                                             spb, route)
                outs.append(run()[0])
                case[f"{route} block={block}"] = cuda_ms(run, 7)
        if fits_ring(sp, dtype):
            run = lambda: march_by_route(w1, w2, xk_, coi, coj, sub_dt, sp,
                                         "ring")
            outs.append(run()[0])
            case[f"ring consumers={mw.ring_consumers(sp, dtype)}"] = \
                cuda_ms(run, 7)
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"routes differ at nf={nf} m={margin} "
                                 f"{dtype}")
        other[f"{dtype} nf={nf} m={margin} K={sp.K}"] = {
            "rule": mw.march_route(sp, dtype),
            "staged_warp_bytes": mw.staged_warp_bytes(sp, dtype),
            "ring_slots": mw.ring_slots(sp, dtype), **case}
        del F, w1, w2, outs
    emit("march_routes_other_shapes", unit="ms, median of 7",
         n_packets=n_p, nx=spec.nx, **other)


def phase_kernels(cfg, s, carry, steps):
    """K1 march and K2 transpose at the two-layer main path's shapes, and
    the parts of one two-layer flow step."""
    spec = s.march
    dtype = carry.packet_x.dtype
    item = carry.packet_x.element_size()
    n_p = cfg.n_packets

    # K1 inputs exactly as lockstep_step forms them, from the final carry:
    # the previous snapshot's window array and the new one's
    state2 = qg2.qg2_step(carry.flow_state, s.grid, s.ops, s.params)
    fields2 = qg2.top_layer_flow(state2.qk, s.grid, s.ops, s.params,
                                 cfg.one_layer_quirk, n_fields=spec.nf).fields
    W = mw.build_margin_windows(fields2, spec)           # (K, ncells)
    win2 = mw.transpose_cuda(W)
    x, k = carry.packet_x, carry.packet_k
    sub_dt = s.dt / cfg.n_substeps
    (args, (march_ms, march_single_ms), march_err, replaced,
     march_route) = march_at_main_shapes(spec, carry.prev_win, win2, x, k,
                                         sub_dt)

    # the parts of one flow step, each timed alone on these inputs
    breakdown = time_parts({
        "qg2_step": lambda: qg2.qg2_step(carry.flow_state, s.grid, s.ops,
                                         s.params),
        "top_layer_flow": lambda: qg2.top_layer_flow(
            state2.qk, s.grid, s.ops, s.params, cfg.one_layer_quirk,
            n_fields=spec.nf),
        "build_margin_windows": lambda: mw.build_margin_windows(fields2,
                                                                spec),
        "transpose_cuda": lambda: mw.transpose_cuda(W),
        "packet_cells": lambda: mw.packet_cells(x[0], x[1], spec),
    })
    breakdown["march_gathered_cuda"] = march_single_ms
    emit("step_breakdown", unit="ms, median, each part alone, one call "
                                "between two events",
         sum_of_parts=sum(breakdown.values()), **breakdown,
         march_route=march_route, replaced_by_march_gathered_cuda=replaced)
    phase_march_routes(args)
    march_ms_by_route = ms_by_route(
        lambda route, c: mw.march_gathered_cuda(*args, route=route,
                                                consumers=c), spec, dtype)
    march_plain_ms = cuda_ms(lambda: mw.march_gathered_reference(*args), 3)
    # Bytes the function must move: every window row that some packet
    # reads, once (packets of one cell share their row: this run's count of
    # occupied cells, not the packet count), and per packet xk, oi, oj in
    # and xk, overflow out.
    oi, oj = args[3], args[4]
    occupied = int(torch.unique(oi.long() * spec.ny + oj).numel())
    march_bytes = (occupied * 2 * spec.K * item
                   + n_p * (4 * item + 8 + 4 * item + 4))
    march_flops = n_p * march_flops_per_packet(spec)
    by_bytes = march_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = march_flops / FLOPS_PER_S[dtype] * 1e3

    # K2 at the main path's shape: (K, ncells) -> (ncells, K)
    t_got = mw.transpose_cuda(W)
    torch.cuda.synchronize()
    tr_err = float((t_got - mw.transpose_reference(W)).abs().max())
    if tr_err != 0.0:
        raise AssertionError(f"transpose differs at the main shape by "
                             f"{tr_err:.3e}")
    del t_got
    tr_ms = cuda_ms_run(lambda: mw.transpose_cuda(W))
    tr_single_ms = cuda_ms(lambda: mw.transpose_cuda(W), 25)
    tr_plain_ms = cuda_ms_run(lambda: mw.transpose_reference(W))
    tr_lib_ms = cuda_ms_run(lambda: W.t().contiguous())
    tr_bytes = 2 * W.numel() * item
    tr_by_bytes = tr_bytes / HBM_BYTES_PER_S * 1e3

    # What the bounds were computed from, and what the errors were held to.
    bounds = {
        "flow_steps": steps,
        "march": {"shape": f"win1, win2 {tuple(win2.shape)} {dtype} read by "
                           f"cell, one row of 2K = {2 * spec.K} values an "
                           f"occupied cell, xk (4, {n_p})",
                  "occupied_cells": occupied,
                  "cells": spec.nx * spec.ny,
                  "bytes": march_bytes, "flops": march_flops,
                  "ms_by_bytes": by_bytes, "ms_by_operations": by_ops,
                  "tolerance": {"rtol": F32_RTOL, "atol": F32_ATOL}},
        "transpose": {"shape": f"{tuple(W.shape)} {dtype}", "bytes": tr_bytes,
                      "flops": 0, "ms_by_bytes": tr_by_bytes,
                      "ms_by_operations": 0.0, "tolerance": "exact"}}
    # Per kernel: bound_ms from this run's inputs, every other number
    # measured in this run; main() adds the launches. `ms` (and plain_ms,
    # library_ms of the short kernels) is per call inside a run of calls
    # queued back to back (cuda_ms_run); `single_launch_ms` is one call
    # between two events, host included.
    rows = [
        {"name": "march", "route": "cuda",
         "source": MARCH_SOURCES[march_route],
         "sources": sorted(set(MARCH_SOURCES.values())),
         "replaces": REPLACES["march"], "max_abs_err": march_err, "ms": march_ms,
         "plain_ms": march_plain_ms, "bound_ms": max(by_bytes, by_ops),
         "bound_by": "bytes" if by_bytes >= by_ops else "operations",
         "library_ms": None, "single_launch_ms": march_single_ms,
         "march_route": march_route, "ms_by_route": march_ms_by_route,
         "replaced_ms": replaced["replaced_ms"], "replaced": replaced},
        {"name": "transpose", "route": "cuda", "source": SOURCES["transpose"],
         "replaces": REPLACES["transpose"], "max_abs_err": tr_err,
         "ms": tr_ms, "plain_ms": tr_plain_ms, "bound_ms": tr_by_bytes,
         "bound_by": "bytes", "library_ms": tr_lib_ms,
         "single_launch_ms": tr_single_ms},
    ]
    return rows, bounds


def build_windows_other_shapes(nx, dev):
    """K3 alone at the other window sizes and in float64 on random fields of
    the main grid, beside its bytes bound and a memset of the same output:
    whether the kernel keeps its rate per byte written whatever K is."""
    lib, stream = kernels.load(), torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(5)
    report = {}
    for dtype, nf, margin in ((torch.float32, 2, 2), (torch.float32, 2, 3),
                              (torch.float32, 6, 1), (torch.float64, 2, 1),
                              (torch.float64, 6, 1)):
        spec = mw.MarchSpec(nx=nx, ny=nx, dx=1.0, dy=1.0, f=3.0, Cg=1.0,
                            nf=nf, grad_from_interp=nf == 2, margin=margin,
                            tiles_transposed=True, fused_build=True)
        F = torch.randn((nf, nx, nx), dtype=dtype, device=dev, generator=g)
        out = mw.build_windows_cuda(F, spec)
        if not torch.equal(out, mw.build_windows_reference(F, spec)):
            raise AssertionError(f"build_windows differs at K={spec.K} {dtype}")
        launch = lambda: lib.swr_build_windows(
            mw._DTYPE_CODE[dtype], F.data_ptr(), out.data_ptr(), nf, nx, nx,
            spec.SW, spec.order + margin, stream)
        nbytes = (out.numel() + F.numel()) * out.element_size()
        report[f"{dtype} nf={nf} m={margin} K={spec.K}"] = {
            "kernel_ms": cuda_ms_run(launch, 50),
            "memset_ms": cuda_ms_run(out.zero_),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
        del out, F
    return report


def phase_kernels_qg1(cfg, s, carry):
    """K3 build_windows at the one-layer main path's shape, beside the
    two-pass route on the same fields, and the parts of one one-layer flow
    step."""
    spec = s.march
    dtype = carry.packet_x.dtype
    item = carry.packet_x.element_size()
    qp = s.qg_params

    state2 = qg.qg_step(carry.flow_state, s.grid, qp)
    fields2 = flow_from_qk(state2.qk, s.grid, qp.Kd2, n_fields=spec.nf).fields
    got = mw.build_windows_cuda(fields2, spec)
    torch.cuda.synchronize()
    want = mw.build_windows_reference(fields2, spec)
    if tuple(got.shape) != (cfg.nx * cfg.nx, spec.K):
        raise AssertionError(f"unexpected window array {tuple(got.shape)}")
    bw_err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("build_windows differs from its plain version "
                             f"at the main shape by {bw_err:.3e}")
    del want
    W = mw.build_margin_windows(fields2, spec)
    if not torch.equal(got, mw.transpose_cuda(W)):
        raise AssertionError("build_windows differs from the two-pass route "
                             "at the main shape")
    x, k = carry.packet_x, carry.packet_k
    _, (_, march_ms), _, replaced, march_route = march_at_main_shapes(
        spec, carry.prev_win, got, x, k, s.dt / cfg.n_substeps)
    breakdown = time_parts({
        "qg_step": lambda: qg.qg_step(carry.flow_state, s.grid, qp),
        "flow_from_qk": lambda: flow_from_qk(state2.qk, s.grid, qp.Kd2,
                                             n_fields=spec.nf),
        "build_windows_fused": lambda: mw.build_windows_fused(fields2, spec),
        "packet_cells": lambda: mw.packet_cells(x[0], x[1], spec),
    })
    breakdown["march_gathered_cuda"] = march_ms
    two_pass = time_parts({
        "build_margin_windows": lambda: mw.build_margin_windows(fields2,
                                                                spec),
        "transpose_cuda": lambda: mw.transpose_cuda(W),
    })
    emit("step_breakdown_qg1", unit="ms, median, each part alone, one call "
                                    "between two events",
         sum_of_parts=sum(breakdown.values()), **breakdown,
         march_route=march_route, replaced_by_march_gathered_cuda=replaced,
         two_pass_route_on_the_same_fields=two_pass)
    del W

    bw_ms = cuda_ms_run(lambda: mw.build_windows_cuda(fields2, spec))
    bw_single_ms = cuda_ms(lambda: mw.build_windows_cuda(fields2, spec), 25)
    # the kernel alone: the C entry the wrapper calls, into one output
    lib, stream = kernels.load(), torch.cuda.current_stream().cuda_stream
    lo = spec.order + spec.margin
    launch = lambda: lib.swr_build_windows(
        mw._DTYPE_CODE[dtype], fields2.data_ptr(), got.data_ptr(), spec.nf,
        cfg.nx, cfg.nx,
        spec.SW, lo, stream)
    got.zero_()
    kernels.check(launch(), "swr_build_windows")
    if not torch.equal(got, mw.build_windows_cuda(fields2, spec)):
        raise AssertionError("the C entry's output differs from the wrapper's")
    bw_kernel_ms = cuda_ms_run(launch, 50)
    # the same wrapper on an 8 x 12 grid, one call between two events: how
    # much of a single-launch time is the host's
    tiny = spec._replace(nx=8, ny=12)
    tiny_F = fields2[:, :8, :12].contiguous()
    bw_floor_ms = cuda_ms(lambda: mw.build_windows_cuda(tiny_F, tiny), 25)
    # writing the same bytes with nothing to read
    bw_memset_ms = cuda_ms_run(got.zero_)
    bw_plain_ms = cuda_ms_run(
        lambda: mw.build_windows_reference(fields2, spec), 10)
    # the one library copy that does the same: the padded fields' shifted
    # views, permuted to rows, made contiguous
    shifted = mw._shifted_views(fields2, spec)
    bw_lib_ms = cuda_ms_run(
        lambda: shifted.permute(3, 4, 0, 1, 2).contiguous(), 10)
    out_shape = tuple(got.shape)
    bw_bytes = (got.numel() + spec.nf * cfg.nx * cfg.nx) * item
    by_bytes = bw_bytes / HBM_BYTES_PER_S * 1e3
    del shifted, got
    emit("build_windows_shapes", unit="ms per launch of the C entry in a run "
                                      "of 50, and a memset of its output",
         nx=cfg.nx, **build_windows_other_shapes(cfg.nx, fields2.device))
    bounds = {"build_windows": {
        "shape": f"F {tuple(fields2.shape)} -> {out_shape} {dtype}",
        "bytes": bw_bytes, "flops": 0, "ms_by_bytes": by_bytes,
        "ms_by_operations": 0.0, "tolerance": "exact"}}
    row = {"name": "build_windows", "route": "cuda",
           "source": SOURCES["build_windows"],
           "replaces": REPLACES["build_windows"], "max_abs_err": bw_err,
           "ms": bw_ms, "plain_ms": bw_plain_ms, "bound_ms": by_bytes,
           "bound_by": "bytes", "library_ms": bw_lib_ms,
           "kernel_ms": bw_kernel_ms, "memset_ms": bw_memset_ms,
           "single_launch_ms": bw_single_ms,
           "single_launch_ms_on_an_8x12_grid": bw_floor_ms}
    return [row], bounds


# ---------------------------------------------------------------------------
# the frozen-flow ray march at full width
# ---------------------------------------------------------------------------

# The frozen path at full width: the grid and packet count of the coupled
# runs, the step of the JAX package's own timing of its ray-march kernel.
FROZEN = dict(nx=512, n_packets=1_048_576, dt=1e-3, Kd2=3.0,
              drift_packets=2 ** 16, drift_steps=500)


def sm_count_and_clock():
    """The card's SM count and its highest SM clock in Hz, as the device
    reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    mhz = float(out.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count, mhz * 1e6


# Segment lengths of the sweep in steps (RAYS_STEPS: one segment, the
# packets ordered once).
SEGMENT_SWEEP = (RAYS_STEPS, 25, 13, 10, 7, 5, 3)


def phase_march_rays_segments(args, grid, disp, dt):
    """K4 at the main shape over segment lengths, ordered, beside the
    unordered march (one launch, and the same launches without ordering):
    what SEGMENT_CELLS in ops/march_rays.py is read from. Every variant
    gives the same bits. Then one ordering alone, the node-major copy
    alone, torch.sort on the same keys, and float64 at full width."""
    fields, x0, k0 = args[:3]
    single = unordered_march(*args)
    cells_per_step = disp.Cg * dt / min(grid.dx, grid.dy)
    rule = mr.segment_steps(dt, grid, disp)
    sweep = {}
    for segment in sorted({*SEGMENT_SWEEP, rule}, reverse=True):
        run = lambda: mr.march_rays_cuda_by(*args, segment=segment)
        require_same_bits(run(), single, f"segment={segment}")
        sweep[str(segment)] = {
            "launches": len(mr.march_rays_cuda.last_segments),
            "cells_at_group_speed_bound": segment * cells_per_step,
            "ms": cuda_ms_run(run, 3)}
    unordered = {
        "one launch": cuda_ms_run(lambda: unordered_march(*args), 2, 3),
        f"segments of {rule}": cuda_ms_run(
            lambda: mr.march_rays_cuda_by(*args, segment=rule,
                                          ordered=False), 2, 3)}
    best = min(sweep, key=lambda key: sweep[key]["ms"])
    keys = mr.packet_cell_keys(x0, grid)
    parts = {name: cuda_ms_run(fn) for name, fn in {
        "cell_order_cuda": lambda: mr.cell_order_cuda(x0, grid),
        "cell_order_reference (remainder, floor, argsort)":
            lambda: mr.cell_order_reference(x0, grid),
        "torch.sort of the keys alone": lambda: torch.sort(keys),
        "node_major_copy": lambda: mr.node_major_fields(fields),
    }.items()}
    del keys

    f64 = torch.float64
    args64 = (fields.to(f64), x0.to(f64), k0.to(f64), *args[3:])
    got64 = mr.march_rays_cuda(*args64)
    segments64 = list(mr.march_rays_cuda.last_segments)
    single64 = unordered_march(*args64)
    require_same_bits(got64, single64, "float64 at full width")
    # the float32 march against the float64 one: what float32 costs
    err32 = max(float((a.to(f64) - b).abs().max())
                for a, b in zip(single, got64))
    del got64, single64, single
    float64 = {
        "ms": cuda_ms_run(lambda: mr.march_rays_cuda(*args64), 3),
        "unordered_one_launch_ms": cuda_ms_run(
            lambda: unordered_march(*args64), 2, 3),
        "segments": segments64, "equals_unordered_bit_for_bit": True,
        "max_abs_diff_of_float32_march": err32}
    emit("march_rays_segments",
         unit="ms per call in a run of calls queued back to back",
         n_packets=x0.shape[1], nx=grid.nx, steps=RAYS_STEPS, dt=dt,
         cells_per_step_at_group_speed_bound=cells_per_step,
         SEGMENT_CELLS=mr.SEGMENT_CELLS, segment_by_the_rule=rule,
         ordered_by_segment_length=sweep, fastest_segment=int(best),
         unordered=unordered, all_equal_bit_for_bit=True,
         parts_alone_ms=parts, float64_full_width=float64)
    return sweep, parts


def phase_frozen_path(dev):
    """2^20 packets, 50 symplectic steps through a frozen 512^2 one-layer
    snapshot: march_rays (K4, ordered by cell, one launch a segment)
    against its plain version, the unordered single launch and
    raytrace_frozen on the card, then the frequency drift in float64."""
    nx, n_p, dt, Kd2 = (FROZEN[key] for key in ("nx", "n_packets", "dt",
                                                "Kd2"))
    grid = SpectralGrid.square(nx)
    disp = Dispersion(f=3.0, Cg=1.0)
    dtype = torch.float32
    qk = qg.initial_q_ring(146, grid, 0.4, Kd2, dtype=dtype)  # on the card
    flow = flow_from_qk(qk, grid, Kd2, n_fields=6)
    fields = flow.fields.contiguous()
    x0, k0 = ring_ics(n_p, 2.0, disp, dtype=dtype)
    args = (fields, x0, k0, grid, disp, dt, RAYS_STEPS)
    segments = mr.split_steps(RAYS_STEPS, mr.segment_steps(dt, grid, disp))
    # the ordering's kernels at the shape the path gives them (262144 cells,
    # 2^20 packets): the keys in order, every packet once
    check_cell_order(x0, grid, "frozen_path cell_order at the start")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    xN, kN = mr.march_rays(*args)
    end.record()
    torch.cuda.synchronize()
    first_ms = start.elapsed_time(end)
    launches = read_launches()
    # one launch of the march and one ordering per segment, nothing else
    expected = dict.fromkeys(WRAPPERS, 0)
    expected["march_rays"] = expected["cell_order"] = len(segments)
    if launches != expected or mr.march_rays_cuda.last_segments != segments:
        raise AssertionError(f"frozen_path: launch counts {launches}, "
                             f"expected {expected}; segments "
                             f"{mr.march_rays_cuda.last_segments}, expected "
                             f"{segments}")
    if xN.shape != (2, n_p) or kN.shape != (2, n_p) or not xN.is_cuda:
        raise AssertionError("frozen_path: unexpected result")

    want = mr.march_rays_reference(*args)
    err = compare_rays((xN, kN), want, RAYS_F32_ATOL, "frozen_path")
    require_same_bits((xN, kN), unordered_march(*args),
                      "frozen_path ordered vs unordered")
    res = raytrace_frozen(flow, x0, k0, disp, dt, RAYS_STEPS,
                          save_every=RAYS_STEPS, stepper="symplectic")
    err_frozen = compare_rays((xN, kN), (res.x[-1], res.k[-1]),
                              RAYS_F32_ATOL, "frozen_path vs raytrace_frozen")
    moved = float((xN - x0).abs().max())
    if not moved > 1e-2:
        raise AssertionError(f"frozen_path: packets did not move ({moved})")
    # and on the marched positions, which have left [0, L) here and there
    check_cell_order(xN, grid, "frozen_path cell_order after the march")
    drift32 = float(res.conservation_error[-1])
    del want, res

    # the entry the path launches, and in turns with it the unordered
    # single launch of the same kernel that it took the place of
    unordered_ms = [cuda_ms_run(lambda: unordered_march(*args), 2, 3)]
    ms = cuda_ms_run(lambda: mr.march_rays_cuda(*args), 5)
    single_ms = cuda_ms(lambda: mr.march_rays_cuda(*args), 10)
    unordered_ms.append(cuda_ms_run(lambda: unordered_march(*args), 2, 3))
    replaced_ms = statistics.median(unordered_ms)
    plain_ms = cuda_ms(lambda: mr.march_rays_reference(*args), 2)
    peak = torch.cuda.max_memory_allocated()
    sweep, parts = phase_march_rays_segments(args, grid, disp, dt)
    ordering_ms = (len(segments) * parts["cell_order_cuda"]
                   + parts["node_major_copy"])

    # float64 at fewer packets, 500 steps: the absolute frequency
    # omega + U.k is the invariant of a steady flow
    f64 = torch.float64
    flow64 = GriddedFlow(fields=fields.to(f64), grid=grid)
    x64, k64 = ring_ics(FROZEN["drift_packets"], 2.0, disp, dtype=f64)
    xe, ke = mr.march_rays(flow64.fields, x64, k64, grid, disp, dt,
                           FROZEN["drift_steps"])
    om0 = disp.absolute_frequency(k64, flow64.at(x64[0], x64[1]).uv)
    om1 = disp.absolute_frequency(ke, flow64.at(xe[0], xe[1]).uv)
    drift = float(((om1 - om0) / om0).abs().max())
    if not drift < 2e-3:
        raise AssertionError(f"frozen_path: frequency drift {drift}")

    item = x0.element_size()
    flops = n_p * RAYS_STEPS * march_rays_flops_per_packet_step(2)
    nbytes = (2 * 4 * n_p + fields.numel()) * item
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FLOPS_PER_S[dtype] * 1e3
    # what any design pays in which each packet reads its own 36 x 6 values
    # from L1 or shared memory: 128 bytes a cycle an SM
    cache_bytes = 36 * 6 * item * n_p * RAYS_STEPS
    sms, clock_hz = sm_count_and_clock()
    by_cache = cache_bytes / (128.0 * sms * clock_hz) * 1e3
    # cycles of an SM per warp-wide load instruction: the march's time
    # over 72 16-byte loads a packet-step, 32 packets a warp
    warp_loads = n_p * RAYS_STEPS * 72 / 32
    cycles_per_warp_load = {
        name: t * 1e-3 * clock_hz * sms / warp_loads
        for name, t in (("ordered", ms - ordering_ms),
                        ("unordered", replaced_ms
                         - parts["node_major_copy"]))}
    emit("frozen_path", nx=nx, n_packets=n_p, dtype="float32", dt=dt,
         steps=RAYS_STEPS, order=2, launches=launches, segments=segments,
         first_launch_ms=first_ms, ms=ms, single_launch_ms=single_ms,
         replaced_ms=replaced_ms,
         unordered_single_launch_ms_before_and_after=unordered_ms,
         ordering_ms=ordering_ms,
         equals_unordered_single_launch_bit_for_bit=True,
         packet_steps_per_s=n_p * RAYS_STEPS / (ms / 1e3),
         cycles_per_warp_load=cycles_per_warp_load,
         max_abs_err_vs_plain=err, max_abs_err_vs_raytrace_frozen=err_frozen,
         atol=RAYS_F32_ATOL, max_packet_displacement=moved,
         frequency_drift_float32_50_steps=drift32,
         frequency_drift_float64_500_steps=drift, drift_limit=2e-3,
         drift_packets=FROZEN["drift_packets"], peak_memory_bytes=peak)
    bounds = {"march_rays": {
        "shape": f"fields {tuple(fields.shape)}, x0 k0 (2, {n_p}) {dtype}, "
                 f"{RAYS_STEPS} steps, order 2",
        "bytes": nbytes, "flops": flops, "ms_by_bytes": by_bytes,
        "ms_by_operations": by_ops,
        "stencil_reads_through_cache_bytes": cache_bytes,
        "ms_by_cache": by_cache, "sm_count": sms, "sm_clock_hz": clock_hz,
        "cache_bytes_per_cycle_per_sm": 128,
        "tolerance": {"rtol": 0.0, "atol": RAYS_F32_ATOL}}}
    row = {"name": "march_rays", "route": "cuda",
           "source": SOURCES["march_rays"],
           "replaces": REPLACES["march_rays"], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "library_ms": None, "single_launch_ms": single_ms,
           "replaced_ms": replaced_ms, "ordering_ms": ordering_ms,
           "segments": segments, "orderings": launches["cell_order"]}
    return [row], bounds, launches


# ---------------------------------------------------------------------------
# the production drivers (swraytracing_torch.drivers and its CLI)
# ---------------------------------------------------------------------------

# The two-layer driver at full width, as `python -m swraytracing_torch qg2`
# runs it: chunks of packet_steps_per_save = 25 flow steps (the two-layer
# defaults steps_per_save = 10, packet_steps_per_save = 25).
DRIVER = dict(nx=512, Npackets=1_048_576, packet_delay_days=0.01)


def frames_finite(path, n, nx, ny=1, nz=1):
    """Check that a .bin file holds exactly `n` frames of nx*ny*nz values,
    every one finite."""
    if binio.frame_count(path, nx, ny, nz) != n:
        raise AssertionError(f"{path}: {binio.frame_count(path, nx, ny, nz)}"
                             f" frames, expected {n}")
    data = np.fromfile(path + ".bin")
    if data.size != n * nx * ny * nz or not np.isfinite(data).all():
        raise AssertionError(f"{path}: not {n} finite frames")


def median_rate(metrics):
    return statistics.median(m["packet_steps_per_sec"] for m in metrics)


def phase_driver_cli(tmp):
    """`python -m swraytracing_torch qg2` at 512^2 with 2^20 packets, 100
    flow steps (4 chunks of 25), in a subprocess that loads the kernels
    this script built."""
    out = tmp / "cli"
    n_p = DRIVER["Npackets"]
    cmd = [sys.executable, "-m", "swraytracing_torch", "qg2", "--nx", "512",
           "--packets", str(n_p), "--delay-days", "0.01", "--max-steps",
           "100", "--out", str(out)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"the CLI exited with {r.returncode}:\n"
                             f"{r.stderr[-4000:]}")
    for name in ("packet_x", "packet_k"):
        frames_finite(str(out / name), 5, n_p, 2)
    frames_finite(str(out / "packet_time"), 5, 1)
    frames_finite(str(out / "pv"), 5, 512, 512, 2)
    frames_finite(str(out / "pv_time"), 5, 1)
    log = runmeta.parse_run_log(out / "run.log")
    if (log["nx"], log["n_packets"]) != (512, n_p) or \
            "wall_seconds" not in log:
        raise AssertionError(f"run.log does not parse: {log}")
    metrics = runmeta.RunDir(out).read_metrics()
    if len(metrics) != 4 or any("march_overflow" in m or "blow_up" in m
                                for m in metrics):
        raise AssertionError(f"metrics.jsonl: {metrics}")
    emit("driver_cli", command=" ".join(cmd[1:]), wall_seconds=wall,
         bytes_written=sum(f.stat().st_size for f in out.iterdir()),
         packet_frames=5, pv_frames=5, chunks=len(metrics),
         packet_steps_per_sec_chunks_2_to_4=median_rate(metrics[1:]),
         packet_steps_per_sec_by_chunk=[m["packet_steps_per_sec"]
                                        for m in metrics],
         run_log_wall_seconds=log["wall_seconds"])


def run_driver(out, max_steps, resume=False):
    """qg2layersw_raytrace in diagnostic mode (log-binned omega histograms
    on the card), its printed log captured. Returns (carry, RunDir, log,
    wall seconds)."""
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        carry, rd = drivers.qg2layersw_raytrace(
            out_dir=out, max_steps=max_steps, checkpoint_every=2,
            omega_hist_bins=300, omega_hist_log=True, resume=resume,
            **DRIVER)
    torch.cuda.synchronize()
    return carry, rd, text.getvalue(), time.perf_counter() - t0


def phase_driver_path(tmp, main):
    """The two-layer driver in diagnostic mode, 150 flow steps (6 chunks)
    with a checkpoint every 2 chunks, launch counts set to 0 just before:
    K1 once per flow step (on the route the rule gives the main path), K2
    once per flow step plus the first
    carry's windows plus one per window rebuild after a CFL recheck. Then
    100 steps, resumed from their checkpoint to 150, against the
    uninterrupted run."""
    n_p = DRIVER["Npackets"]
    steps = 150
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    carry, rd, text, wall = run_driver(tmp / "path", steps)
    launches = read_launches()
    routes = dict(mw.march_gathered_cuda.launches_by_route)
    gathers = mw.gather_packet_windows.calls
    peak = torch.cuda.max_memory_allocated()
    rechecks = text.count("CFL recheck")
    metrics = rd.read_metrics()
    if len(metrics) != 6 or any("march_overflow" in m or "blow_up" in m
                                for m in metrics):
        raise AssertionError(f"driver_path metrics: {metrics}")
    rule = main["march_route"]
    if launches["march"] != steps or routes != {**dict.fromkeys(routes, 0),
                                                rule: steps}:
        raise AssertionError(f"driver_path: march launches {launches}, "
                             f"routes {routes}, expected {steps} {rule}")
    if gathers != 0:
        raise AssertionError(f"driver_path: gather_packet_windows was "
                             f"called {gathers} times")
    rebuilds = launches["transpose"] - steps - 1
    if not 0 <= rebuilds <= rechecks:
        raise AssertionError(f"driver_path: {launches['transpose']} "
                             f"transposes for {steps} steps and {rechecks} "
                             "CFL rechecks")
    others = {k: v for k, v in launches.items()
              if k not in ("march", "transpose") and v}
    if others:
        raise AssertionError(f"driver_path launched {others}")
    if carry.overflow is None or int(carry.overflow) != 0:
        raise AssertionError("driver_path: overflow")
    hist = np.fromfile(str(tmp / "path" / "omega_hist.bin")).reshape(-1, 301)
    if hist.shape[0] != 7 or not (hist.sum(axis=1) == n_p).all():
        raise AssertionError(f"omega_hist: {hist.shape[0]} frames, sums "
                             f"{hist.sum(axis=1)}")
    if not torch.isfinite(carry.packet_x).all():
        raise AssertionError("driver_path: packets are not finite")
    rate = median_rate(metrics[1:])
    ratio = rate / main["packet_steps_per_s"]
    # what a driver's chunk does beyond the main path's, each timed alone
    # on the final carry (one call between two events: host included)
    spec = OmegaHistSpec(n_bins=300, omega_max=64.0 * 2.0 * 3.0, f=3.0,
                         Cg=1.0, omega_min=3.0, log_bins=True)
    grid = SpectralGrid.square(512, 20.0)
    extras = {
        "omega_hist_counts": cuda_ms(
            lambda: omega_hist_counts(carry.packet_k, spec), 9),
        "pv_grid_to_host": cuda_ms(
            lambda: sp.to_grid(carry.flow_state.qk, grid).cpu(), 9),
        "isfinite_read": cuda_ms(
            lambda: bool(torch.isfinite(carry.flow_state.qk).all()), 9),
        "overflow_read": cuda_ms(lambda: int(carry.overflow), 9),
    }
    chunk_seconds = sum(m["wall_s"] for m in metrics)
    # the driver's chunk loop alone: the same chunks of 25 steps with their
    # histograms and per-chunk reads, timed by the host clock as the driver
    # times them, but no frame written and no checkpoint taken
    cfg = Coupled2Config(nx=512, n_packets=n_p, packet_delay_days=0.01)
    s, c = setup_coupled2(cfg)
    alone = []
    for _ in range(6):
        t0 = time.perf_counter()
        c, _ = run_coupled2_chunk(
            c, s, cfg, 1, diag_fn=lambda cc: omega_hist_counts(cc.packet_k,
                                                               spec))
        if not bool(torch.isfinite(c.flow_state.qk).all()) or \
                int(c.overflow) != 0:
            raise AssertionError("the chunk loop alone failed")
        alone.append(cfg.packet_steps_per_save * n_p
                     / (time.perf_counter() - t0))
        c = dataclasses.replace(c, overflow=torch.zeros_like(c.overflow))
    del s, c
    alone_rate = statistics.median(alone[1:])
    where = None
    if ratio < 0.8:
        where = (f"chunks 2-6 run at {ratio:.3f} of main_path's rate. The "
                 "same chunk loop without frames or checkpoints runs at "
                 f"{alone_rate / main['packet_steps_per_s']:.3f} of it: the "
                 "rest is the frame-writer thread and the checkpoints "
                 "taking the host from the launching thread. The chunk's "
                 f"own extras, each alone (ms): {extras}; "
                 f"{wall - chunk_seconds:.3f} s of the {wall:.3f} s run lie "
                 "between chunks (setup, frames, checkpoints, rechecks)")

    # resume: 100 steps, then resumed from their checkpoint to 150
    _, _, _, wall100 = run_driver(tmp / "resume", 100)
    resumed, _, rtext, wall_resume = run_driver(tmp / "resume", steps,
                                                resume=True)
    if "resumed from" not in rtext:
        raise AssertionError("the second run did not resume")
    hist_r = np.fromfile(str(tmp / "resume" / "omega_hist.bin"))
    if not np.array_equal(hist_r.reshape(-1, 301), hist):
        raise AssertionError("resumed omega_hist frames differ from the "
                             "uninterrupted run's")
    dx = float((resumed.packet_x - carry.packet_x).abs().max())
    dk = float((resumed.packet_k - carry.packet_k).abs().max())
    if not max(dx, dk) <= 1e-6:
        raise AssertionError(f"resumed packets differ by {max(dx, dk)}")
    emit("driver_path", nx=512, n_packets=n_p, flow_steps=steps,
         chunks=len(metrics), wall_seconds=wall, chunk_seconds=chunk_seconds,
         launches=launches, march_launches_by_route=routes,
         transpose_launches=launches["transpose"],
         transpose_per_flow_step=steps, transpose_first_carry=1,
         transpose_rebuilds_after_cfl_recheck=rebuilds,
         cfl_rechecks=rechecks, gather_packet_windows_calls=gathers,
         overflow=int(carry.overflow), omega_hist_frames=int(hist.shape[0]),
         omega_hist_overflow_slot=float(hist[:, -1].sum()),
         packet_steps_per_sec_chunks_2_to_6=rate,
         packet_steps_per_sec_by_chunk=[m["packet_steps_per_sec"]
                                        for m in metrics],
         main_path_packet_steps_per_s=main["packet_steps_per_s"],
         ratio_to_main_path=ratio,
         chunk_loop_alone_packet_steps_per_sec_chunks_2_to_6=alone_rate,
         chunk_loop_alone_by_chunk=alone, below_80_percent=where,
         chunk_extras_ms=extras, peak_memory_bytes=peak,
         resume={"wall_seconds_100_steps": wall100,
                 "wall_seconds_resumed_to_150": wall_resume,
                 "omega_hist_equal": True,
                 "omega_hist_frames_after_checkpoint": [6, 7],
                 "max_abs_dx": dx, "max_abs_dk": dk,
                 "bit_equal": dx == 0.0 and dk == 0.0, "atol": 1e-6})
    return launches


def phase_driver_reference_config(tmp, main_qg1):
    """The reference's own CLI configuration, qgsw_raytrace(nx=256,
    Npackets=50): below window_min_np, so the per-stage stencil path, which
    launches no kernel of the port. Then 20 steps of the windowed per-stage
    path at full width (march off), beside main_path_qg1."""
    cfg_ref = CoupledConfig(nx=256, n_packets=50, packet_delay_days=0.01)
    s_ref, c_ref = setup_coupled(cfg_ref)
    if s_ref.march is not None:
        raise AssertionError("the reference configuration engaged the march")
    # the parts of one per-stage flow step, each alone (one call between
    # two events, host included): the flow step, the six field grids, one
    # rk23 substep (three evaluations of the blended flow at 50 packets)
    qp = s_ref.qg_params
    flow_ref = BlendedFlow(fields1=c_ref.prev_fields,
                           fields2=c_ref.prev_fields, grid=s_ref.grid)
    parts_ref = time_parts({
        "qg_step": lambda: qg.qg_step(c_ref.flow_state, s_ref.grid, qp),
        "flow_from_qk_6_fields": lambda: flow_from_qk(
            c_ref.flow_state.qk, s_ref.grid, qp.Kd2).fields,
        "rk23_substep": lambda: rays.rk23_step(
            c_ref.packet_x, c_ref.packet_k, s_ref.dt / 2, s_ref.disp,
            flow_ref, 0.0, 0.5)}, reps=9)
    reset_launches()
    carry, rd = drivers.qgsw_raytrace(nx=256, Npackets=50,
                                      packet_delay_days=0.01, max_steps=100,
                                      out_dir=tmp / "reference",
                                      verbose=False)
    torch.cuda.synchronize()
    launches = read_launches()
    if any(launches.values()) or carry.overflow is not None:
        raise AssertionError(f"the per-stage path launched {launches}")
    out = tmp / "reference"
    n_frames = binio.frame_count(str(out / "packet_x"), 50, 2)
    frames_finite(str(out / "packet_x"), n_frames, 50, 2)
    frames_finite(str(out / "pv"), 3, 256, 256)
    x = binio.read_field(str(out / "packet_x"), 50, 2,
                         frames=[1, n_frames])
    k = binio.read_field(str(out / "packet_k"), 50, 2,
                         frames=[1, n_frames])
    moved = float(np.abs(x[..., 1] - x[..., 0]).max())
    om = np.sqrt(9.0 + (k ** 2).sum(axis=1)) / 3.0        # (50, 2)
    if n_frames != 21 or not moved > 1e-4:
        raise AssertionError(f"{n_frames} packet frames; packets moved "
                             f"{moved}")
    if not (om[:, 1].std() > 1e-6 and om[:, 1].std() > 10 * om[:, 0].std()):
        raise AssertionError(f"omega/f did not spread: {om.std(axis=0)}")
    metrics = rd.read_metrics()
    ms_ref = [1e3 * m["wall_s"] / m["steps"] for m in metrics]

    # the windowed per-stage path at full width: 20 steps after one
    # warm-up step, the launch counts set to 0 before the setup
    cfg = CoupledConfig(**dict(FULL, fused_march=False))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    s, c = setup_coupled(cfg)
    if s.march is not None:
        raise AssertionError("the march engaged with fused_march=False")
    c = prepare_carry_windows(c, False, s.march, window_threshold(cfg))
    coupled_flow_packet_step(c, s, cfg)       # warm-up (cuFFT plans)
    x0 = c.packet_x.clone()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    c, _ = run_coupled_chunk(c, s, cfg, 1)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / cfg.packet_steps_per_save
    windowed_launches = read_launches()
    if any(windowed_launches.values()):
        raise AssertionError(f"the windowed per-stage path launched "
                             f"{windowed_launches}")
    if c.prev_win is None or not torch.isfinite(c.packet_x).all() or \
            not float((c.packet_x - x0).abs().max()) > 1e-4:
        raise AssertionError("the windowed per-stage path: no windows, "
                             "packets not finite or not moving")
    peak = torch.cuda.max_memory_allocated()
    emit("driver_reference_config", nx=256, n_packets=50, flow_steps=100,
         march=None, launches=launches, packet_frames=n_frames,
         pv_frames=3, max_packet_displacement=moved,
         omega_over_f_start=[float(om[:, 0].mean()), float(om[:, 0].std())],
         omega_over_f_end=[float(om[:, 1].mean()), float(om[:, 1].std())],
         ms_per_flow_step_by_chunk=ms_ref,
         step_parts_ms=dict(parts_ref, flow_step_estimate=(
             parts_ref["qg_step"] + parts_ref["flow_from_qk_6_fields"]
             + 2 * parts_ref["rk23_substep"])),
         windowed_full_width={
             "nx": cfg.nx, "n_packets": cfg.n_packets, "fused_march": False,
             "flow_steps": cfg.packet_steps_per_save, "ms_per_flow_step": ms,
             "peak_memory_bytes": peak, "launches": windowed_launches,
             "main_path_qg1_ms_per_flow_step": main_qg1["ms_per_flow_step"],
             "main_path_qg1_peak_memory_bytes":
                 main_qg1["peak_memory_bytes"]})
    return launches


# ---------------------------------------------------------------------------
# the ensemble sweep at full width
# ---------------------------------------------------------------------------

# Run I of the JAX package's science runs (runs/run_tpu_sweep_b2000.py:
# 46-57): the 12 members of the reference's 20-config sweep with U_g > 0.4,
# numbered as in parameters.txt, 256^2 with 2^14 packets each, log-binned
# omega histograms, a PV frame every 4 chunks; with the cuts of
# ENSEMBLE_CUTS.
ENSEMBLE_IDS = [i for i, (_, ug) in enumerate(drivers.DEFAULT_SWEEP)
                if ug > 0.4]
ENSEMBLE_SWEEP = [drivers.DEFAULT_SWEEP[i] for i in ENSEMBLE_IDS]
ENSEMBLE = dict(nx=256, Npackets=2 ** 14, f=3.0, Cg=1.0, r_drag=0.0,
                forcing_strength=0.0, steps_per_save=100,
                packet_steps_per_save=5, packet_delay_days=0.01,
                omega_hist_bins=400, omega_hist_log=True,
                omega_hist_max_factor=64.0, window_min_np=2 ** 13,
                pv_every=4, max_margin_retries=4)
ENSEMBLE_T = 2000.0
ENSEMBLE_STEPS = 300
ENSEMBLE_CUTS = {
    "steps_per_save": "100, not 1000: a chunk is 100 flow steps",
    "packet_delay_days": "0.01, not 1000: the packets move from the start",
    "max_steps": "300 with checkpoint_every=2, not the horizon T = 2000 "
                 "with checkpoint_every=40"}


def run_ensemble_driver(base, max_steps, resume=False, **kw):
    """run_sweep(ensemble=True) as Run I calls it, with the cuts. Returns
    (carry, RunDirs, host seconds, CUDA-event seconds) of the whole
    call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    carry, rds = drivers.run_sweep(
        ENSEMBLE_SWEEP, base_dir=str(base), ensemble=True,
        member_ids=ENSEMBLE_IDS, T_member=lambda w0, ug: ENSEMBLE_T,
        max_steps=max_steps, checkpoint_every=2, resume=resume,
        verbose=False, **ENSEMBLE, **kw)
    end.record()
    torch.cuda.synchronize()
    return (carry, rds, time.perf_counter() - t0,
            start.elapsed_time(end) / 1e3)


def member_files(base, name):
    """Each member's `name` file of an ensemble sweep, as bytes."""
    return [(Path(base) / f"run-{i}" / f"{name}.bin").read_bytes()
            for i in ENSEMBLE_IDS]


def timed_chunks(chunk, carry, n_chunks):
    """n_chunks calls of chunk(carry) -> (carry, saves), each followed by
    the driver's per-chunk reads: whether the flow is finite, and the
    overflow counts, which are then set to 0. Returns (carry, host seconds,
    CUDA-event seconds, the largest overflow)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    overflow = 0
    for _ in range(n_chunks):
        carry, _ = chunk(carry)
        if not bool(torch.isfinite(carry.flow_state.qk).all()):
            raise AssertionError("the flow blew up")
        overflow = max(overflow, int(carry.overflow.max()))
        carry = dataclasses.replace(carry,
                                    overflow=torch.zeros_like(carry.overflow))
    end.record()
    torch.cuda.synchronize()
    return (carry, time.perf_counter() - t0, start.elapsed_time(end) / 1e3,
            overflow)


def ensemble_kernel_rows(carry, s, es, cfg):
    """The three batched kernels on the ensemble path's final carry: the
    inputs of its next flow step as lockstep_step forms them. Each held
    against its plain version, timed beside it and beside one PyTorch call
    that computes the same, with the bound of the bytes (and, for the
    march, the operations) the function must move."""
    spec = s.march
    dtype, item = carry.packet_x.dtype, carry.packet_x.element_size()
    E, _, n_p = carry.packet_x.shape
    qp = s.qg_params
    state2 = qg.qg_step(carry.flow_state, s.grid, qp, dt=es.dt)
    fields2 = flow_from_qk(state2.qk, s.grid, qp.Kd2,
                           n_fields=spec.nf).fields.contiguous()
    W = mw.build_margin_windows(fields2, spec).contiguous()  # (E, K, ncells)
    win2 = mw.transpose_batched_cuda(W)
    x, k = carry.packet_x, carry.packet_k
    oi, oj = mw.packet_cells(x[:, 0], x[:, 1], spec)
    sub_dt = torch.as_tensor(es.dt / cfg.n_substeps, dtype=torch.float64,
                             device=x.device)
    inputs = (carry.prev_win, win2, torch.cat([x, k], dim=1), oi, oj)
    err, _, ovmax, _, route = compare_march(
        inputs, sub_dt, spec, F32_RTOL, F32_ATOL,
        "batched march on the ensemble path",
        kernel=mw.march_gathered_batched_cuda,
        plain=mw.march_gathered_batched_reference)
    if ovmax != 0:
        raise AssertionError(f"batched march overflow {ovmax}")
    march = lambda: mw.march_gathered_batched_cuda(*inputs, sub_dt, spec)
    k1_ms, k1_single = cuda_ms_run(march), cuda_ms(march, 25)

    def by_route(route, c, sp=spec):
        return mw.march_gathered_batched_cuda(*inputs, sub_dt, sp,
                                              route=route, consumers=c)

    k1_by_route = ms_by_route(by_route, spec, dtype)
    k1_split = stepper_split(by_route, spec, dtype)
    k1_plain = cuda_ms(
        lambda: mw.march_gathered_batched_reference(*inputs, sub_dt, spec), 3)
    # every row some packet of a member reads, once per member, and per
    # packet xk, oi, oj in and xk, overflow out
    occupied = [int(torch.unique(oi[e].long() * spec.ny + oj[e]).numel())
                for e in range(E)]
    k1_bytes = (sum(occupied) * 2 * spec.K * item
                + E * n_p * (4 * item + 8 + 4 * item + 4))
    k1_flops = E * n_p * march_flops_per_packet(spec)
    k1_by_bytes = k1_bytes / HBM_BYTES_PER_S * 1e3
    k1_by_ops = k1_flops / FLOPS_PER_S[dtype] * 1e3

    if not torch.equal(win2, mw.transpose_batched_reference(W)):
        raise AssertionError("transpose_batched differs on the ensemble path")
    transpose = lambda: mw.transpose_batched_cuda(W)
    k2_ms, k2_single = cuda_ms_run(transpose), cuda_ms(transpose, 25)
    k2_plain = cuda_ms_run(lambda: mw.transpose_batched_reference(W), 5)
    k2_lib = cuda_ms_run(lambda: W.transpose(-1, -2).contiguous(), 10)
    k2_bytes = 2 * W.numel() * item
    del W

    got = mw.build_windows_batched_cuda(fields2, spec)
    if not (torch.equal(got, mw.build_windows_batched_reference(fields2, spec))
            and torch.equal(got, win2)):
        raise AssertionError("build_windows_batched differs on the ensemble "
                             "path from its plain version or the two-pass "
                             "route")
    # the one library copy that does the same: the padded fields' shifted
    # views (E, nf, SW, SW, nx, ny), permuted to rows, made contiguous
    shifted = mw._shifted_views(fields2, spec)
    library = lambda: shifted.permute(0, 4, 5, 1, 2, 3).contiguous()
    if not torch.equal(library().reshape(got.shape), got):
        raise AssertionError("the library copy computes another function")
    build = lambda: mw.build_windows_batched_cuda(fields2, spec)
    k3_ms, k3_single = cuda_ms_run(build), cuda_ms(build, 25)
    k3_plain = cuda_ms_run(
        lambda: mw.build_windows_batched_reference(fields2, spec), 5)
    k3_lib = cuda_ms_run(library, 10)
    k3_bytes = (got.numel() + fields2.numel()) * item
    out_shape = tuple(got.shape)
    del got, shifted, win2

    def row(name, err, ms, plain, by_bytes, by_ops, lib, single, **extra):
        return {"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": max(by_bytes, by_ops),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "library_ms": lib, "single_launch_ms": single, **extra}

    rows = [
        row("march_batched", err, k1_ms, k1_plain, k1_by_bytes, k1_by_ops,
            None, k1_single, march_route=route, source=MARCH_SOURCES[route],
            sources=sorted(set(MARCH_SOURCES.values())),
            ms_by_route=k1_by_route,
            ring_consumers=mw.ring_consumers(spec, dtype),
            ring_slots=mw.ring_slots(spec, dtype),
            stepper_split=k1_split,
            one_row_a_packet_ms=E * n_p * (2 * spec.K * item + 4 * item + 8
                                           + 4 * item + 4)
            / HBM_BYTES_PER_S * 1e3),
        row("transpose_batched", 0.0, k2_ms, k2_plain,
            k2_bytes / HBM_BYTES_PER_S * 1e3, 0.0, k2_lib, k2_single),
        row("build_windows_batched", 0.0, k3_ms, k3_plain,
            k3_bytes / HBM_BYTES_PER_S * 1e3, 0.0, k3_lib, k3_single)]
    bounds = {
        "march_batched": {
            "shape": f"{E} members: win1, win2 ({E}, {spec.nx * spec.ny}, "
                     f"{spec.K}) {dtype} read by cell, one row of 2K = "
                     f"{2 * spec.K} values an occupied cell of a member, "
                     f"xk ({E}, 4, {n_p}), sub_dt ({E},) float64",
            "occupied_cells_by_member": occupied,
            "cells_per_member": spec.nx * spec.ny, "bytes": k1_bytes,
            "flops": k1_flops, "ms_by_bytes": k1_by_bytes,
            "ms_by_operations": k1_by_ops,
            "tolerance": {"rtol": F32_RTOL, "atol": F32_ATOL}},
        "transpose_batched": {
            "shape": f"({E}, {spec.K}, {spec.nx * spec.ny}) {dtype}",
            "bytes": k2_bytes, "flops": 0,
            "ms_by_bytes": k2_bytes / HBM_BYTES_PER_S * 1e3,
            "ms_by_operations": 0.0, "tolerance": "exact"},
        "build_windows_batched": {
            "shape": f"F {tuple(fields2.shape)} -> {out_shape} {dtype}",
            "bytes": k3_bytes, "flops": 0,
            "ms_by_bytes": k3_bytes / HBM_BYTES_PER_S * 1e3,
            "ms_by_operations": 0.0, "tolerance": "exact"}}
    return rows, bounds


def phase_ensemble_path(tmp):
    """Run I's ensemble sweep on the card through run_sweep(ensemble=True),
    the launch counts set to 0 just before and read just after: 300 flow
    steps of 12 members, one launch of the batched march and of the
    batched transpose a flow step for all members. Then 200 steps resumed
    from their checkpoint to 300 (histograms and packets equal bit for
    bit); 100 steps with the one-pass window build (the batched build
    kernel; histograms equal the two-pass run's); the ensemble's chunks
    alone (no files); and the same 12 members for the same 300 steps one
    after another through the solo run_coupled_chunk."""
    E, n_p = len(ENSEMBLE_SWEEP), ENSEMBLE["Npackets"]
    steps = ENSEMBLE_STEPS
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    carry, rds, host_s, event_s = run_ensemble_driver(tmp / "ensemble", steps)
    launches = read_launches()
    routes = dict(mw.march_gathered_batched_cuda.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    metrics = runmeta.RunDir(tmp / "ensemble").read_metrics()
    n_chunks = steps // ENSEMBLE["steps_per_save"]
    if len(metrics) != n_chunks or any(
            "march_overflow" in m or "blow_up" in m for m in metrics):
        raise AssertionError(f"ensemble_path metrics: {metrics}")
    if [m["members_live"] for m in metrics] != [E] * n_chunks:
        raise AssertionError(f"members live: {metrics}")
    expected = dict.fromkeys(WRAPPERS, 0)
    expected["march_batched"] = steps
    expected["transpose_batched"] = steps + 1   # and the first carry's
    took = [r for r, n in routes.items() if n]
    if launches != expected or routes.get(took[0] if took else None) != steps:
        raise AssertionError(f"ensemble_path: launch counts {launches}, "
                             f"routes {routes}, expected {expected}, all on "
                             "one route")
    overflow = carry.overflow.cpu().tolist()
    if max(overflow) != 0 or not (carry.flow_state.step == steps).all():
        raise AssertionError(f"ensemble_path: overflow {overflow}, steps "
                             f"{carry.flow_state.step}")
    n_bins = ENSEMBLE["omega_hist_bins"] + 1
    hists = [np.frombuffer(b).reshape(-1, n_bins)
             for b in member_files(tmp / "ensemble", "omega_hist")]
    frames = 1 + steps // ENSEMBLE["packet_steps_per_save"]
    if any(h.shape[0] != frames or not (h.sum(axis=1) == n_p).all()
           for h in hists):
        raise AssertionError("ensemble_path: omega_hist frames or sums")
    om = torch.sqrt(9.0 + (carry.packet_k ** 2).sum(1)) / 3.0   # (E, Np)
    w0s = torch.tensor([w0 for w0, _ in ENSEMBLE_SWEEP], device=om.device)
    spread = (om.std(dim=1) / w0s).cpu().tolist()
    if not (torch.isfinite(carry.packet_x).all() and min(spread) > 1e-5):
        raise AssertionError(f"ensemble_path: omega/f did not spread "
                             f"({spread}) or packets are not finite")
    rate = median_rate(metrics[1:])

    # resume: 200 steps, then from their checkpoint to 300
    _, _, host200, _ = run_ensemble_driver(tmp / "resume", 200)
    resumed, _, host_resume, _ = run_ensemble_driver(tmp / "resume", steps,
                                                     resume=True)
    for name in ("omega_hist", "packet_time", "packet_snap_x",
                 "packet_snap_k", "packet_snap_time"):
        if member_files(tmp / "resume", name) != member_files(
                tmp / "ensemble", name):
            raise AssertionError(f"resumed {name} differs from the "
                                 "uninterrupted run's")
    if not (torch.equal(resumed.packet_x, carry.packet_x)
            and torch.equal(resumed.packet_k, carry.packet_k)):
        raise AssertionError("resumed packets differ from the uninterrupted "
                             "run's")
    del resumed

    # the one-pass window build: the batched build kernel in place of the
    # shifted copies and the batched transpose, the same windows
    fused_steps = ENSEMBLE["steps_per_save"]
    reset_launches()
    fused, _, _, _ = run_ensemble_driver(tmp / "fused", fused_steps,
                                         march_fused_build=True)
    launches_fused = read_launches()
    expected_fused = dict.fromkeys(WRAPPERS, 0)
    expected_fused["march_batched"] = fused_steps
    expected_fused["build_windows_batched"] = fused_steps + 1
    if launches_fused != expected_fused:
        raise AssertionError(f"ensemble fused build: launch counts "
                             f"{launches_fused}, expected {expected_fused}")
    fused_frames = 1 + fused_steps // ENSEMBLE["packet_steps_per_save"]
    for h, b in zip(hists, member_files(tmp / "fused", "omega_hist")):
        if not np.array_equal(np.frombuffer(b).reshape(-1, n_bins),
                              h[:fused_frames]):
            raise AssertionError("the one-pass build's histograms differ "
                                 "from the two-pass run's")
    del fused

    # the chunks alone, without files: the ensemble, then the members one
    # after another through the solo chunk, each with the driver's
    # histogram and per-chunk reads
    cfgs = [CoupledConfig(
        nx=ENSEMBLE["nx"], n_packets=n_p, near_inertial_factor=w0, U_g=ug,
        packet_delay_days=ENSEMBLE["packet_delay_days"], f=3.0, Cg=1.0,
        r_drag=0.0, forcing_strength=0.0,
        steps_per_save=ENSEMBLE["steps_per_save"],
        packet_steps_per_save=ENSEMBLE["packet_steps_per_save"],
        window_min_np=ENSEMBLE["window_min_np"])
        for w0, ug in ENSEMBLE_SWEEP]
    spec = OmegaHistSpec(n_bins=ENSEMBLE["omega_hist_bins"], omega_max=1.0,
                         f=3.0, Cg=1.0, omega_min=3.0, log_bins=True)
    wmax = [ENSEMBLE["omega_hist_max_factor"] * w0 * 3.0
            for w0, _ in ENSEMBLE_SWEEP]
    n_saves = ENSEMBLE["steps_per_save"] // ENSEMBLE["packet_steps_per_save"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    s, es, cb = ens.setup_ensemble(cfgs)
    # the one route the driver's launches took is the one the rule gives
    rule = mw.march_route(s.march, cb.packet_x.dtype)
    if took != [rule]:
        raise AssertionError(f"ensemble_path: the batched march took {took}, "
                             f"the rule gives {rule}")
    es = es.replace(T=np.full(E, ENSEMBLE_T))
    wdev = torch.tensor(wmax, dtype=torch.float32, device=cb.packet_x.device)
    alone, alone_host, alone_event, alone_ov = timed_chunks(
        lambda c: ens.run_ensemble_chunk(
            c, es, s, cfgs[0], n_saves,
            diag_fn=lambda cc, i: omega_hist_counts(cc.packet_k, spec,
                                                    omega_max=wdev[i])),
        cb, n_chunks)
    launches_alone = read_launches()
    peak_alone = torch.cuda.max_memory_allocated()
    if not (torch.equal(alone.packet_x, carry.packet_x)
            and torch.equal(alone.packet_k, carry.packet_k)):
        raise AssertionError("the ensemble's chunks alone differ from the "
                             "driver's run")
    del alone, cb

    # warm-up of the solo path (its cuFFT plans), then the members in turn
    s0, c0 = setup_coupled(cfgs[0])
    run_coupled_chunk(c0, s0, cfgs[0], 1)
    del s0, c0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seq_host = seq_event = 0.0
    seq_ov, dx, dk = 0, [], []
    for e, cfg in enumerate(cfgs):
        s_e, c_e = setup_coupled(cfg)
        w_e = torch.tensor(wmax[e], dtype=torch.float32,
                           device=c_e.packet_x.device)
        c_e, h, d, o = timed_chunks(
            lambda c: run_coupled_chunk(
                c, s_e, cfg, n_saves,
                diag_fn=lambda cc: omega_hist_counts(cc.packet_k, spec,
                                                     omega_max=w_e)),
            c_e, n_chunks)
        seq_host, seq_event, seq_ov = seq_host + h, seq_event + d, max(seq_ov,
                                                                       o)
        dx.append(float((c_e.packet_x - carry.packet_x[e]).abs().max()))
        dk.append(float((c_e.packet_k - carry.packet_k[e]).abs().max()))
        del s_e, c_e
    launches_seq = read_launches()
    peak_seq = torch.cuda.max_memory_allocated()
    if alone_ov != 0 or seq_ov != 0:
        raise AssertionError(f"overflow: ensemble {alone_ov}, sequential "
                             f"{seq_ov}")
    if launches_seq["march"] != E * steps or \
            launches_seq["transpose"] != E * (steps + 1):
        raise AssertionError(f"sequential launches {launches_seq}")
    if not all(np.isfinite(dx + dk)):
        raise AssertionError("the sequential packets are not finite")

    member_steps = E * steps

    def rates(seconds):
        return {"member_steps_per_s": member_steps / seconds,
                "packet_steps_per_s": member_steps * n_p / seconds}

    rows, bounds = ensemble_kernel_rows(carry, s, es, cfgs[0])
    emit("ensemble_path", source="runs/run_tpu_sweep_b2000.py:46-57 (Run I)",
         members=E, member_ids=ENSEMBLE_IDS, nx=ENSEMBLE["nx"],
         n_packets_per_member=n_p, dtype="float32", cuts=ENSEMBLE_CUTS,
         margin=s.march.margin, K=s.march.K, flow_steps=steps,
         chunks=n_chunks,
         ensemble={
             "launches": launches, "march_launches_by_route": routes,
             "launches_per_ensemble_step": {
                 "march_batched": launches["march_batched"] / steps,
                 "transpose_batched": (launches["transpose_batched"] - 1)
                 / steps},
             "host_seconds": host_s, "cuda_event_seconds": event_s,
             "chunk_seconds": sum(m["wall_s"] for m in metrics),
             "packet_steps_per_sec_chunks_2_to_3": rate,
             "member_steps_per_sec_chunks_2_to_3": rate / n_p,
             "packet_steps_per_sec_by_chunk": [m["packet_steps_per_sec"]
                                               for m in metrics],
             "peak_memory_bytes": peak, "overflow": overflow,
             "omega_hist_frames": frames,
             "omega_hist_overflow_slot": [float(h[:, -1].sum())
                                          for h in hists],
             "omega_over_f_std_over_w0": spread},
         resume={"host_seconds_200_steps": host200,
                 "host_seconds_resumed_to_300": host_resume,
                 "omega_hist_and_snapshots_equal": True,
                 "packets_equal_bit_for_bit": True},
         fused_build={"flow_steps": fused_steps, "launches": launches_fused,
                      "omega_hist_equal_to_two_pass": True},
         chunks_alone={
             "ensemble": {"host_seconds": alone_host,
                          "cuda_event_seconds": alone_event,
                          **rates(alone_host),
                          "launches": launches_alone,
                          "launches_per_ensemble_step": {
                              "march_batched":
                                  launches_alone["march_batched"] / steps,
                              "transpose_batched":
                                  (launches_alone["transpose_batched"] - 1)
                                  / steps},
                          "peak_memory_bytes": peak_alone,
                          "overflow": alone_ov,
                          "equal_to_the_driver_run_bit_for_bit": True},
             "sequential": {"host_seconds": seq_host,
                            "cuda_event_seconds": seq_event,
                            **rates(seq_host),
                            "launches": launches_seq,
                            "launches_per_ensemble_step": {
                                "march": launches_seq["march"] / steps,
                                "transpose":
                                    (launches_seq["transpose"] - E) / steps},
                            "peak_memory_bytes": peak_seq,
                            "overflow": seq_ov},
             "ensemble_speedup_host": seq_host / alone_host,
             "ensemble_speedup_cuda_events": seq_event / alone_event},
         ensemble_minus_solo_float32={
             "max_abs_dx_by_member": dx, "max_abs_dk_by_member": dk,
             "max_abs_dx": max(dx), "max_abs_dk": max(dk),
             "why": "batched and single cuFFT plans round differently; the "
                    "kernels' members equal single launches bit for bit "
                    "(kernels_vs_plain)"})
    by_path = {"ensemble_path": launches,
               "ensemble_path_fused_build": launches_fused}
    return rows, bounds, by_path, routes



# ---------------------------------------------------------------------------
# the differentiable path
# ---------------------------------------------------------------------------

# Flow steps differentiated at full width: one lock-step, and a chunk of 5.
GRAD_STEPS = (1, 5)
# The matched configuration of the JAX package's GRAD_r05 study
# (benchmarks/gradscience_r05.py:40-60): dt pinned to the file's value,
# L(a) = var(omega_final) for qk0 -> a*qk0, remat, 50 and 250 flow steps.
GRAD_R05 = dict(nx=256, n_packets=2 ** 14, T_Fr_days=6000.0,
                packet_delay_days=0.01, U_g=0.4, f=3.0, Cg=1.0,
                window_min_np=2 ** 13)
GRAD_R05_SAVES = (10, 50)   # x packet_steps_per_save=5: 50, 250 flow steps
ROOT = Path(__file__).resolve().parent
GRAD_R05_DTPIN = ROOT / "benchmarks" / "gradscience_r05.dtpin"
GRAD_R05_JSON = ROOT / "GRAD_r05.json"
# bounds on dL/da: float64 against its own central difference at 50 steps,
# against the JAX package's float64 CPU adjoint at 50 / 250 steps, and
# float32 against float64 (the JAX package's float32 read 0.55% / 0.65%)
GRAD_R05_FD_EPS, GRAD_R05_FD_RTOL = 1e-5, 1e-3
GRAD_R05_JAX_RTOL = {50: 1e-6, 250: 1e-4}
GRAD_R05_F32_RTOL = 2e-2
# float64 gradients of the O(1)-memory integrator against plain autograd
REVERSIBLE_RTOL = 1e-8


def grad_counts():
    """The launch counts, with the transpose kernel's split by direction."""
    counts = read_launches()
    counts["transpose_in_backward"] = \
        mw.transpose_cuda.launches_by_direction["backward"]
    return counts


def with_grad_leaf(carry, wrt):
    """A copy of `carry` whose packet_k ("packet_k") or PV spectrum ("qk")
    is a fresh leaf that requires grad; returns (carry, leaf)."""
    if wrt == "packet_k":
        leaf = carry.packet_k.detach().clone().requires_grad_(True)
        return dataclasses.replace(carry, packet_k=leaf), leaf
    leaf = carry.flow_state.qk.detach().clone().requires_grad_(True)
    return dataclasses.replace(carry, flow_state=dataclasses.replace(
        carry.flow_state, qk=leaf)), leaf


def expected_grad_launches(steps, wrt, remat, window):
    """Launches of one differentiated chunk of `steps` flow steps: K1 once a
    step; the window kernel (`window`: "transpose" K2, or "build_windows"
    K3) once a step for the new snapshot, twice under remat (the carry
    holds no windows, so each step builds both snapshots'); the backward
    recomputes each step under remat; K2 runs again in the backward once
    for each forward transpose whose windows need a gradient (the flow
    gradient): all but the first step's blend-start windows, which come
    from the carry's fields and do not depend on qk. K3's backward is the
    plain build's transpose."""
    per_step = 2 if remat else 1
    forward = dict.fromkeys(WRAPPERS, 0)
    forward["march"] = steps
    forward[window] = per_step * steps
    recompute = {k: v if remat else 0 for k, v in forward.items()}
    backward = (per_step * steps - (1 if remat else 0)
                if wrt == "qk" and window == "transpose" else 0)
    return forward, recompute, backward


def differentiate(run_chunk, s, cfg, carry, steps, wrt, remat, window):
    """Loss sum(pk^2)*1e-6 after `steps` flow steps from `carry`,
    differentiated w.r.t. packet_k or qk by autograd.grad, with remat or
    without: after one warm-up, the forward and the backward each between
    CUDA events, the peak bytes over both, the launches of the forward and
    those made during the backward (recompute and backward counted
    apart)."""
    c_cfg = cfg._replace(packet_steps_per_save=steps)

    def forward():
        c, leaf = with_grad_leaf(carry, wrt)
        c2, _ = run_chunk(c, s, c_cfg, 1, remat=remat)
        return (c2.packet_k * c2.packet_k).sum() * 1e-6, leaf, c2

    loss, leaf, _ = forward()
    torch.autograd.grad(loss, leaf)
    del loss, leaf
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    before = grad_counts()
    e0.record()
    loss, leaf, c2 = forward()
    e1.record()
    mid = grad_counts()
    (g,) = torch.autograd.grad(loss, leaf)
    e2.record()
    torch.cuda.synchronize()
    after = grad_counts()
    peak = torch.cuda.max_memory_allocated()
    fwd = {k: mid[k] - before[k] for k in before}
    bwd = {k: after[k] - mid[k] for k in before}
    launches = {
        "forward": {k: v for k, v in fwd.items()
                    if k != "transpose_in_backward"},
        "recompute": {k: bwd[k] - (bwd["transpose_in_backward"]
                                   if k == "transpose" else 0)
                      for k in bwd if k != "transpose_in_backward"},
        "backward": {"transpose": bwd["transpose_in_backward"]}}
    want_f, want_r, want_b = expected_grad_launches(steps, wrt, remat,
                                                    window)
    label = f"grad_path {window} {steps} steps d/d{wrt} remat={remat}"
    if (launches["forward"] != want_f or launches["recompute"] != want_r
            or launches["backward"]["transpose"] != want_b
            or fwd["transpose_in_backward"] != 0):
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"forward {want_f}, recompute {want_r}, "
                             f"transpose in the backward {want_b}")
    if not (torch.isfinite(torch.view_as_real(g) if g.is_complex() else g)
            .all() and bool(torch.isfinite(loss)) and float(g.abs().max()) > 0):
        raise AssertionError(f"{label}: gradient not finite or zero")
    if int(c2.overflow) != 0:
        raise AssertionError(f"{label}: march overflow {int(c2.overflow)}")
    return dict(forward_ms=e0.elapsed_time(e1), backward_ms=e1.elapsed_time(e2),
                fwd_bwd_ms=e0.elapsed_time(e2), peak_memory_bytes=peak,
                peak_above_start_bytes=peak - base,
                grad_abs_max=float(g.abs().max()), loss=float(loss.detach()),
                launches=launches)


def march_backward_plain(s, carry):
    """The march's backward at the main shape, alone: autograd through
    march_gathered_reference on the saved inputs (mw._march_backward, what
    fused_march_gathered's backward runs; there is no backward kernel, as
    in the JAX package), w.r.t. both window arrays and the packets (the
    flow gradient) and w.r.t. the packets alone. Median of 3 between CUDA
    events after one warm-up, and the peak bytes above its inputs."""
    spec = s.march
    win1 = carry.prev_win.detach()
    win2 = win1.clone()
    xk = torch.cat([carry.packet_x, carry.packet_k]).detach()
    oi, oj = mw.packet_cells(xk[0], xk[1], spec)
    ct = torch.randn(xk.shape, dtype=xk.dtype, device=xk.device,
                     generator=torch.Generator(xk.device).manual_seed(5))
    out = {}
    for name, needs in (("windows_and_packets", (True, True, True)),
                        ("packets", (False, False, True))):
        ctx = types.SimpleNamespace(
            saved_tensors=(win1, win2, xk, oi, oj), sub_dt=s.dt / 2,
            spec=spec, needs_input_grad=(*needs, False, False, False, False))
        fn = lambda: mw._march_backward(ctx, mw.march_gathered_reference, ct)
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if not all(bool(torch.isfinite(g).all()) for g in grads
                   if g is not None):
            raise AssertionError("march_backward_plain: not finite")
        del grads
        out[name] = dict(ms=cuda_ms(fn, 3), peak_above_inputs_bytes=peak)
    return dict(out, route="plain (autograd through march_gathered_reference)",
                shapes=dict(win=list(win1.shape), xk=list(xk.shape)))


def grad_r05_dt():
    return float(GRAD_R05_DTPIN.read_text())


def grad_r05_reference():
    """The JAX package's float64 CPU adjoints dL/da at 50 and 250 steps."""
    data = json.loads(GRAD_R05_JSON.read_text())["horizon_ad"]
    return {int(n): row["cpu64_ad"] for n, row in data.items()}


def grad_r05_run(dtype, dev):
    """GRAD_r05's matched configuration on the card in `dtype`: dL/da by
    autograd through run_coupled_chunk(remat=True) at 50 and 250 flow
    steps (seconds of the forward alone and of forward + backward, host
    clock to a synchronisation, after a one-save warm-up), and in float64
    the central difference at 50 steps."""
    cfg = CoupledConfig(**GRAD_R05)
    s, carry0 = setup_coupled(cfg, device=dev, dtype=dtype)
    if s.march is None:
        raise AssertionError("GRAD_r05: the march must be engaged")
    s = s._replace(dt=grad_r05_dt())
    real = carry0.flow_state.qk.real.dtype

    def loss(a, n_saves):
        qk = a.to(real) * carry0.flow_state.qk
        c = dataclasses.replace(carry0, flow_state=dataclasses.replace(
            carry0.flow_state, qk=qk))
        c2, _ = run_coupled_chunk(c, s, cfg, n_saves, remat=True)
        if int(c2.overflow) != 0:
            raise AssertionError(f"GRAD_r05: march overflow "
                                 f"{int(c2.overflow)}")
        om = torch.sqrt(cfg.f ** 2 + cfg.Cg ** 2 * (c2.packet_k[0] ** 2
                                                    + c2.packet_k[1] ** 2))
        return torch.var(om, correction=0)

    one = torch.tensor(1.0, dtype=torch.float64, device=dev)
    with torch.no_grad():
        float(loss(one, 1))        # warm-up: cuFFT plans at this shape
    rows = {}
    for n_saves in GRAD_R05_SAVES:
        steps = n_saves * cfg.packet_steps_per_save
        t0 = time.perf_counter()
        with torch.no_grad():
            L = float(loss(one, n_saves))
        forward_s = time.perf_counter() - t0
        a = one.clone().requires_grad_(True)
        t0 = time.perf_counter()
        (g,) = torch.autograd.grad(loss(a, n_saves), a)
        g = float(g)
        rows[steps] = dict(loss=L, dloss_da_ad=g, forward_s=forward_s,
                           fwd_plus_bwd_s=time.perf_counter() - t0)
        if not np.isfinite(g) or g == 0.0:
            raise AssertionError(f"GRAD_r05 {dtype} {steps}: dL/da = {g}")
    if dtype == torch.float64:
        eps = GRAD_R05_FD_EPS
        with torch.no_grad():
            fd = (float(loss(one + eps, GRAD_R05_SAVES[0]))
                  - float(loss(one - eps, GRAD_R05_SAVES[0]))) / (2 * eps)
        row = rows[GRAD_R05_SAVES[0] * cfg.packet_steps_per_save]
        row.update(dloss_da_fd=fd, fd_eps=eps,
                   ad_vs_fd_rel=abs(row["dloss_da_ad"] - fd) / abs(fd))
    return dict(dt=s.dt, rows=rows)


def phase_grad_path(dev):
    """The differentiable path on the card, the launch counts set to 0 just
    before and read just after: (a) the two-layer main path's
    configuration at full width, one flow step and a chunk of 5, each
    rematerialised and not, differentiated w.r.t. the packets' wavevectors
    and w.r.t. the PV spectrum (the flow gradient: K2 runs again in the
    backward); the march's plain backward alone; one flow-gradient step of
    the one-layer model with the one-pass window build (K3). (b) GRAD_r05's
    matched configuration in float64 and float32, against its own finite
    difference and the JAX package's float64 adjoint."""
    reset_launches()
    t_phase = time.perf_counter()
    cfg = Coupled2Config(**FULL)
    s, carry = setup_coupled2(cfg, device=dev, dtype=torch.float32)
    with torch.no_grad():   # past the packets' release: they see the flow
        carry, _ = run_coupled2_chunk(carry, s, cfg, 1)
    if not carry.flow_state.t > s.packet_delay:
        raise AssertionError("grad_path: packets not released yet")
    two_layer = {}
    for steps in GRAD_STEPS:
        for wrt in ("packet_k", "qk"):
            for remat in (False, True):
                two_layer[f"{steps}_steps_d_{wrt}_remat_{remat}"] = \
                    differentiate(run_coupled2_chunk, s, cfg, carry, steps,
                                  wrt, remat, "transpose")
    peaks = {}
    for wrt in ("packet_k", "qk"):
        plain = two_layer[f"5_steps_d_{wrt}_remat_False"]
        remat = two_layer[f"5_steps_d_{wrt}_remat_True"]
        peaks[wrt] = dict(plain=plain["peak_memory_bytes"],
                          remat=remat["peak_memory_bytes"],
                          remat_below_plain_by_bytes=(
                              plain["peak_memory_bytes"]
                              - remat["peak_memory_bytes"]))
        if not remat["peak_memory_bytes"] < plain["peak_memory_bytes"]:
            raise AssertionError(f"grad_path: remat's peak over 5 steps "
                                 f"(d/d{wrt}) is not below the plain "
                                 f"run's: {peaks[wrt]}")
    plain_bwd = march_backward_plain(s, carry)
    step_bwd = two_layer["1_steps_d_qk_remat_False"]["backward_ms"]
    plain_bwd["share_of_one_step_flow_gradient_backward"] = (
        plain_bwd["windows_and_packets"]["ms"] / step_bwd)
    del s, carry
    cfg1 = CoupledConfig(march_fused_build=True, **FULL)
    s1, carry1 = setup_coupled(cfg1, device=dev, dtype=torch.float32)
    with torch.no_grad():
        carry1, _ = run_coupled_chunk(carry1, s1, cfg1, 1)
    one_layer = differentiate(run_coupled_chunk, s1, cfg1, carry1, 1, "qk",
                              False, "build_windows")
    del s1, carry1
    full_width_s = time.perf_counter() - t_phase

    ref = grad_r05_reference()
    r05 = {name: grad_r05_run(dtype, dev)
           for name, dtype in (("float64", torch.float64),
                               ("float32", torch.float32))}
    checks = {}
    for steps, want in sorted(ref.items()):
        g64 = r05["float64"]["rows"][steps]["dloss_da_ad"]
        g32 = r05["float32"]["rows"][steps]["dloss_da_ad"]
        checks[steps] = dict(jax_cpu64_ad=want, rel_float64_vs_jax=abs(
            g64 - want) / abs(want), rel_float32_vs_float64=abs(g32 - g64)
            / abs(g64))
        if not checks[steps]["rel_float64_vs_jax"] <= GRAD_R05_JAX_RTOL[steps]:
            raise AssertionError(f"GRAD_r05 {steps} steps: float64 {g64} "
                                 f"against the JAX package's {want}")
        if not checks[steps]["rel_float32_vs_float64"] <= GRAD_R05_F32_RTOL:
            raise AssertionError(f"GRAD_r05 {steps} steps: float32 {g32} "
                                 f"against float64 {g64}")
    fd_rel = r05["float64"]["rows"][50]["ad_vs_fd_rel"]
    if not fd_rel <= GRAD_R05_FD_RTOL:
        raise AssertionError(f"GRAD_r05: float64 AD against FD {fd_rel}")
    launches = read_launches()
    for name in ("march", "transpose", "build_windows"):
        if launches[name] < 1:
            raise AssertionError(f"grad_path launched no {name}")
    emit("grad_path", config=dict(FULL, dtype="float32", model="two-layer"),
         two_layer=two_layer, remat_peak_5_steps=peaks,
         march_backward_plain=plain_bwd,
         one_layer_fused_build_1_step_d_qk=one_layer,
         full_width_seconds=full_width_s,
         grad_r05=dict(config=GRAD_R05, dt_pin=grad_r05_dt(), runs=r05,
                       checks=checks, rtol=dict(
                           fd=GRAD_R05_FD_RTOL, jax=GRAD_R05_JAX_RTOL,
                           float32=GRAD_R05_F32_RTOL)),
         launches=launches,
         transpose_launches_by_direction=dict(
             mw.transpose_cuda.launches_by_direction),
         seconds=time.perf_counter() - t_phase)
    return launches, dict(mw.transpose_cuda.launches_by_direction)


# ---------------------------------------------------------------------------
# the analytic and spectral evaluators
# ---------------------------------------------------------------------------

ANALYTIC = dict(n_packets=2 ** 20, dt=0.01, steps=500, save_every=100,
                cpu_packets=4096, atol=1e-9)
REVERSIBLE = dict(n_packets=2 ** 14, dt=0.01, steps=(250, 1000))
GRIDDED = dict(nx=512, n_packets=2 ** 20, dt=1e-3, steps=20, Kd2=3.0)


@contextlib.contextmanager
def window_threshold_at(n_packets):
    """raytrace_frozen's switch to prebuilt windows moved to `n_packets`
    for the duration (a measurement of the path it switches away from)."""
    old = interp._WINDOW_MIN_NP
    interp._WINDOW_MIN_NP = n_packets
    try:
        yield
    finally:
        interp._WINDOW_MIN_NP = old


def synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def reversible_vs_plain(dev, disp, steps):
    """dL/dU0 and dL/dk0 after `steps` symplectic steps of 2^14 packets
    through the Childress–Soward flow in float64, by the O(1)-memory
    integrator and by plain autograd through the loop, each with its
    seconds and its peak bytes above the inputs."""
    x0, k0 = ring_ics(REVERSIBLE["n_packets"], 2.0, disp, device=dev,
                      dtype=torch.float64)
    dt = REVERSIBLE["dt"]
    out = {}
    for name in ("reversible", "plain"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def run():
            U0 = torch.tensor(0.12, dtype=torch.float64, device=dev,
                              requires_grad=True)
            k = k0.clone().requires_grad_(True)
            flow = childress_soward(U0=U0, device=dev, dtype=torch.float64)
            if name == "reversible":
                xN, kN = make_reversible_integrator(disp, dt, steps)(
                    x0, k, flow)
            else:
                xN, kN = x0, k
                for _ in range(steps):
                    xN, kN = rays.symplectic_step(xN, kN, dt, disp, flow)
            loss = (kN * kN).mean() + (torch.sin(xN) ** 2).mean()
            return torch.autograd.grad(loss, (U0, k))

        (gU, gk), seconds = synced_seconds(run)
        out[name] = dict(seconds=seconds, dloss_dU0=float(gU), gk=gk,
                         peak_above_inputs_bytes=(
                             torch.cuda.max_memory_allocated() - base))
    gk_r, gk_p = out["reversible"].pop("gk"), out["plain"].pop("gk")
    rel_U0 = abs(out["reversible"]["dloss_dU0"] - out["plain"]["dloss_dU0"]) \
        / abs(out["plain"]["dloss_dU0"])
    rel_k0 = float((gk_r - gk_p).abs().max() / gk_p.abs().max())
    if not (rel_U0 <= REVERSIBLE_RTOL and rel_k0 <= REVERSIBLE_RTOL):
        raise AssertionError(f"reversible against plain autograd, {steps} "
                             f"steps: U0 {rel_U0}, k0 {rel_k0}")
    return dict(out, rel_dU0=rel_U0, rel_dk0_max_over_max=rel_k0)


def phase_analytic_path(dev):
    """The analytic and spectral evaluators on the card, the launch counts
    set to 0 just before and read just after (no kernel of the port
    runs): raytrace_frozen through the Childress–Soward flow at 2^20
    packets against the same run of the first 4096 packets on the CPU;
    the O(1)-memory integrator against plain autograd; raytrace_frozen
    through a gridded 512^2 snapshot through prebuilt windows (its switch
    from interp._WINDOW_MIN_NP packets, as the JAX package's) and through
    the stencil (the switch moved past the packet count), the reading the
    switch was taken by; interpolate_cubic and the direct spectral evaluation
    against the CPU."""
    reset_launches()
    t_phase = time.perf_counter()
    disp = Dispersion(f=3.0, Cg=1.0)
    f64 = torch.float64
    # (1) analytic frozen run, float64
    n_p, dt, steps, every = (ANALYTIC[k] for k in ("n_packets", "dt", "steps",
                                                   "save_every"))
    x0, k0 = ring_ics(n_p, 2.0, disp, device=dev, dtype=f64)
    flow = childress_soward(device=dev, dtype=f64)
    res, frozen_s = synced_seconds(lambda: raytrace_frozen(
        flow, x0, k0, disp, dt, steps, save_every=every))
    n_c = ANALYTIC["cpu_packets"]
    res_c = raytrace_frozen(childress_soward(device="cpu", dtype=f64),
                            x0[:, :n_c].cpu(), k0[:, :n_c].cpu(), disp, dt,
                            steps, save_every=every)
    err_x = float((res.x[..., :n_c].cpu() - res_c.x).abs().max())
    err_k = float((res.k[..., :n_c].cpu() - res_c.k).abs().max())
    if not max(err_x, err_k) <= ANALYTIC["atol"]:
        raise AssertionError(f"analytic frozen run, card against CPU: "
                             f"x {err_x}, k {err_k}")
    cons = float(res.conservation_error[-1])
    if not (np.isfinite(cons) and cons < 1e-2
            and bool(torch.isfinite(res.x).all())):
        raise AssertionError(f"analytic frozen run: conservation error "
                             f"{cons}")
    moved = float((res.x[-1] - x0).abs().max())
    analytic_run = dict(n_packets=n_p, dt=dt, steps=steps, dtype="float64",
                        seconds=frozen_s,
                        packet_steps_per_s=n_p * steps / frozen_s,
                        conservation_error_last=cons,
                        max_packet_displacement=moved,
                        card_vs_cpu_first_packets=n_c,
                        max_abs_dx=err_x, max_abs_dk=err_k,
                        atol=ANALYTIC["atol"])
    del res, x0, k0
    # (2) the reversible integrator against plain autograd
    reversible = {n: reversible_vs_plain(dev, disp, n)
                  for n in REVERSIBLE["steps"]}
    short, long_ = (reversible[n]["reversible"]["peak_above_inputs_bytes"]
                    for n in REVERSIBLE["steps"])
    if not long_ <= 1.1 * short:
        raise AssertionError(f"the reversible integrator's peak grows with "
                             f"the steps: {short} -> {long_} bytes")
    # (3) a gridded snapshot through the stencil and through windows
    grid = SpectralGrid.square(GRIDDED["nx"])
    qk = qg.initial_q_ring(146, grid, 0.4, GRIDDED["Kd2"], device=dev,
                           dtype=torch.float32)
    gflow = flow_from_qk(qk, grid, GRIDDED["Kd2"])
    gx0, gk0 = ring_ics(GRIDDED["n_packets"], 2.0, disp, device=dev,
                        dtype=torch.float32)
    gdt, gsteps = GRIDDED["dt"], GRIDDED["steps"]
    # raytrace_frozen builds the windows itself from
    # interp._WINDOW_MIN_NP packets on (timed with the run); the stencil
    # run raises that threshold past the packet count
    if GRIDDED["n_packets"] < interp._WINDOW_MIN_NP:
        raise AssertionError("gridded frozen run: below the window switch")
    stencil_only = GRIDDED["n_packets"] + 1
    ways = {"stencil": lambda: window_threshold_at(stencil_only),
            "windowed": contextlib.nullcontext}
    gridded = {}
    finals = {}
    for name in ("stencil", "windowed", "windowed", "stencil"):
        def run():
            with ways[name]():
                return raytrace_frozen(gflow, gx0, gk0, disp, gdt, gsteps,
                                       save_every=gsteps)
        if name not in finals:
            run()                                      # warm-up
        torch.cuda.reset_peak_memory_stats()
        r, seconds = synced_seconds(run)
        finals[name] = (r.x[-1], r.k[-1])
        gridded.setdefault(name, dict(seconds=[], peak_memory_bytes=0))
        gridded[name]["seconds"].append(seconds)
        gridded[name]["peak_memory_bytes"] = max(
            gridded[name]["peak_memory_bytes"],
            torch.cuda.max_memory_allocated())
    dx = float((finals["windowed"][0] - finals["stencil"][0]).abs().max())
    dk = float((finals["windowed"][1] - finals["stencil"][1]).abs().max())
    if not max(dx, dk) <= 1e-4:
        raise AssertionError(f"gridded frozen run, windowed against "
                             f"stencil: x {dx}, k {dk}")
    best = {n: min(v["seconds"]) for n, v in gridded.items()}
    gridded_run = dict(GRIDDED, dtype="float32", ways=gridded,
                       windowed_over_stencil=best["windowed"]
                       / best["stencil"],
                       faster="windowed" if best["windowed"]
                       < best["stencil"] else "stencil",
                       max_abs_dx=dx, max_abs_dk=dk)
    del gflow, gx0, gk0, finals
    # (4) interpolate_cubic and the direct spectral evaluation, card vs CPU
    rng = np.random.default_rng(17)
    cgrid = SpectralGrid.square(512)
    F = torch.as_tensor(smooth_fields(rng, 2, 512), dtype=f64)
    px = torch.as_tensor(rng.uniform(-7.0, 14.0, (2, 2 ** 16)), dtype=f64)
    cub = [interpolate_cubic(F.to(d), px[0].to(d), px[1].to(d), cgrid)
           for d in (dev, "cpu")]
    cubic_err = float((cub[0].cpu() - cub[1]).abs().max())
    ngrid = SpectralGrid.square(64)
    fk = sp.to_spectral(torch.as_tensor(smooth_fields(rng, 1, 64)[0],
                                        dtype=f64), ngrid)
    npx = torch.as_tensor(rng.uniform(-7.0, 14.0, (2, 4096)), dtype=f64)
    spec = [eval_spectrum_and_grad_at(fk.to(d), npx[0].to(d), npx[1].to(d),
                                      ngrid) for d in (dev, "cpu")]
    spec_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                   for a, b in zip(*spec))
    if not (cubic_err <= 1e-12 and spec_err <= 1e-12):
        raise AssertionError(f"card against CPU: interpolate_cubic "
                             f"{cubic_err}, eval_spectrum_and_grad_at "
                             f"{spec_err}")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"analytic_path launched a kernel: {launches}")
    emit("analytic_path", analytic_frozen=analytic_run,
         reversible=reversible, gridded_frozen=gridded_run,
         card_vs_cpu=dict(
             interpolate_cubic=dict(grid=512, points=2 ** 16,
                                    max_abs_err=cubic_err),
             eval_spectrum_and_grad_at=dict(grid=64, points=4096,
                                            max_rel_err=spec_err)),
         launches=launches, seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# the remaining solvers (RSW family, 1-D, C-grid, QG particles, RSW restart)
# ---------------------------------------------------------------------------

# Card against CPU, float64, at the test sizes. Each output is held to
# SOLVERS_ATOL where its values are O(1) or less, relative to its largest
# value otherwise (swknd's pe sums 64^2 values of ~50).
SOLVERS_SMALL = dict(nx=64, n=128)
SOLVERS_ATOL = 1e-9
# Full width: 512^2, steps cut to keep the phase within a minute.
SOLVERS_FULL = dict(nx=512, swk_steps=500, swk_every=100, tc_steps=200,
                    packets=2 ** 20, ray_dt=1e-3, ray_steps=100,
                    ray_every=50, particles=2 ** 20, qg_steps=100,
                    swp_steps=500)


def leaves(tree):
    """The tensors of a nested tuple / list / dict (None skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in leaves(item)]
    if isinstance(tree, (rsw.RSWState, qg.QGState)):
        return leaves([tree.Sk if isinstance(tree, rsw.RSWState)
                       else tree.qk, tree.t])
    return []


def card_vs_cpu_errs(card, cpu):
    """Per output, |card - cpu| at its largest, relative to the output's
    largest value where that is above 1."""
    a, b = leaves(card), leaves(cpu)
    if len(a) != len(b) or not a:
        raise AssertionError(f"card and CPU runs differ in outputs: "
                             f"{len(a)} / {len(b)}")
    errs = []
    for x, y in zip(a, b):
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"card {x.shape} {x.dtype}, CPU {y.shape} "
                                 f"{y.dtype}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("a card output is not finite")
        scale = max(1.0, float(y.abs().max())) if y.numel() else 1.0
        errs.append(float((x - y).abs().max()) / scale if x.numel() else 0.0)
    return errs


def solver_cases():
    """name -> fn(device) running one solver entry point in float64 at
    the test sizes, from inputs made once on the host."""
    nx, n = SOLVERS_SMALL["nx"], SOLVERS_SMALL["n"]
    grid = SpectralGrid.square(nx)
    f, cg = 3.0, 1.0
    (u, v, h), _ = examples.wave_and_geostrophic_spectrum_ic(grid, f, cg)
    f64 = torch.float64
    rng = np.random.default_rng(23)
    xp0 = rng.uniform(0.0, 2 * np.pi, (2, 64))
    k0 = 2.0 * rng.standard_normal((2, 64))

    def rsw_run(kw, background=None):
        p = rsw.RSWParams(f=f, Cg=cg, **kw)

        def run(dev):
            if background == "zero":
                z = torch.zeros(grid.shape, dtype=f64, device=dev)
                bg = lambda t: (z, z)              # noqa: E731
            elif background == "tc":
                bg = examples.translating_cs_background(grid, f, cg)
            else:
                bg = None
            st = rsw.rsw_init(u, v, h, grid, p, device=dev, dtype=f64)
            return rsw.simulate_rsw(st, grid, p, 40, 10, background_fn=bg)
        return run

    pu, pv, ph = plane_wave_ic(grid, 1.0, 1.0, 2, 1, eta0=0.05)
    _, U1 = examples_1d.plane_wave_1d(n, 1.0, 1.0, 0.05, 6)
    x1 = np.linspace(0, 2 * np.pi, n, endpoint=False)
    U2 = np.stack([0.2 * np.cos(2 * x1), 0.1 * np.sin(x1),
                   0.1 * np.cos(x1)], axis=1)
    _, U3 = examples_1d.sw1setup_wave(n=int(np.log2(n)) - 1)
    A0 = np.exp(1j * x1) + 0.3 * np.exp(2j * x1)
    X, Y = grid.meshgrid()
    h_swp = 0.05 * np.exp(-((X - 3) ** 2 + (Y - 3) ** 2))
    hb = 0.1 * np.cos(X) * np.cos(Y)
    swp_p = cgrid.SWPParams(Roi=1.0, Beta=0.5, Cg=1.0, Nu=0.01,
                            periody=False)
    qgp = qg.QGParams(Kd2=3.0, dt=2e-3, beta=0.5)
    disp = Dispersion(f=f, Cg=cg)
    return {
        "swk": rsw_run({}),
        "swkU": rsw_run({}, "zero"),
        "swkU_tc": rsw_run({}, "tc"),
        "killpv": rsw_run(dict(killpv=True), "zero"),
        "pv_damp": rsw_run(dict(pv_damp_rate=0.1), "zero"),
        "swks": rsw_run(dict(bernoulli_half=False)),
        "swknd": lambda dev: rsw.swknd(pu, pv, ph, 0.1, 0.7, 30, 10,
                                       np_particles=8, device=dev,
                                       dtype=f64),
        "sw1": lambda dev: sw1d.sw1(U1, sw1d.SW1Params(f=1.0, Cg=1.0), 200,
                                    50, Xp0=np.linspace(-3, 3, 16),
                                    device=dev, dtype=f64),
        "sw1_forced": lambda dev: sw1d.sw1_forced(
            U2, 0.05, 0.8, 0.3, 2, 2e-3, 200, 50, device=dev, dtype=f64),
        "sw1rk3nu": lambda dev: sw1d.sw1rk3nu(U3, 0.3, 1.0, 1e-12, 200, 50,
                                              device=dev, dtype=f64),
        "ybj1d": lambda dev: sw1d.ybj1d(A0, 0.5, 0.4, 2, 1e-3, 400, 100,
                                        device=dev),
        "swp": lambda dev: cgrid.swp(u * 0.1, v * 0.1, h_swp, swp_p, hb=hb,
                                     nt=60, save_every=20, device=dev),
        "qg_particles": lambda dev: qg.simulate_qg_particles(
            qg.qg_init(qg.initial_q_ring(5, grid, 0.4, 3.0, device=dev,
                                         dtype=f64)),
            torch.as_tensor(xp0, dtype=f64, device=dev), grid, qgp, 30, 10),
        "rsw_restart": lambda dev: raytrace_rsw_restart(
            u, v, h, disp, grid, xp0, k0, dt=2e-3, nsteps=40, save_every=10,
            device=dev, dtype=f64),
        "wave_vortex_spectra": lambda dev: rsw.wave_vortex_spectra(
            *(torch.as_tensor(a, dtype=f64, device=dev) for a in (u, v, h)),
            grid, rsw.RSWParams(f=f, Cg=cg)),
    }


def event_timed(fn):
    """fn()'s output, its CUDA-event ms (the card's span from the first
    launch to the last) and the host's seconds to enqueue it (a host-bound
    run enqueues in about the event time)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), enqueue_s


def timed_run(fn, steps):
    """A run after `fn` has run once as a warm-up: ms a step by events,
    the host's share, peak bytes."""
    torch.cuda.reset_peak_memory_stats()
    out, ms, enqueue_s = event_timed(fn)
    return out, dict(steps=steps, event_ms=ms, ms_per_step=ms / steps,
                     host_enqueue_ms=1e3 * enqueue_s,
                     peak_memory_bytes=torch.cuda.max_memory_allocated())


def device_share(fn, steps):
    """One call of fn (`steps` steps) under torch.profiler: the host's
    wall time a step, the card's busy time a step (the kernels', copies'
    and memsets' own times summed; one stream, so nothing overlaps), the
    idle share of the wall time, and the device operations and aten calls
    a step. The profiler's own cost on the host is in the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = 1e-6 * sum(e.self_device_time_total for e in on_card)
    return dict(steps=steps, wall_ms_per_step=1e3 * wall / steps,
                device_busy_ms_per_step=1e3 * busy / steps,
                device_idle_share=1.0 - busy / wall,
                device_ops_per_step=sum(e.count for e in on_card) / steps,
                aten_calls_per_step=sum(e.count for e in events
                                        if e.key.startswith("aten::"))
                / steps)


def swk_512(dev, grid, ic):
    """The nonlinear RSW at 512^2 in float32 (timed) and float64, and a
    step-by-step rerun collecting each dt."""
    F = SOLVERS_FULL
    p = rsw.RSWParams(f=3.0, Cg=1.0)
    steps, every = F["swk_steps"], F["swk_every"]
    st32 = rsw.rsw_init(*ic, grid, p, device=dev, dtype=torch.float32)
    rsw.simulate_rsw(st32, grid, p, 10, 10)                   # warm-up
    (st, S, ts, ke, pe), run = timed_run(
        lambda: rsw.simulate_rsw(st32, grid, p, steps, every), steps)
    u0, v0, h0 = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in ic)
    E0 = sum(float(e) for e in rsw.energy(u0, v0, h0, p))
    E = (ke + pe).double().cpu().numpy()
    drift = float(np.abs(E - E0).max() / E0)
    blown = bool(st.blown)
    if blown or not bool(torch.isfinite(S).all()) or not drift < 1e-2:
        raise AssertionError(f"swk_512: blown {blown}, energy drift {drift}")
    if S.dtype != torch.float32 or st.Sk.dtype != torch.complex64:
        raise AssertionError(f"swk_512 float32 run: {S.dtype} {st.Sk.dtype}")
    st64 = rsw.rsw_init(*ic, grid, p, device=dev, dtype=torch.float64)
    (st64, S64, ts64, _, _), run64 = timed_run(
        lambda: rsw.simulate_rsw(st64, grid, p, steps, steps), steps)
    h32, h64 = S[-1, 2].double(), S64[-1, 2]
    h_rel = float((h32 - h64).abs().max() / h64.abs().max())
    t_gap64 = float(ts[-1] - ts64[-1])
    # the same steps one by one through rsw_step, every dt kept
    filters = rsw._filter_tensors(rsw.rsw_filters(grid, p), st32.Sk)
    s1, dts = st32, []
    for _ in range(steps):
        s1 = rsw.rsw_step(s1, grid, p, filters)
        dts.append(s1.dt)
    dts = torch.stack(dts)
    same = bool(torch.equal(s1.Sk, st.Sk))
    t64 = float(torch.cumsum(dts.double(), 0)[-1])
    t32 = float(torch.cumsum(dts, 0)[-1])           # as a float32 t would
    if not (same and float(st.t) == t64):
        raise AssertionError(f"swk_512: t {float(st.t)} against the float64 "
                             f"sum of its dts {t64}; rerun equal: {same}")
    profiled = device_share(lambda: rsw.simulate_rsw(st32, grid, p, 20, 20),
                            20)
    return st, dict(
        run, dtype="float32", frames=int(S.shape[0]), profiled=profiled,
        energy_drift_max=drift, energy_first=E0, energy_last=float(E[-1]),
        blown=blown, t_end=float(st.t), dt_last=float(st.dt),
        float64_run=run64, h_float32_vs_float64_rel_max=h_rel,
        t_float32_run_minus_float64_run=t_gap64,
        t_minus_float64_sum_of_dts=float(st.t) - t64,
        float32_sum_of_dts_minus_float64_sum=t32 - t64,
        rerun_by_rsw_step_bit_equal=same)


def phase_solvers_path(dev):
    """The solvers of A13 on the card, the launch counts set to 0 just
    before the full-width runs and read just after (no kernel of the port
    runs): (a) every entry point on the card against the CPU in float64 at
    the test sizes; (b) the full-width runs of SOLVERS_FULL, each timed by
    CUDA events after a warm-up, with peak bytes."""
    t_phase = time.perf_counter()
    # (a) card against CPU
    small = {name: card_vs_cpu_errs(fn(dev), fn("cpu"))
             for name, fn in solver_cases().items()}
    over = {name: errs for name, errs in small.items()
            if not max(errs) <= SOLVERS_ATOL}
    if over:
        raise AssertionError(f"solvers_path, card against CPU (each "
                             f"output's error): {over}")
    small = {name: max(errs) for name, errs in small.items()}
    seconds_small = time.perf_counter() - t_phase
    # (b) full width
    reset_launches()
    F = SOLVERS_FULL
    grid = SpectralGrid.square(F["nx"])
    disp = Dispersion(f=3.0, Cg=1.0)
    ic, _ = examples.wave_and_geostrophic_spectrum_ic(grid, 3.0, 1.0)
    st, swk = swk_512(dev, grid, ic)
    # swkU_tc about the translating Childress-Soward background
    p = rsw.RSWParams(f=3.0, Cg=1.0)
    bg = examples.translating_cs_background(grid, 3.0, 1.0)
    tc0 = rsw.rsw_init(*ic, grid, p, device=dev, dtype=torch.float32)
    rsw.simulate_rsw(tc0, grid, p, 5, 5, background_fn=bg)    # warm-up
    n_tc = F["tc_steps"]
    (tst, TS, _, _, _), tc_run = timed_run(
        lambda: rsw.simulate_rsw(tc0, grid, p, n_tc, n_tc, background_fn=bg),
        n_tc)
    if bool(tst.blown) or not bool(torch.isfinite(TS).all()):
        raise AssertionError("swkU_tc_512 blew up")
    tc_run.update(dtype="float32", t_end=float(tst.t))
    # raytrace_rsw_restart through the final state of swk_512
    uvh = sp.to_grid(st.Sk, grid)
    n_p, rdt = F["packets"], F["ray_dt"]
    x0, k0 = ring_ics(n_p, 2.0, disp, device=dev, dtype=torch.float32)
    raytrace_rsw_restart(*uvh, disp, grid, x0[:, :4096], k0[:, :4096],
                         dt=rdt, nsteps=2, save_every=2, device=dev)
    (xs, ks, as_, _), ray = timed_run(
        lambda: raytrace_rsw_restart(*uvh, disp, grid, x0, k0, dt=rdt,
                                     nsteps=F["ray_steps"],
                                     save_every=F["ray_every"], device=dev),
        F["ray_steps"])
    amin, amax = float(as_.min()), float(as_.max())
    if not (bool(torch.isfinite(xs).all() & torch.isfinite(ks).all())
            and 0.1 < amin <= amax < 10.0):
        raise AssertionError(f"rsw_restart_512: action in [{amin}, {amax}]")
    ray["profiled"] = device_share(
        lambda: raytrace_rsw_restart(*uvh, disp, grid, x0, k0, dt=rdt,
                                     nsteps=5, save_every=5, device=dev), 5)
    ray.update(dtype="float32", packets=n_p, dt=rdt,
               packet_steps_per_s=n_p * F["ray_steps"] / (ray["event_ms"]
                                                          / 1e3),
               action_min=amin, action_max=amax,
               max_packet_displacement=float((xs[-1] - x0).abs().max()))
    del xs, ks, as_, x0, k0, uvh, st
    # QG with passive particles, the one-layer main path's state
    s1, c1 = setup_coupled(CoupledConfig(**FULL), device=dev)
    rng = np.random.default_rng(31)
    xp = torch.as_tensor(rng.uniform(0.0, s1.grid.Lx, (2, F["particles"])),
                         dtype=torch.float32, device=dev)
    qg.simulate_qg_particles(c1.flow_state, xp[:, :4096], s1.grid,
                             s1.qg_params, 2, 2)                # warm-up
    n_qg = F["qg_steps"]
    (qst, xq, _, _), qgr = timed_run(
        lambda: qg.simulate_qg_particles(c1.flow_state, xp, s1.grid,
                                         s1.qg_params, n_qg, n_qg), n_qg)
    if not bool(torch.isfinite(xq).all() & torch.isfinite(qst.qk).all()):
        raise AssertionError("qg_particles_512: not finite")
    qgr["profiled"] = device_share(
        lambda: qg.simulate_qg_particles(c1.flow_state, xp, s1.grid,
                                         s1.qg_params, 5, 5), 5)
    qgr.update(dtype="float32", particles=F["particles"],
               Kd2=s1.qg_params.Kd2, dt=s1.qg_params.dt, U_g=FULL["U_g"],
               particle_steps_per_s=F["particles"] * n_qg
               / (qgr["event_ms"] / 1e3),
               max_particle_displacement=float((xq - xp).abs().max()))
    del s1, c1, xp, xq, qst
    # the C-grid model in float64: walls on y, beta, topography (the JAX
    # package's tests/test_cgrid.py walls-and-topography configuration)
    X, Y = grid.meshgrid()
    h0 = 0.01 * np.cos(X)
    hb = 0.05 * np.exp(-((X - np.pi) ** 2 + (Y - np.pi) ** 2))
    swp_p = cgrid.SWPParams(Roi=2.0, Beta=0.1, Cg=1.0, Drag=0.01,
                            periody=False, Nu=0.1)
    z = np.zeros(grid.shape)
    cgrid.swp(z, z, h0, swp_p, hb=hb, nt=5, save_every=5,
              device=dev)                                      # warm-up
    n_swp = F["swp_steps"]
    (us, vs, hs, ts_swp, ke_s, ape_s, htot), swp_run = timed_run(
        lambda: cgrid.swp(z, z, h0, swp_p, hb=hb, nt=n_swp,
                          save_every=n_swp, device=dev), n_swp)
    swp_run["profiled"] = device_share(
        lambda: cgrid.swp(z, z, h0, swp_p, hb=hb, nt=20, save_every=20,
                          device=dev), 20)
    htot0 = float(np.sum(h0 - hb))
    mass = abs(float(htot[-1]) - htot0) / abs(htot0)
    if not (bool(torch.isfinite(hs).all()) and mass < 1e-10):
        raise AssertionError(f"swp_512: mass drift {mass}")
    swp_run.update(dtype="float64", params=swp_p._asdict(),
                   topography="0.05 exp(-|x - (pi, pi)|^2)",
                   htot_first=htot0,
                   htot_last=float(htot[-1]), mass_drift_rel=mass,
                   t_end=float(ts_swp[-1]))
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"solvers_path launched a kernel: {launches}")
    emit("solvers_path", card_vs_cpu=dict(SOLVERS_SMALL, dtype="float64",
                                          atol=SOLVERS_ATOL, max_err=small,
                                          seconds=seconds_small),
         swk_512=swk, swkU_tc_512=tc_run, rsw_restart_512=ray,
         qg_particles_512=qgr, swp_512=swp_run, launches=launches,
         seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# several ranks: packets and members sharded over torch.distributed ranks
# ---------------------------------------------------------------------------

# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# device); the production backend, NCCL, runs at world size 1.
MULTIRANK_WORLD = 2
MULTIRANK_SWEEP_STEPS = 100   # Run I's sweep cut to one chunk
MULTIRANK_TIMEOUT_S = 240     # a rank's collectives; the parent's wait twice
# two ranks against one: the largest difference of a packet coordinate
# relative to the largest coordinate (a packet's arithmetic does not depend
# on the other packets, so 0 is expected)
MULTIRANK_REL = 1e-6


def mesh_sweep(base, max_steps, mesh=None, resume=False, **kw):
    """Run I's sweep as run_sweep(ensemble=True) runs it (ENSEMBLE, with
    its cuts), a checkpoint every chunk; on `mesh` when one is given."""
    carry, _ = drivers.run_sweep(
        ENSEMBLE_SWEEP, base_dir=str(base), ensemble=True,
        member_ids=ENSEMBLE_IDS, T_member=lambda w0, ug: ENSEMBLE_T,
        max_steps=max_steps, checkpoint_every=1, resume=resume, mesh=mesh,
        verbose=False, **ENSEMBLE, **kw)
    return carry


def sharded_coupled(cfg, setup, run_chunk, mesh, n_chunks):
    """A coupled model at full width on a mesh, as drive_coupled drives it
    on one card: this rank's packets (the flow whole), two warm-up chunks
    and n_chunks timed by CUDA events and the host clock, each chunk
    ending in the overflow's MAX over the ranks. mesh=None: the same chunks
    unsharded, as main_path runs them. Returns (carry with this rank's
    packets, timing)."""
    s, carry = setup(cfg, dtype=torch.float32)   # device=None: the card
    if mesh is None:
        def chunk(c):
            return run_chunk(c, s, cfg, 1)
    else:
        carry = shd.shard_carry(carry, mesh)

        def chunk(c):
            return shd.run_sharded_chunk(run_chunk, c, s, cfg, 1, mesh)
    for _ in range(2):
        carry, _ = chunk(carry)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_chunks):
        carry, _ = chunk(carry)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = n_chunks * cfg.packet_steps_per_save
    n_local = carry.packet_x.shape[-1]
    seconds = start.elapsed_time(end) / 1e3
    return carry, dict(flow_steps=steps, packets_here=n_local,
                       ms_per_flow_step=1e3 * seconds / steps,
                       host_ms_per_flow_step=1e3 * wall / steps,
                       packet_steps_per_s_here=steps * n_local / seconds,
                       overflow=int(carry.overflow))


def coupled_launches(march, window, chunks):
    """What a coupled run of `chunks` chunks launches: the march once a
    flow step, the window kernel once a flow step and once for the first
    carry's windows."""
    steps = chunks * FULL["packet_steps_per_save"]
    return {march: steps, window: steps + 1}


def expected_counts(*parts):
    counts = dict.fromkeys(WRAPPERS, 0)
    for part in parts:
        for name, n in part.items():
            counts[name] += n
    return counts


# The two ranks' sweeps: Run I's members split over the ranks (a (2, 1)
# mesh), and its members whole with their packets split (a (1, 2) mesh).
MESH_SWEEPS = {"members_split": MULTIRANK_WORLD, "packets_split": 1}
# A member's flow is the same bits on any mesh; its fields are not where
# the members are split: cuFFT rounds a batch of 24 256^2 transforms (12
# members' two velocity grids) otherwise than a batch of 12 (measured on
# the card, `fft_batches` in the phase's line), so the two ranks' packets
# part from the one-rank run's at float32 round-off, and a packet whose
# frequency lies within that of a bin edge may count in the next bin: the
# share of such counts, summed over a member's frames, over its counts.
HIST_COUNT_SHARE = 1e-3


def multirank_rank(rank, world, rendezvous, out):
    """One of the ranks that share the card over gloo: the two-layer main
    path with its half of the packets, then Run I's sweep on a (world, 1)
    mesh (its members split over the ranks) and on a (1, world) mesh (each
    member's packets split). Writes its timing and launch counts (and, on
    rank 0, the gathered packets) into `out`."""
    out = Path(out)
    multihost.initialize(coordinator=f"file://{rendezvous}",
                         num_processes=world, process_id=rank,
                         device="cuda", backend="gloo",
                         timeout_s=MULTIRANK_TIMEOUT_S)
    try:
        kernels.load()   # built by the parent: this loads the library
        mesh = shd.make_mesh(ensemble=1, device_type="cuda")
        reset_launches()
        carry, timing = sharded_coupled(Coupled2Config(**FULL),
                                        setup_coupled2, run_coupled2_chunk,
                                        mesh, N_CHUNKS)
        launches_main = read_launches()
        x = shd.gather_packets(carry.packet_x, mesh).cpu().numpy()
        k = shd.gather_packets(carry.packet_k, mesh).cpu().numpy()
        if rank == 0:
            np.savez(out / "two_ranks.npz", x=x, k=k)
        del carry
        torch.cuda.empty_cache()
        reset_launches()
        for label, ensemble in MESH_SWEEPS.items():
            mesh_sweep(out / f"sweep_{label}", MULTIRANK_SWEEP_STEPS,
                       mesh=shd.make_mesh(ensemble=ensemble,
                                          device_type="cuda"))
        launches_sweep = read_launches()
        (out / f"rank{rank}.json").write_text(json.dumps(dict(
            main=timing, launches_main=launches_main,
            launches_sweep=launches_sweep,
            backend=dist.get_backend())))
    finally:
        dist.destroy_process_group()


def run_ranks(target, world, tmp):
    """The ranks as spawned processes; each its own timeout on the
    process group, the parent twice that on its wait. A rank that fails
    or hangs fails the phase."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, str(tmp / "rendezvous_gloo"),
                               str(tmp)))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + 2 * MULTIRANK_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
    if hung or failed:
        raise AssertionError(f"multirank_path: ranks {hung} hung, ranks "
                             f"{failed} failed (exit codes)")
    return time.perf_counter() - t0


def traced_chunk(label, cfg, setup, run_chunk, log_dir):
    """One chunk of a coupled model at full width, after two warm-up
    chunks, under utils.profiling.trace: the card's busy and idle shares
    of the chunk's wall time (the kernels', copies' and memsets' own
    times; one stream, so nothing overlaps; the profiler's host cost is in
    the wall time) and the five device operations that take the most."""
    s, carry = setup(cfg, dtype=torch.float32)
    for _ in range(2):
        carry, _ = run_chunk(carry, s, cfg, 1)
    torch.cuda.synchronize()
    steps = cfg.packet_steps_per_save
    with profiling.trace(log_dir, name=label) as prof:
        t0 = time.perf_counter()
        carry, _ = run_chunk(carry, s, cfg, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = 1e-6 * sum(e.self_device_time_total for e in on_card)
    top = sorted(on_card, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    return dict(flow_steps=steps, wall_ms_per_step=1e3 * wall / steps,
                device_busy_ms_per_step=1e3 * busy / steps,
                device_idle_share=1.0 - busy / wall,
                device_ops_per_step=sum(e.count for e in on_card) / steps,
                top5=[dict(name=e.key[:80],
                           ms_per_step=1e-3 * e.self_device_time_total / steps,
                           calls_per_step=e.count / steps,
                           share_of_busy=1e-6 * e.self_device_time_total
                           / busy) for e in top])


def ckpt_diff(a, b):
    """Per leaf of two checkpoints, the largest absolute difference."""
    with np.load(a) as da, np.load(b) as db:
        return {name: float(np.abs(da[name].astype(np.complex128)
                                   - db[name].astype(np.complex128)).max())
                for name in da.files if name.startswith("leaf_")}


def phase_multirank_path(dev, tmp, main, final_two, final_one):
    """Packets and members sharded over ranks (parallel/sharding.py,
    run_sweep(mesh=...)), the launch counts set to 0 just before and read
    just after, summed over the ranks:

    1. world size 1 over NCCL, in this process: the two-layer main path
       through run_sharded_chunk twice, in turns with the same chunks
       unsharded (U, S, S, U; U not counted), and the one-layer main path
       (each equal bit for bit to main_path's and main_path_qg1's runs),
       Run I's sweep on the
       1x1 mesh with the one-pass window build, and measure_packet_scaling
       at the main path's size;
    2. two ranks sharing the card over gloo, spawned: the two-layer main
       path with 2^19 packets a rank (gathered, against world 1) and Run
       I's sweep on a (2, 1) mesh, six members a rank, and on a (1, 2)
       mesh, each member's packets split;
    then, outside the counts: each sweep's histograms and times against the
    one-rank sweep's (equal, but for the members' split: HIST_COUNT_SHARE),
    each two-rank checkpoint resumed on one rank against the one-rank
    sweep resumed, and the trace of one chunk of each coupled model through
    utils.profiling.trace."""
    t_phase = time.perf_counter()
    ref_dir = tmp / "sweep_one_rank"
    mesh_sweep(ref_dir, MULTIRANK_SWEEP_STEPS)   # what the sweeps are held to
    # The host-bound step's time wanders by tens of per cent within one
    # process, so the two-layer main path's chunks run unsharded and
    # sharded in turns (U, S, S, U; the unsharded ones not counted), and
    # the sharded runs are compared with the unsharded beside them.
    cfg2 = Coupled2Config(**FULL)
    turns = {"unsharded": [], "sharded": []}
    _, timing = sharded_coupled(cfg2, setup_coupled2, run_coupled2_chunk,
                                None, N_CHUNKS)
    turns["unsharded"].append(timing["ms_per_flow_step"])
    torch.cuda.synchronize()

    reset_launches()
    multihost.initialize(coordinator=f"file://{tmp / 'rendezvous_nccl'}",
                         num_processes=1, process_id=0, device="cuda",
                         timeout_s=MULTIRANK_TIMEOUT_S)
    try:
        backend1 = dist.get_backend()
        mesh = shd.make_mesh(ensemble=1)
        for _ in range(2):
            c2, two_layer = sharded_coupled(cfg2, setup_coupled2,
                                            run_coupled2_chunk, mesh,
                                            N_CHUNKS)
            turns["sharded"].append(two_layer["ms_per_flow_step"])
            if two_layer["overflow"]:
                raise AssertionError("multirank_path world 1: overflow")
        x1 = c2.packet_x.cpu().numpy()
        k1 = c2.packet_k.cpu().numpy()
        del c2
        launches_turns = read_launches()
        _, timing = sharded_coupled(cfg2, setup_coupled2,
                                    run_coupled2_chunk, None, N_CHUNKS)
        turns["unsharded"].append(timing["ms_per_flow_step"])
        reset_launches()
        c1, one_layer = sharded_coupled(
            CoupledConfig(march_fused_build=True, **FULL), setup_coupled,
            run_coupled_chunk, mesh, N_CHUNKS)
        equal_qg1 = (np.array_equal(c1.packet_x.cpu().numpy(), final_one[0])
                     and np.array_equal(c1.packet_k.cpu().numpy(),
                                        final_one[1]))
        del c1
        mesh_sweep(tmp / "sweep_nccl", MULTIRANK_SWEEP_STEPS, mesh=mesh,
                   march_fused_build=True)
        scaling_chunks = 4    # two warm-up calls and two timed
        points = measure_packet_scaling(
            lambda n: setup_coupled2(cfg2._replace(n_packets=n),
                                     dtype=torch.float32),
            lambda s: lambda c: run_coupled2_chunk(c, s, cfg2, 1),
            base_packets=cfg2.n_packets, world_sizes=(1,), iters=2,
            steps_per_call=cfg2.packet_steps_per_save)
    finally:
        dist.destroy_process_group()
    launches_nccl = expected_counts(launches_turns, read_launches())
    steps_sweep = MULTIRANK_SWEEP_STEPS
    expected = expected_counts(
        coupled_launches("march", "transpose", 2 + N_CHUNKS),
        coupled_launches("march", "transpose", 2 + N_CHUNKS),
        coupled_launches("march", "build_windows", 2 + N_CHUNKS),
        coupled_launches("march", "transpose", scaling_chunks),
        {"march_batched": steps_sweep,
         "build_windows_batched": steps_sweep + 1})
    if launches_nccl != expected:
        raise AssertionError(f"multirank_path world 1: launch counts "
                             f"{launches_nccl}, expected {expected}")
    equal_main = np.array_equal(x1, final_two[0]) and \
        np.array_equal(k1, final_two[1])
    if not (equal_main and equal_qg1):
        raise AssertionError("multirank_path world 1: packets differ from "
                             f"main_path ({equal_main}) / main_path_qg1 "
                             f"({equal_qg1})")
    if one_layer["overflow"]:
        raise AssertionError("multirank_path world 1: march overflow")
    unsharded_ms = statistics.mean(turns["unsharded"])

    torch.cuda.empty_cache()
    ranks_seconds = run_ranks(multirank_rank, MULTIRANK_WORLD, tmp)
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(MULTIRANK_WORLD)]
    members_per_rank = len(ENSEMBLE_SWEEP) // MULTIRANK_WORLD
    expected_rank = expected_counts(
        coupled_launches("march", "transpose", 2 + N_CHUNKS),
        *[{"march_batched": steps_sweep,
           "transpose_batched": steps_sweep + 1}] * len(MESH_SWEEPS))
    for r, got in enumerate(ranks):
        merged = expected_counts(got["launches_main"], got["launches_sweep"])
        if merged != expected_rank or got["main"]["overflow"]:
            raise AssertionError(f"multirank_path rank {r}: launch counts "
                                 f"{merged}, expected {expected_rank}; "
                                 f"overflow {got['main']['overflow']}")
    with np.load(tmp / "two_ranks.npz") as d:
        x2, k2 = d["x"], d["k"]
    rel = max(float(np.abs(x2 - x1).max() / np.abs(x1).max()),
              float(np.abs(k2 - k1).max() / np.abs(k1).max()))
    if rel > MULTIRANK_REL:
        raise AssertionError(f"multirank_path: two ranks against one, "
                             f"largest relative difference {rel}")
    launches = expected_counts(launches_nccl,
                               *[r["launches_main"] for r in ranks],
                               *[r["launches_sweep"] for r in ranks])

    # the sweeps against the one-rank sweep; each two-rank checkpoint
    # resumed on one rank against the one-rank sweep resumed
    ck = f"ckpt-g{ENSEMBLE_IDS[0]}_{1:012d}.npz"

    def held(base, resumed=None):
        """Histograms and times of a sweep against the one-rank sweep's
        (or of a resumed one against the one-rank sweep resumed)."""
        want_dir = tmp / "resumed_one_rank" if resumed else ref_dir
        hists = zip(member_files(base, "omega_hist"),
                    member_files(want_dir, "omega_hist"))
        share = [float(np.abs(np.frombuffer(a) - np.frombuffer(b)).sum()
                       / np.frombuffer(b).sum()) for a, b in hists]
        return {"omega_hist_equal": member_files(base, "omega_hist")
                == member_files(want_dir, "omega_hist"),
                "packet_time_equal": member_files(base, "packet_time")
                == member_files(want_dir, "packet_time"),
                "omega_hist_count_share_moved_max": max(share)}

    sweeps = {"nccl_world_1_fused_build": held(tmp / "sweep_nccl")}
    resumed = {"one_rank": mesh_sweep(shutil.copytree(ref_dir, tmp / (
        "resumed_one_rank")), 2 * MULTIRANK_SWEEP_STEPS, resume=True)}
    for label in MESH_SWEEPS:
        base = tmp / f"sweep_{label}"
        again = mesh_sweep(shutil.copytree(base, tmp / f"resumed_{label}"),
                           2 * MULTIRANK_SWEEP_STEPS, resume=True)
        want = resumed["one_rank"]
        sweeps[f"gloo_two_ranks_{label}"] = dict(
            held(base), checkpoint_minus_one_rank=ckpt_diff(
                base / ck, ref_dir / ck),
            resumed_on_one_rank=dict(
                held(tmp / f"resumed_{label}", resumed=True),
                packets_equal_bit_for_bit=bool(
                    torch.equal(again.packet_x, want.packet_x)
                    and torch.equal(again.packet_k, want.packet_k)),
                max_abs_dk=float((again.packet_k - want.packet_k).abs()
                                 .max())))
        del again
    del resumed
    # the cause of the members' split: one batch of 24 inverse transforms
    # against two of 12 (the fields of 12 members, and of 6)
    spec = torch.randn(12, 2, 256, 129, dtype=torch.complex64,
                       device=dev)
    whole = torch.fft.irfft2(spec, s=(256, 256))
    halves = torch.cat([torch.fft.irfft2(spec[:6], s=(256, 256)),
                        torch.fft.irfft2(spec[6:], s=(256, 256))])
    fft_batches = {"irfft2_24_vs_2x12_equal": bool(torch.equal(whole,
                                                               halves)),
                   "max_abs": float((whole - halves).abs().max())}
    del spec, whole, halves
    failed = []   # raised after the phase's line, which shows the numbers
    exact = ("nccl_world_1_fused_build", "gloo_two_ranks_packets_split")
    for label in exact:
        got = sweeps[label]
        if not (got["omega_hist_equal"] and got["packet_time_equal"]):
            failed.append(f"{label}: histograms or times differ from the "
                          "one-rank sweep's")
    split = sweeps["gloo_two_ranks_packets_split"]
    if any(split["checkpoint_minus_one_rank"].values()) or not (
            split["resumed_on_one_rank"]["packets_equal_bit_for_bit"]
            and split["resumed_on_one_rank"]["omega_hist_equal"]):
        failed.append("packets split: the checkpoint or its resume on one "
                      "rank differs from the one-rank sweep's")
    members = sweeps["gloo_two_ranks_members_split"]
    for got in (members, members["resumed_on_one_rank"]):
        if not got["packet_time_equal"] or \
                got["omega_hist_count_share_moved_max"] > HIST_COUNT_SHARE:
            failed.append(f"members split: {got}")
    flow_leaves = ("leaf_0", "leaf_1", "leaf_2", "leaf_3", "leaf_4")
    if any(members["checkpoint_minus_one_rank"][leaf] for leaf in
           flow_leaves):
        failed.append("members split: the flow (qk, its history, t, step) "
                      "differs from the one-rank run's")

    trace = {label: traced_chunk(label, cfg, setup, run_chunk,
                                 tmp / "trace")
             for label, cfg, setup, run_chunk in (
                 ("main_path", Coupled2Config(**FULL), setup_coupled2,
                  run_coupled2_chunk),
                 ("main_path_qg1",
                  CoupledConfig(march_fused_build=True, **FULL),
                  setup_coupled, run_coupled_chunk))}

    n_total = FULL["n_packets"]
    slowest = max(r["main"]["ms_per_flow_step"] for r in ranks)
    emit("multirank_path",
         world_1_nccl={
             "backend": backend1,
             "main_path": dict(two_layer, equal_to_main_path_bit_for_bit=True,
                               main_path_ms_per_flow_step=main[
                                   "ms_per_flow_step"],
                               ms_per_flow_step_in_turns=turns,
                               sharded_over_unsharded_in_turns=statistics.mean(
                                   turns["sharded"]) / unsharded_ms),
             "main_path_qg1": dict(
                 one_layer, equal_to_main_path_qg1_bit_for_bit=True),
             "scaling": [p._asdict() for p in points]},
         two_ranks_sharing_one_card={
             "backend": ranks[0]["backend"], "world": MULTIRANK_WORLD,
             "note": "two processes time-slicing one card; not a scaling "
                     "efficiency",
             "by_rank": [dict(r["main"], launches_main_path=r[
                 "launches_main"], launches_sweeps=r["launches_sweep"])
                 for r in ranks],
             "packet_steps_per_s": n_total * 1e3 / slowest,
             "packet_steps_per_s_over_world_1":
                 two_layer["ms_per_flow_step"] / slowest,
             "packet_steps_per_s_over_unsharded_in_turns":
                 unsharded_ms / slowest,
             "largest_relative_difference_to_world_1": rel,
             "tolerance": MULTIRANK_REL, "seconds": ranks_seconds},
         mesh_sweep={
             "source": "runs/run_tpu_sweep_b2000.py:46-57 (Run I)",
             "members": len(ENSEMBLE_SWEEP),
             "members_per_rank_when_split": members_per_rank,
             "flow_steps": steps_sweep,
             "resumed_to_flow_steps": 2 * steps_sweep,
             "against_one_rank": sweeps, "fft_batches": fft_batches,
             "hist_count_share_tolerance_members_split":
                 HIST_COUNT_SHARE},
         trace=trace, launches=launches, failed=failed,
         seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError(f"multirank_path: {failed}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    phase_build()
    phase_kernels_vs_plain(dev)
    phase_path_vs_cpu(dev)
    two, launches_two, routes_two, steps, main = phase_main_path(N_CHUNKS)
    final_two = (two[2].packet_x.cpu().numpy(), two[2].packet_k.cpu().numpy())
    rows, bounds = phase_kernels(*two, steps)
    del two
    one, launches_one, routes_one, _, main_qg1 = phase_main_path_qg1(N_CHUNKS)
    final_one = (one[2].packet_x.cpu().numpy(), one[2].packet_k.cpu().numpy())
    rows_one, bounds_one = phase_kernels_qg1(*one)
    del one
    rows_rays, bounds_rays, launches_rays = phase_frozen_path(dev)
    rows += rows_one + rows_rays
    bounds.update(bounds_one, **bounds_rays)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runs_") as tmp:
        tmp = Path(tmp)
        phase_driver_cli(tmp)
        launches_driver = phase_driver_path(tmp, main)
        launches_ref = phase_driver_reference_config(tmp, main_qg1)
        rows_ens, bounds_ens, launches_ens, routes_ens = \
            phase_ensemble_path(tmp)
    rows += rows_ens
    bounds.update(bounds_ens)
    launches_grad, transpose_by_direction = phase_grad_path(dev)
    launches_analytic = phase_analytic_path(dev)
    launches_solvers = phase_solvers_path(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        launches_multirank = phase_multirank_path(dev, Path(tmp), main,
                                                  final_two, final_one)
    # launches: over the main paths, each counted from 0
    by_path = {"main_path": launches_two, "main_path_qg1": launches_one,
               "frozen_path": launches_rays, "driver_path": launches_driver,
               "driver_reference_config": launches_ref, **launches_ens,
               "grad_path": launches_grad,
               "analytic_path": launches_analytic,
               "solvers_path": launches_solvers,
               "multirank_path": launches_multirank}
    for row in rows:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["name"] == "march":
            row["launches_by_route_by_path"] = {"main_path": routes_two,
                                                "main_path_qg1": routes_one}
        if row["name"] == "march_batched":
            row["launches_by_route_by_path"] = {"ensemble_path": routes_ens}
        if row["name"] == "transpose":
            row["launches_by_direction_by_path"] = {
                "grad_path": transpose_by_direction}
        if row["launches"] < 1:
            raise AssertionError(f"no main path launched {row['name']}")
    emit("kernel_bounds", hbm_bytes_per_s=HBM_BYTES_PER_S,
         flops_per_s=FLOPS_PER_S[torch.float32], **bounds)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
