"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

builds the two CUDA kernels of swraytracing_torch from the sources in this
checkout, holds each against its plain PyTorch version on the card, runs
the whole two-layer coupled path once on the card and once on the CPU at
a small size and compares them, then drives the main path at full width:
the two-layer coupled model at 512^2 with 2^20 wave packets, rk23 with 2
substeps, uv windows, combined gather, transposed tiles, float32. Each
phase prints one JSON line. Any failed phase raises, so the exit code is
non-zero; without a CUDA device the script fails at once and runs nothing
on the CPU in its place.

Last lines of the output: a {"kernels": [...]} line (per kernel: its time
at the main path's shapes, the least time the card could take for the same
bytes and operations, the plain version's time, a library call's time
where there is one, its launches on the main path, its error against the
plain version), the card's name and power limit as nvidia-smi gives them,
and {"ok": true, "device": {...}}. The `kernel_bounds` line before them
holds what each bound was computed from (bytes, operations, shapes) and
the tolerances the errors were held to. The script takes no arguments.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from swraytracing_torch import kernels
from swraytracing_torch.models import qg2
from swraytracing_torch.models.coupled2 import (Coupled2Config,
                                                run_coupled2_chunk,
                                                setup_coupled2)
from swraytracing_torch.ops import march_window as mw

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and float32 / float64 rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

# The TPU kernels the two CUDA kernels replace (file:line of the
# function that reaches pl.pallas_call).
REPLACES = {
    "march": "swraytracing_tpu/ops/pallas_window.py:622",
    "transpose": "swraytracing_tpu/ops/pallas_window.py:181",
}
SOURCES = {
    "march": "swraytracing_torch/kernels/csrc/march.cuh",
    "transpose": "swraytracing_torch/kernels/csrc/transpose.cu",
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


def reset_launches():
    mw.march_cuda.launches = 0
    mw.transpose_cuda.launches = 0


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
    # registers per kernel, keyed by the template arguments in the mangled
    # name (scalar type f/d, gradient-from-interpolant, stepper)
    names = [line.split("'")[1] for line in
             kernels.build_info["log"].splitlines()
             if "Compiling entry function" in line]
    by_kernel = {n.split("kernelI")[-1][:12]: r for n, r in zip(names, regs)}
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


def compare_march(inputs, sub_dt, spec, rtol, atol, label):
    """Kernel against march_reference on the same CUDA tensors. Returns
    (max abs error, largest error as a share of the tolerance)."""
    got, ov = mw.march_cuda(*inputs, sub_dt, spec)
    want, ov_want = mw.march_reference(*inputs, sub_dt, spec)
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
    return float(err.max()), share, int(ov.max())


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

    report = {}
    for dtype, rtol, atol in ((torch.float64, 0.0, F64_ATOL),
                              (torch.float32, F32_RTOL, F32_ATOL)):
        F1, F2, x, k = (torch.as_tensor(a, dtype=dtype, device=dev)
                        for a in (F1h, F2h, xh, kh))
        worst_err, worst_share, cases = 0.0, 0.0, 0

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
                            err, share, ovmax = compare_march(
                                march_inputs(spec, F1, F2, x, k),
                                0.1 * margin * dx, spec, rtol, atol, label)
                            if ovmax != 0:
                                raise AssertionError(
                                    f"{label}: unexpected overflow {ovmax}")
                            worst_err = max(worst_err, err)
                            worst_share = max(worst_share, share)
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
            err, share, ovmax = compare_march(
                inputs, 5.0 * dx, spec, 1e-12, F64_ATOL,
                "float64 forced overflow")
            if ovmax <= 0:
                raise AssertionError("forced-overflow case did not overflow")
            extra = {"forced_overflow_max": ovmax,
                     "forced_overflow_max_abs_err": err}
            cases += 1
        report[str(dtype)] = {"cases": cases, "max_abs_err": worst_err,
                              "rtol": rtol, "atol": atol,
                              "worst_share_of_tolerance": worst_share,
                              **extra}

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
    emit("kernels_vs_plain", n_packets=n_p, nx=nx, **report)


# ---------------------------------------------------------------------------
# the whole slice, card against CPU
# ---------------------------------------------------------------------------

def phase_path_vs_cpu(dev):
    cfg = Coupled2Config(nx=64, n_packets=4096, window_min_np=1,
                         T_Fr_days=20.0, packet_delay_days=0.05,
                         packet_steps_per_save=5)
    out = {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        s, carry = setup_coupled2(cfg, device=device, dtype=torch.float64)
        carry, (px, pk, ts) = run_coupled2_chunk(carry, s, cfg, 2)
        out[name] = (s, carry, px.cpu(), pk.cpu(), ts)
    (sg, cg, pxg, pkg, tsg), (sc, cc, pxc, pkc, tsc) = out["cuda"], out["cpu"]
    if sg.march != sc.march or sg.march is None:
        raise AssertionError("march specs differ between card and CPU")
    # cuFFT and the CPU FFT differ in the last bits; 10 steps keep that
    # far below these tolerances
    torch.testing.assert_close(pxg, pxc, rtol=0, atol=1e-9)
    torch.testing.assert_close(pkg, pkc, rtol=0, atol=1e-9)
    qg_, qc_ = cg.flow_state.qk.cpu(), cc.flow_state.qk
    if not float((qg_ - qc_).abs().max()) <= 1e-9 * float(qc_.abs().max()):
        raise AssertionError("qk differs between card and CPU")
    if int(cg.overflow) != int(cc.overflow):
        raise AssertionError("overflow differs between card and CPU")
    if not float((pxc[-1] - pxc[0]).abs().max()) > 0:
        raise AssertionError("packets did not move in path_vs_cpu")
    emit("path_vs_cpu", nx=cfg.nx, n_packets=cfg.n_packets, flow_steps=10,
         max_abs_dx=float((pxg - pxc).abs().max()),
         max_abs_dk=float((pkg - pkc).abs().max()),
         max_rel_dqk=float((qg_ - qc_).abs().max() / qc_.abs().max()),
         overflow=int(cg.overflow), margin=sg.march.margin)


# ---------------------------------------------------------------------------
# the main path at full width
# ---------------------------------------------------------------------------

def main_config():
    return Coupled2Config(nx=512, n_packets=1_048_576, T_Fr_days=6000.0,
                          packet_delay_days=0.01, U_g=0.4, f=3.0, Cg=1.0,
                          stepper="rk23", n_substeps=2,
                          packet_steps_per_save=20)


def omega_over_f(pk, cfg):
    return torch.sqrt(cfg.f ** 2 + cfg.Cg ** 2 * (pk * pk).sum(0)) / cfg.f


def phase_main_path(n_chunks):
    cfg = main_config()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    s, carry = setup_coupled2(cfg, dtype=torch.float32)  # device=None: CUDA
    if carry.packet_x.device.type != "cuda" or s.march is None:
        raise AssertionError("the main path is not on the card / the march "
                             "is not engaged")
    x_start = carry.packet_x.clone()
    om0 = omega_over_f(carry.packet_k, cfg)
    om0_mean, om0_std = float(om0.mean()), float(om0.std())
    for _ in range(2):  # warm-up: builds the kernels' first launches, cuFFT
        carry, _ = run_coupled2_chunk(carry, s, cfg, 1)
    torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_chunks):
        carry, (px, pk, ts) = run_coupled2_chunk(carry, s, cfg, 1)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seconds = start.elapsed_time(end) / 1e3
    launches = {"march": mw.march_cuda.launches,
                "transpose": mw.transpose_cuda.launches}

    steps = n_chunks * cfg.packet_steps_per_save
    # counted since just before setup: one march and one transpose per
    # flow step, warm-up included, plus the one transpose that prepares
    # the first carry's windows
    all_steps = (2 + n_chunks) * cfg.packet_steps_per_save
    if launches != {"march": all_steps, "transpose": all_steps + 1}:
        raise AssertionError(
            f"launch counts {launches}, expected march {all_steps}, "
            f"transpose {all_steps + 1}")
    for name, t in (("packet_x", carry.packet_x), ("packet_k", carry.packet_k),
                    ("prev_fields", carry.prev_fields),
                    ("qk", torch.view_as_real(carry.flow_state.qk))):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name} is not finite")
    if px.shape != (1, 2, cfg.n_packets) or pk.shape != px.shape:
        raise AssertionError(f"unexpected save shapes {px.shape} {pk.shape}")
    overflow = int(carry.overflow)
    if overflow != 0:
        raise AssertionError(f"march overflow {overflow} on the main path")
    moved = float((carry.packet_x - x_start).abs().max())
    if not moved > 1e-3:
        raise AssertionError(f"packets did not move ({moved})")
    om1 = omega_over_f(carry.packet_k, cfg)
    if abs(om0_mean - 2.0) > 1e-5 or om0_std > 1e-5:
        raise AssertionError(f"omega/f starts at {om0_mean} +- {om0_std}")
    if not float(om1.std()) > 10 * max(om0_std, 1e-7):
        raise AssertionError("omega/f did not spread")
    speed = float(qg2.max_speed2(carry.flow_state.qk, s.grid, s.ops,
                                 s.params))
    if not 0.05 < speed < 10.0:
        raise AssertionError(f"max speed {speed} is not O(1)")
    emit("main_path", nx=cfg.nx, n_packets=cfg.n_packets, dtype="float32",
         stepper=cfg.stepper, n_substeps=cfg.n_substeps,
         margin=s.march.margin, K=s.march.K, dt=s.dt, U0=s.U0,
         timed_chunks=n_chunks, flow_steps=steps,
         flow_steps_with_warm_up=all_steps, seconds=seconds,
         host_seconds=wall, flow_steps_per_s=steps / seconds,
         packet_steps_per_s=steps * cfg.n_packets / seconds,
         ms_per_flow_step=1e3 * seconds / steps, launches=launches,
         overflow=overflow, max_packet_displacement=moved,
         omega_over_f_start=[om0_mean, om0_std],
         omega_over_f_end=[float(om1.mean()), float(om1.std())],
         max_speed=speed, t_end=carry.flow_state.t,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return cfg, s, carry, launches, all_steps


# ---------------------------------------------------------------------------
# the kernels at the main path's shapes
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


def phase_kernels(cfg, s, carry, launches, steps):
    spec = s.march
    dtype = carry.packet_x.dtype
    item = carry.packet_x.element_size()
    n_p = cfg.n_packets

    # K1 inputs exactly as lockstep_step forms them, from the final carry
    state2 = qg2.qg2_step(carry.flow_state, s.grid, s.ops, s.params)
    fields2 = qg2.top_layer_flow(state2.qk, s.grid, s.ops, s.params,
                                 cfg.one_layer_quirk, n_fields=spec.nf).fields
    W = mw.build_margin_windows(fields2, spec)           # (K, ncells)
    win2 = mw.transpose_cuda(W)
    winc = torch.cat([carry.prev_win, win2], dim=-1)
    x, k = carry.packet_x, carry.packet_k
    oi, oj = mw.packet_cells(x[0], x[1], spec)
    pwc = mw.gather_packet_windows(winc, oi, oj, spec)

    # the parts of one flow step, each timed alone on these inputs
    parts = {
        "qg2_step": lambda: qg2.qg2_step(carry.flow_state, s.grid, s.ops,
                                         s.params),
        "top_layer_flow": lambda: qg2.top_layer_flow(
            state2.qk, s.grid, s.ops, s.params, cfg.one_layer_quirk,
            n_fields=spec.nf),
        "build_margin_windows": lambda: mw.build_margin_windows(fields2,
                                                                spec),
        "transpose_cuda": lambda: mw.transpose_cuda(W),
        "cat_windows": lambda: torch.cat([carry.prev_win, win2], dim=-1),
        "packet_cells": lambda: mw.packet_cells(x[0], x[1], spec),
        "gather_packet_windows": lambda: mw.gather_packet_windows(
            winc, oi, oj, spec),
    }
    breakdown = {name: cuda_ms(fn, 15) for name, fn in parts.items()}
    del winc
    dummy = pwc.new_zeros((1, 1))
    xk = torch.cat([x, k], dim=0)
    sub_dt = s.dt / cfg.n_substeps
    args = (pwc, dummy, xk, oi, oj, sub_dt, spec)
    if tuple(pwc.shape) != (n_p, 2 * spec.K):
        raise AssertionError(f"unexpected window rows {tuple(pwc.shape)}")

    got, ov = mw.march_cuda(*args)
    want, ov_want = mw.march_reference(*args)
    torch.cuda.synchronize()
    if not torch.equal(ov, ov_want):
        raise AssertionError("march overflow differs at the main shapes")
    err = (got - want).abs()
    share = float((err / (F32_ATOL + F32_RTOL * want.abs())).max())
    if share > 1.0:
        raise AssertionError(
            f"march at the main shapes: max abs err {float(err.max()):.3e} "
            f"exceeds atol={F32_ATOL} rtol={F32_RTOL}")
    march_err = float(err.max())
    del got, want, err

    march_ms = cuda_ms(lambda: mw.march_cuda(*args), 25)
    breakdown["march_cuda"] = march_ms
    emit("step_breakdown", unit="ms, median, each part alone",
         sum_of_parts=sum(breakdown.values()), **breakdown)
    march_plain_ms = cuda_ms(lambda: mw.march_reference(*args), 3)
    march_bytes = n_p * (2 * spec.K * item + 4 * item + 8 + 4 * item + 4)
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
    tr_ms = cuda_ms(lambda: mw.transpose_cuda(W), 25)
    tr_plain_ms = cuda_ms(lambda: mw.transpose_reference(W), 25)
    tr_lib_ms = cuda_ms(lambda: W.t().contiguous(), 25)
    tr_bytes = 2 * W.numel() * item

    tr_by_bytes = tr_bytes / HBM_BYTES_PER_S * 1e3

    # What the bounds were computed from, and what the errors were held to.
    emit("kernel_bounds", hbm_bytes_per_s=HBM_BYTES_PER_S,
         flops_per_s=FLOPS_PER_S[dtype], flow_steps=steps,
         march={"shape": f"pwc {tuple(pwc.shape)} {dtype}, xk (4, {n_p})",
                "bytes": march_bytes, "flops": march_flops,
                "ms_by_bytes": by_bytes, "ms_by_operations": by_ops,
                "tolerance": {"rtol": F32_RTOL, "atol": F32_ATOL}},
         transpose={"shape": f"{tuple(W.shape)} {dtype}", "bytes": tr_bytes,
                    "flops": 0, "ms_by_bytes": tr_by_bytes,
                    "ms_by_operations": 0.0, "tolerance": "exact"})

    # Per kernel: bound_ms from this run's inputs, every other number
    # measured in this run.
    rows = [
        {"name": "march", "route": "cuda", "source": SOURCES["march"],
         "replaces": REPLACES["march"], "launches": launches["march"],
         "max_abs_err": march_err, "ms": march_ms,
         "plain_ms": march_plain_ms, "bound_ms": max(by_bytes, by_ops),
         "bound_by": "bytes" if by_bytes >= by_ops else "operations",
         "library_ms": None},
        {"name": "transpose", "route": "cuda", "source": SOURCES["transpose"],
         "replaces": REPLACES["transpose"],
         "launches": launches["transpose"], "max_abs_err": tr_err,
         "ms": tr_ms, "plain_ms": tr_plain_ms, "bound_ms": tr_by_bytes,
         "bound_by": "bytes", "library_ms": tr_lib_ms},
    ]
    for row in rows:
        if row["launches"] < 1:
            raise AssertionError(f"the main path never launched "
                                 f"{row['name']}")
    return rows


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
    rows = phase_kernels(*phase_main_path(N_CHUNKS))
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
