"""Lock-step coupled flow + wave-packet stepping (shared by the models).

Counterpart of swraytracing_tpu/models/coupled.py, after the production
entry point qgsw_raytrace.m: every flow step advances the flow solver one
step, then sub-cycles the packet ray ODE between the previous and new flow
snapshots with linear blending in time (interpolate_U.m:19-23). The
reference sub-cycles with adaptive MATLAB ode23 (qgsw_raytrace.m:149);
here a fixed number of RK23/RK4/symplectic substeps per flow step runs
either inside the fused march (ops/march_window.py; from window_min_np
packets on) or stage by stage in plain PyTorch through
fields.BlendedFlow (below it, or with fused_march off; from
window_min_np packets on that path interpolates from prebuilt windows).

The velocity grids of the *previous* step are reused as the blend-start
snapshot, and so are their gather windows, so each step builds windows
for its new snapshot only.

This module holds the carry, the packet initial conditions, the march
configuration, the generic lock-step iteration (both packet paths) and
chunk loop (shared with the two-layer model, coupled2.py), and the
one-layer model's entry points (`CoupledConfig`, `setup_coupled`,
`coupled_flow_packet_step`, `run_coupled_chunk`).

Everything runs eagerly: a chunk is a Python loop over flow steps, each a
fixed sequence of device launches with no host synchronisation (time and
step count live on the host).

The lock-step and the carry also take an ensemble's members (a leading
member axis E on every tensor of the carry, `t` and `step` host arrays;
parallel/ensemble.py): lockstep_step is then given each member's substep
length as an (E,) float64 device tensor, and the fused march, the window
builds and the per-stage path run all members at once, the kernels one
launch each for all members.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops.grid import SpectralGrid, resolve_device
from ..ops import interp as _interp
from ..ops import march_window as mw
from ..ops import spectral as sp
from ..utils.profiling import span
from . import rays
from .dispersion import Dispersion
from .fields import BlendedFlow, flow_from_qk
from .qg import (QGParams, qg_init, qg_step, initial_q_ring,
                 inertial_ring_forcing, max_speed)

__all__ = ["CoupledConfig", "CoupledSetup", "CoupledCarry", "setup_coupled",
           "coupled_flow_packet_step", "run_coupled_chunk",
           "ring_packet_ics", "build_march_spec", "window_threshold",
           "march_n_fields", "prepare_carry_windows", "lockstep_step",
           "run_lockstep_chunk"]

class CoupledConfig(NamedTuple):
    """Mirrors the qgsw_raytrace positional signature
    (qgsw_raytrace.m:1) plus the tuning constants it hard-codes."""

    nx: int = 256
    n_packets: int = 50
    near_inertial_factor: float = 2.0   # w0: initial omega / f
    T_Fr_days: float = 6000.0
    packet_delay_days: float = 1000.0
    U_g: float = 0.4
    f: float = 3.0
    Cg: float = 1.0
    L: float = 2.0 * np.pi
    beta: float = 0.0
    r_drag: float = 0.1
    forcing_strength: float = 0.1
    CFL_fraction: float = 0.05          # qgsw_raytrace.m:29
    steps_per_save: int = 50
    packet_steps_per_save: int = 5
    n_substeps: int = 2                 # packet substeps per flow step
    stepper: str = "rk23"               # 'rk23' | 'rk4' | 'symplectic'
    seed: int = 146                     # rng(146), qgsw_raytrace.m:23
    ring_ic: bool = True                # False reproduces the reference bug
    reference_quirks: bool = False
    dealias: bool = False
    # Fused packet march (ops/march_window.py): gather each packet's
    # margin-widened stencil window ONCE per flow step and run all
    # substeps in one kernel. Engages at n_packets >= window_min_np.
    fused_march: bool = True
    window_min_np: int = 65536
    # Windows hold only (u, v); the march forms the velocity-gradient
    # tensor by differentiating the Lagrange interpolant. Turn off for
    # bit-parity with the spectral-gradient grids.
    march_uv_windows: bool = True
    # ONE gather per packet per flow step over both snapshots stacked on
    # the window axis. Arithmetic is bit-identical to two gathers. No
    # effect on the (ncells, K) row layout this module sets up: there the
    # march kernel reads its rows by cell and nothing is gathered.
    march_combined_gather: bool = True
    # Explicit march margin (cells) overriding required_margin's CFL
    # sizing; None = size from dt and the initial max speed.
    march_margin: int | None = None
    # One-kernel window build (march_window.build_windows_fused): writes
    # the (ncells, K) window array once instead of shifted copies + the
    # tiled transpose. Exact same output.
    march_fused_build: bool = False


class CoupledSetup(NamedTuple):
    grid: SpectralGrid
    disp: Dispersion
    qg_params: QGParams
    dt: float
    n_steps: int
    packet_delay: float
    packet_step_start: int
    Fr: float
    U0: float
    T: float
    march: mw.MarchSpec | None = None


@dataclasses.dataclass
class CoupledCarry:
    """State carried from one flow step to the next. An ensemble's carry
    has a leading member axis E on every tensor below ((E, 2, Np) packets,
    (E, nf, nx, ny) fields, (E, ncells, K) windows, (E,) overflow)."""

    flow_state: object           # the flow solver's state (QGState, QG2State)
    packet_x: torch.Tensor       # (2, Np) coordinate-first
    packet_k: torch.Tensor       # (2, Np)
    # (nf, nx, ny) velocity(-gradient) grids of the previous step. nf is
    # fixed at setup by march_n_fields: 2 ((u, v); grad U is formed in the
    # march) with uv windows, else 6 ([u, v, u_x, u_y, v_x, v_y]).
    prev_fields: torch.Tensor
    # Prebuilt gather windows of prev_fields
    # (march_window.build_gather_windows), carried across flow steps so
    # each lock-step builds windows only for its NEW snapshot.
    prev_win: torch.Tensor | None = None
    # Running max of the march's margin-overflow counter (0-dim int32 on
    # the packets' device; 0 = every stencil stayed inside its gathered
    # window). Read it at the end of a chunk, not per step.
    overflow: torch.Tensor | None = None


def ring_packet_ics(cfg, grid: SpectralGrid, seed=None, *, device=None,
                    dtype: torch.dtype = torch.float32):
    """Packet ICs (qgsw_raytrace.m:54-60): |k| on the near-inertial ring
    sqrt((w0^2-1) f^2 / Cg^2), equally spaced angles; positions uniform
    from ``np.random.default_rng``. Returns x, k as (2, Np)
    coordinate-first tensors."""
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    i = np.arange(1, cfg.n_packets + 1)
    wf = np.sqrt((cfg.near_inertial_factor**2 - 1.0) * cfg.f**2 / cfg.Cg**2)
    k = wf * np.stack([np.cos(2 * np.pi * i / cfg.n_packets),
                       np.sin(2 * np.pi * i / cfg.n_packets)], axis=0)
    x = rng.uniform(0.0, cfg.L, (2, cfg.n_packets))
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(k, dtype=dtype, device=device))


def build_march_spec(cfg, grid: SpectralGrid, dt: float, U0: float):
    """MarchSpec for the fused packet march, margin sized to the CFL
    step (required_margin).

    Returns None when the march does not engage — fused_march off, an
    incompatible stepper, or n_packets below window_min_np. Engagement
    is decided HERE, once: `march is not None` is the single source of
    truth for the fused path everywhere downstream (lockstep_step,
    march_n_fields, prepare_carry_windows)."""
    if not getattr(cfg, "fused_march", False):
        return None
    if cfg.stepper not in ("rk23", "rk4", "symplectic"):
        return None
    if cfg.n_packets < window_threshold(cfg):
        return None
    if min(grid.nx, grid.ny) < 2 * 2 + 4:  # S + 2 at order 2
        # grid too small for even a margin-1 window
        return None
    margin = getattr(cfg, "march_margin", None)
    if margin is None:
        margin = mw.required_margin(dt, U0, cfg.Cg, grid.dx,
                                    nx=min(grid.nx, grid.ny))
    uv = getattr(cfg, "march_uv_windows", False)
    return mw.MarchSpec(
        nx=grid.nx, ny=grid.ny, dx=grid.dx, dy=grid.dy,
        f=cfg.f, Cg=cfg.Cg, n_substeps=cfg.n_substeps,
        stepper=cfg.stepper, margin=margin, tiles_transposed=True,
        nf=2 if uv else 6, grad_from_interp=uv,
        combined_gather=getattr(cfg, "march_combined_gather", False),
        fused_build=getattr(cfg, "march_fused_build", False))


def window_threshold(cfg) -> int:
    """The engagement threshold for window-based paths, from the config."""
    return getattr(cfg, "window_min_np", _interp._WINDOW_MIN_NP)


def march_n_fields(march) -> int:
    """Field-grid count the lock-step needs: the fused march with uv
    windows (grad_from_interp) forms grad U itself, so only (u, v) grids
    are computed. Every other path needs the full 6 stack. `march is
    None` means the fused path is disengaged."""
    return march.nf if march is not None else 6


def _substep_fn(name: str):
    if name == "rk23":
        return rays.rk23_step
    if name == "rk4":
        return rays.rk4_step
    if name == "symplectic":
        return None  # handled specially (no alpha ramp within substep)
    raise ValueError(f"unknown stepper {name!r}")


def lockstep_step(carry: CoupledCarry, flow_step_fn, fields_fn, grid, disp,
                  dt, packet_delay, n_substeps: int, stepper: str,
                  march: mw.MarchSpec | None = None,
                  window_min_np: int | None = None,
                  sub_dt=None) -> CoupledCarry:
    """Generic lock-step iteration (qgsw_raytrace.m:121-151 and
    qg2layersw_raytrace.m:152-197): advance the flow one step, rebuild
    velocity grids, sub-cycle packets against the time-blended snapshots.
    Packets are frozen (sub_dt=0) until t > packet_delay, matching the
    reference's gating; `t` lives on the host, so the gate costs no
    device synchronisation. Returns a new carry; the input is not
    modified.

    Args:
      flow_step_fn: flow_state -> flow_state (one solver step; must
        advance .t).
      fields_fn: flow_state -> (nf, nx, ny) stacked velocity/gradients
        (nf = march_n_fields(march)).
      march: fused-march spec, or None when disengaged. Engagement was
        decided at setup (build_march_spec).
      window_min_np: packet count from which the per-stage path (march
        None) interpolates from prebuilt windows (ops/interp.build_windows)
        instead of the stencil; None means the default 65536. Pass the
        config's value (window_threshold).
      sub_dt: an ensemble's carry only (and required there): each member's
        substep length, an (E,) float64 tensor on the packets' device, 0
        for a member not yet released or frozen; `dt` and `packet_delay`
        are then not read. The caller forms it on the host from each
        member's t, dt and delay (parallel/ensemble.py).

    The fused march: with (ncells, K) window rows (march.tiles_transposed,
    what build_march_spec always makes) the packets march straight from
    the two window arrays (march_window.fused_march_gathered): no stacked
    copy, no gathered copy, whatever march.combined_gather says. A
    hand-made spec with (K, ncells) windows gathers first, in one gather
    (combined_gather) or two, and calls march_window.fused_march.

    The per-stage path (march None) evaluates the blended flow at every
    stage of n_substeps rk23 / rk4 steps with the alpha ramp, or of
    symplectic steps at alpha = i/m + 0.5/m, in plain PyTorch; it has no
    overflow counter.

    The step runs inside the span swr.step (utils/profiling.span), its
    flow step inside swr.flow and the velocity grids inside swr.fields.
    """
    with span("swr.step"):
        return _lockstep_step(carry, flow_step_fn, fields_fn, grid, disp, dt,
                              packet_delay, n_substeps, stepper, march,
                              window_min_np, sub_dt)


def _lockstep_step(carry, flow_step_fn, fields_fn, grid, disp, dt,
                   packet_delay, n_substeps, stepper, march, window_min_np,
                   sub_dt):
    """lockstep_step inside its span."""
    if window_min_np is None:
        window_min_np = _interp._WINDOW_MIN_NP
    with span("swr.flow"):
        new_state = flow_step_fn(carry.flow_state)
    with span("swr.fields"):
        fields2 = fields_fn(new_state)
    Np = carry.packet_x.shape[-1]

    exp_nf = march_n_fields(march)
    if carry.prev_fields.shape[-3] != exp_nf:
        path = (f"march engaged, nf={march.nf}" if march is not None
                else "march disengaged")
        raise ValueError(
            f"carry.prev_fields holds {carry.prev_fields.shape[-3]} field "
            f"grids but this configuration's path needs {exp_nf} "
            f"({path}). The carry was built under a different march/window "
            "configuration — rebuild it with setup_coupled / setup_coupled2 "
            "or reconcile prev_fields (the drivers do this on resume).")
    if fields2.shape[-3] != exp_nf:
        raise ValueError(
            f"fields_fn produced {fields2.shape[-3]} field grids but the "
            f"path needs {exp_nf}; pass n_fields=march_n_fields(march).")

    members = carry.packet_x.dim() == 3
    if members != (sub_dt is not None):
        raise ValueError("lockstep_step takes sub_dt, each member's substep "
                         "length, with an ensemble's carry, and only there")
    if not members:
        sub_dt = dt / n_substeps if new_state.t > packet_delay else 0.0
    if march is not None:
        return _march_step(carry, new_state, fields2, sub_dt, n_substeps,
                           stepper, march)

    if Np >= window_min_np:
        # prebuilt windows: one gathered row per packet per evaluation.
        # Only the new snapshot's are built here; the blend-start
        # snapshot's come with the carry (prepare_carry_windows).
        win1 = carry.prev_win
        if win1 is None:
            win1 = _interp.build_windows(carry.prev_fields)
        win2 = _interp.build_windows(fields2)
        flow = BlendedFlow(fields1=carry.prev_fields, fields2=fields2,
                           grid=grid, win1=win1, win2=win2)
    else:
        win2 = None
        flow = BlendedFlow(fields1=carry.prev_fields, fields2=fields2,
                           grid=grid)
    m = n_substeps
    step = _substep_fn(stepper)
    x, k = carry.packet_x, carry.packet_k
    if members:
        # coordinate first, as the integrators index: (2, E, Np), each
        # member's substep length broadcast over its packets
        x, k = x.transpose(0, 1), k.transpose(0, 1)
        sub_dt = sub_dt.to(x.dtype)[:, None]
    for i in range(m):
        a0 = i / m
        if step is None:
            x, k = rays.symplectic_step(x, k, sub_dt, disp, flow,
                                        alpha=a0 + 0.5 / m)
        else:
            x, k = step(x, k, sub_dt, disp, flow, alpha0=a0, dalpha=1.0 / m)
    if members:
        x = x.transpose(0, 1).contiguous()
        k = k.transpose(0, 1).contiguous()
    # a carry that came in with windows leaves with the new snapshot's
    out_win = win2 if carry.prev_win is not None else None
    return CoupledCarry(flow_state=new_state, packet_x=x, packet_k=k,
                        prev_fields=fields2, prev_win=out_win,
                        overflow=carry.overflow)


def _march_step(carry, new_state, fields2, sub_dt, n_substeps, stepper,
                march):
    """The fused-march branch of lockstep_step: windows read ONCE per flow
    step with a `margin` drift allowance, all substeps in one kernel
    launch. Identical arithmetic to the per-stage path as long as no
    packet drifts more than `margin` cells within the step — the running
    max of the march's overflow counter is carried for callers to assert
    on. An ensemble's members (sub_dt an (E,) tensor) build their windows
    and march in one launch of each batched kernel, and keep one running
    overflow max each."""
    if march.stepper != stepper or march.n_substeps != n_substeps:
        raise ValueError(
            "MarchSpec built for a different stepper configuration: "
            f"{march.stepper} x{march.n_substeps} vs {stepper} x"
            f"{n_substeps}; rebuild the setup with the new config")
    win2 = mw.build_gather_windows(fields2, march)
    win1 = carry.prev_win
    if win1 is None or win1.shape != win2.shape:
        win1 = mw.build_gather_windows(carry.prev_fields, march)
    x, k = carry.packet_x, carry.packet_k
    if x.dim() == 3 and not march.tiles_transposed:
        raise ValueError("an ensemble's march reads (ncells, K) window "
                         "rows: tiles_transposed=True")
    with span("swr.march"):
        if x.dim() == 3:
            oi, oj = mw.packet_cells(x[:, 0], x[:, 1], march)
            out, ov = mw.march_gathered_batched(
                win1, win2, torch.cat([x, k], dim=1), oi, oj, sub_dt, march)
            new_ov = ov.amax(dim=1)
        else:
            oi, oj = mw.packet_cells(x[0], x[1], march)
            out, ov = _march_packets(win1, win2, torch.cat([x, k], dim=0),
                                     oi, oj, sub_dt, march)
            new_ov = ov.max()
        overflow = (new_ov if carry.overflow is None
                    else torch.maximum(carry.overflow, new_ov))
    out_win = win2 if carry.prev_win is not None else None
    return CoupledCarry(flow_state=new_state, packet_x=out[..., :2, :],
                        packet_k=out[..., 2:, :], prev_fields=fields2,
                        prev_win=out_win, overflow=overflow)


def _march_packets(win1, win2, xk, oi, oj, sub_dt, march):
    """One run's march from the two snapshots' window arrays."""
    if march.tiles_transposed:
        # (ncells, K) rows: the march reads each packet's row of both
        # window arrays by its cell; nothing is stacked or gathered first.
        return mw.fused_march_gathered(win1, win2, xk, oi, oj, sub_dt, march)
    if march.combined_gather:
        # Both snapshots' windows stacked on the K axis -> ONE gather per
        # packet per flow step.
        winc = torch.cat([win1, win2],
                         dim=-1 if march.tiles_transposed else 0)
        pwc = mw.gather_packet_windows(winc, oi, oj, march)
        dummy = pwc.new_zeros((1, 1))
        return mw.fused_march(pwc, dummy, xk, oi, oj, sub_dt, march)
    pw1 = mw.gather_packet_windows(win1, oi, oj, march)
    pw2 = mw.gather_packet_windows(win2, oi, oj, march)
    return mw.fused_march(pw1, pw2, xk, oi, oj, sub_dt, march)


def prepare_carry_windows(carry: CoupledCarry, remat: bool = False,
                          march: mw.MarchSpec | None = None,
                          window_min_np: int | None = None) -> CoupledCarry:
    """Make the carry's window/overflow slots consistent with the path
    lockstep_step will take: on a window path (the fused march, or the
    per-stage path from window_min_np packets on) prev_fields' windows
    prebuilt, by that path's window build, so each step builds windows
    only for its new snapshot; an overflow counter starting at 0 on the
    fused march and none on the per-stage path. Returns a new carry where
    anything changes. An ensemble's carry gets its windows built for all
    members and one overflow counter per member, (E,).

    remat (differentiable chunks rematerialised step by step) strips the
    window slot instead: each step's inputs are what the checkpoint keeps
    for the backward, and a carried window array would cost a window
    array per step (128 MB at 512^2, nf=2, float32). Each step then builds
    both snapshots' windows itself, and builds them again when the
    backward recomputes it."""
    if not isinstance(remat, bool):
        raise TypeError("prepare_carry_windows(carry, remat, march, "
                        f"window_min_np): remat is a bool, got {remat!r}")
    if window_min_np is None:
        window_min_np = _interp._WINDOW_MIN_NP
    march_on = march is not None
    if march_on and carry.overflow is None:
        carry = dataclasses.replace(carry, overflow=torch.zeros(
            carry.packet_x.shape[:-2], dtype=torch.int32,
            device=carry.packet_x.device))
    if not march_on and carry.overflow is not None:
        carry = dataclasses.replace(carry, overflow=None)
    win = carry.prev_win
    engaged = march_on or carry.packet_x.shape[-1] >= window_min_np
    if remat or not engaged:
        if win is not None:
            return dataclasses.replace(carry, prev_win=None)
        return carry
    if march_on:
        # Stale-window check must follow the window layout:
        # tiles_transposed stores (ncells, K), otherwise (K, ncells).
        k_ax = -1 if march.tiles_transposed else 0
        if win is None or win.shape[k_ax] != march.K:
            return dataclasses.replace(carry, prev_win=mw.build_gather_windows(
                carry.prev_fields, march))
        return carry
    if win is None:
        return dataclasses.replace(
            carry, prev_win=_interp.build_windows(carry.prev_fields))
    return carry


def run_lockstep_chunk(carry: CoupledCarry, step_fn, march,
                       steps_per_save: int, n_saves: int,
                       remat: bool = False, diag_fn=None,
                       window_min_np: int | None = None):
    """The chunk loop both models share: n_saves * steps_per_save calls of
    `step_fn` (carry -> carry), one save after every steps_per_save. See
    run_coupled_chunk for what it returns.

    remat=True runs each call of step_fn under a non-reentrant
    torch.utils.checkpoint: the backward keeps each step's input carry
    only and recomputes the step from it (the JAX package's
    jax.checkpoint per lock-step). `t` and `step` are host scalars, so
    the recomputation repeats the forward's arithmetic exactly."""
    carry = prepare_carry_windows(carry, remat, march, window_min_np)
    if remat:
        plain_step = step_fn

        def step_fn(c):
            return torch.utils.checkpoint.checkpoint(
                plain_step, c, use_reentrant=False,
                preserve_rng_state=False)
    saves, ts = [], []
    for _ in range(n_saves):
        for _ in range(steps_per_save):
            carry = step_fn(carry)
        ts.append(carry.flow_state.t)
        if diag_fn is not None:
            saves.append((diag_fn(carry),))
        else:
            saves.append((carry.packet_x, carry.packet_k))
    stacked = tuple(torch.stack(col) for col in zip(*saves))
    return carry, (*stacked, torch.tensor(ts, dtype=torch.float64))


# ---------------------------------------------------------------------------
# The one-layer model (qgsw_raytrace.m)
# ---------------------------------------------------------------------------

def setup_coupled(cfg: CoupledConfig, device=None,
                  dtype: torch.dtype = torch.float32):
    """Build grid, params, ICs and the CFL time step, mirroring
    qgsw_raytrace.m:13-73.

    `device=None` means the CUDA device and raises when there is none;
    pass `device="cpu"` to run on the CPU. `dtype` is the real dtype of
    the state (spectra are its complex counterpart). The initial maximum
    speed is read back from the device once, here: one synchronisation at
    setup, none per step. Returns (setup, carry0).
    """
    device = resolve_device(device)
    grid = SpectralGrid.square(cfg.nx, cfg.L)
    disp = Dispersion(f=cfg.f, Cg=cfg.Cg)
    Kd2 = cfg.f / cfg.Cg  # K_d2 = f/Cg as the reference (qgsw_raytrace.m:27)

    qk0 = initial_q_ring(cfg.seed, grid, cfg.U_g, Kd2, ring=cfg.ring_ic,
                         device=device, dtype=dtype)
    forcing = inertial_ring_forcing(cfg.forcing_strength, grid, cfg.f, cfg.Cg)

    U0 = float(max_speed(qk0, grid, Kd2))
    Fr = U0 / cfg.Cg
    T_days = cfg.T_Fr_days / cfg.f
    T = T_days / Fr**2
    dt = cfg.CFL_fraction * grid.dx / U0
    n_steps = int(np.ceil(T / dt))
    packet_delay = cfg.packet_delay_days / cfg.f
    packet_step_start = int(np.ceil(packet_delay / dt))

    qp = QGParams(Kd2=Kd2, beta=cfg.beta, r_drag=cfg.r_drag, dt=dt,
                  forcing=forcing, filter=sp.exp_filter(grid),
                  dealias=cfg.dealias, reference_quirks=cfg.reference_quirks)

    px0, pk0 = ring_packet_ics(cfg, grid, device=device, dtype=dtype)
    march = build_march_spec(cfg, grid, dt, U0)
    nf0 = march_n_fields(march)
    fields0 = flow_from_qk(qk0, grid, Kd2, n_fields=nf0).fields
    carry0 = CoupledCarry(flow_state=qg_init(qk0), packet_x=px0,
                          packet_k=pk0, prev_fields=fields0)
    setup = CoupledSetup(grid=grid, disp=disp, qg_params=qp, dt=dt,
                         n_steps=n_steps, packet_delay=packet_delay,
                         packet_step_start=packet_step_start, Fr=Fr, U0=U0,
                         T=T, march=march)
    return setup, carry0


def coupled_flow_packet_step(carry: CoupledCarry, s: CoupledSetup,
                             cfg: CoupledConfig) -> CoupledCarry:
    """One-layer QG lock-step iteration (qgsw_raytrace.m:121-151)."""
    grid, qp = s.grid, s.qg_params
    nf = march_n_fields(s.march)
    return lockstep_step(
        carry,
        flow_step_fn=lambda st: qg_step(st, grid, qp),
        fields_fn=lambda st: flow_from_qk(st.qk, grid, qp.Kd2,
                                          n_fields=nf).fields,
        grid=grid, disp=s.disp, dt=s.dt, packet_delay=s.packet_delay,
        n_substeps=cfg.n_substeps, stepper=cfg.stepper, march=s.march,
        window_min_np=window_threshold(cfg))


def run_coupled_chunk(carry: CoupledCarry, s: CoupledSetup,
                      cfg: CoupledConfig, n_saves: int,
                      remat: bool = False, diag_fn=None):
    """Advance n_saves * packet_steps_per_save flow steps, emitting a
    packet snapshot every packet_steps_per_save steps (the reference's
    packet save cadence, qgsw_raytrace.m:153-163).

    Returns (carry, (px (n_saves, 2, Np), pk (n_saves, 2, Np),
    t (n_saves,) float64 on the host)). The chunk itself never
    synchronises with the device; `carry.overflow` is a device tensor for
    the caller to read once the chunk is done.

    diag_fn: optional carry -> tensor device diagnostic. When given, each
    save emits (diag, t) INSTEAD of the full packet arrays and the return
    becomes (carry, (diag (n_saves, ...), t (n_saves,))).

    remat=True rematerialises each lock-step in reverse-mode
    differentiation (run_lockstep_chunk): gradient memory drops from one
    step's whole set of intermediates per step to one carry per step, at
    the price of running each step's forward twice. Forward-only runs
    leave it off. The carry comes back without windows (prev_win None).
    Differentiate a scalar of the result by `.backward()` or
    torch.autograd.grad; for a complex leaf such as `qk` PyTorch's
    gradient is the complex conjugate of jax.grad's."""
    return run_lockstep_chunk(
        carry, lambda c: coupled_flow_packet_step(c, s, cfg), s.march,
        cfg.packet_steps_per_save, n_saves, remat, diag_fn,
        window_threshold(cfg))
