"""Lock-step coupled flow + wave-packet stepping (shared by the models).

Counterpart of the fused-march path of swraytracing_tpu/models/
coupled.py, after the production entry point qgsw_raytrace.m: every flow
step advances the flow solver one step, then sub-cycles the packet ray
ODE between the previous and new flow snapshots with linear blending in
time (interpolate_U.m:19-23). The reference sub-cycles with adaptive
MATLAB ode23 (qgsw_raytrace.m:149); here a fixed number of RK23/RK4/
symplectic substeps per flow step runs inside the fused march
(ops/march_window.py).

The velocity grids of the *previous* step are reused as the blend-start
snapshot, and so are their gather windows, so each step builds windows
for its new snapshot only.

This module holds the carry, the packet initial conditions, the march
configuration and the generic lock-step iteration on the fused-march
path. The per-stage packet path below `window_min_np` packets and the
one-layer model (`CoupledConfig`, `setup_coupled`, `run_coupled_chunk`)
are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.grid import SpectralGrid, resolve_device
from ..ops import march_window as mw

__all__ = ["CoupledCarry", "ring_packet_ics", "build_march_spec",
           "window_threshold", "march_n_fields", "prepare_carry_windows",
           "lockstep_step"]

# Packet count from which the window-based paths engage when a config does
# not say (the default of the configs' window_min_np field).
_WINDOW_MIN_NP = 65536


@dataclasses.dataclass
class CoupledCarry:
    """State carried from one flow step to the next."""

    flow_state: object           # the flow solver's state (e.g. QG2State)
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
    return getattr(cfg, "window_min_np", _WINDOW_MIN_NP)


def march_n_fields(march) -> int:
    """Field-grid count the lock-step needs: the fused march with uv
    windows (grad_from_interp) forms grad U itself, so only (u, v) grids
    are computed. Every other path needs the full 6 stack. `march is
    None` means the fused path is disengaged."""
    return march.nf if march is not None else 6


def _per_stage_path_missing():
    return NotImplementedError(
        "the fused march is not engaged (n_packets below window_min_np, "
        "fused_march off, or a grid too small for a window) and the "
        "per-stage packet path is not ported yet: ROADMAP item A8")


def lockstep_step(carry: CoupledCarry, flow_step_fn, fields_fn, dt,
                  packet_delay, n_substeps: int, stepper: str,
                  march: mw.MarchSpec | None = None) -> CoupledCarry:
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
        (nf = march.nf — march_n_fields).
      march: fused-march spec. Engagement was decided at setup
        (build_march_spec); None (disengaged) raises NotImplementedError.
    """
    if march is None:
        raise _per_stage_path_missing()
    new_state = flow_step_fn(carry.flow_state)
    fields2 = fields_fn(new_state)

    exp_nf = march_n_fields(march)
    if carry.prev_fields.shape[0] != exp_nf:
        raise ValueError(
            f"carry.prev_fields holds {carry.prev_fields.shape[0]} field "
            f"grids but this configuration's path needs {exp_nf} "
            f"(march engaged, nf={march.nf}). The carry was built under a "
            "different march/window configuration — rebuild it with "
            "setup_coupled2.")
    if fields2.shape[0] != exp_nf:
        raise ValueError(
            f"fields_fn produced {fields2.shape[0]} field grids but the "
            f"path needs {exp_nf}; pass n_fields=march_n_fields(march).")

    if march.stepper != stepper or march.n_substeps != n_substeps:
        raise ValueError(
            "MarchSpec built for a different stepper configuration: "
            f"{march.stepper} x{march.n_substeps} vs {stepper} x"
            f"{n_substeps}; rebuild the setup with the new config")
    # Fused-march path: windows gathered ONCE per flow step with a
    # `margin` drift allowance, all substeps in one kernel launch.
    # Identical arithmetic to a per-stage path as long as no packet drifts
    # more than `margin` cells within the step — the running max of the
    # march's overflow counter is carried for callers to assert on.
    win2 = mw.build_gather_windows(fields2, march)
    win1 = carry.prev_win
    if win1 is None or win1.shape != win2.shape:
        win1 = mw.build_gather_windows(carry.prev_fields, march)
    active = new_state.t > packet_delay
    sub_dt = dt / n_substeps if active else 0.0
    x, k = carry.packet_x, carry.packet_k
    oi, oj = mw.packet_cells(x[0], x[1], march)
    xk = torch.cat([x, k], dim=0)
    if march.combined_gather:
        # Both snapshots' windows stacked on the K axis -> ONE gather per
        # packet per flow step.
        winc = torch.cat([win1, win2],
                         dim=-1 if march.tiles_transposed else 0)
        pwc = mw.gather_packet_windows(winc, oi, oj, march)
        dummy = pwc.new_zeros((1, 1))
        out, ov = mw.fused_march(pwc, dummy, xk, oi, oj, sub_dt, march)
    else:
        pw1 = mw.gather_packet_windows(win1, oi, oj, march)
        pw2 = mw.gather_packet_windows(win2, oi, oj, march)
        out, ov = mw.fused_march(pw1, pw2, xk, oi, oj, sub_dt, march)
    new_ov = ov.max()
    overflow = (new_ov if carry.overflow is None
                else torch.maximum(carry.overflow, new_ov))
    out_win = win2 if carry.prev_win is not None else None
    return CoupledCarry(flow_state=new_state, packet_x=out[:2],
                        packet_k=out[2:], prev_fields=fields2,
                        prev_win=out_win, overflow=overflow)


def prepare_carry_windows(carry: CoupledCarry,
                          march: mw.MarchSpec | None = None) -> CoupledCarry:
    """Make the carry's window/overflow slots consistent with the path
    lockstep_step will take: prev_fields' windows prebuilt (each step then
    builds windows only for its new snapshot) and an overflow counter
    starting at 0. Returns a new carry where anything changes."""
    if march is None:
        raise _per_stage_path_missing()
    if carry.overflow is None:
        carry = dataclasses.replace(carry, overflow=torch.zeros(
            (), dtype=torch.int32, device=carry.packet_x.device))
    win = carry.prev_win
    # Stale-window check must follow the window layout:
    # tiles_transposed stores (ncells, K), otherwise (K, ncells).
    k_ax = -1 if march.tiles_transposed else 0
    if win is None or win.shape[k_ax] != march.K:
        return dataclasses.replace(
            carry, prev_win=mw.build_gather_windows(carry.prev_fields, march))
    return carry
