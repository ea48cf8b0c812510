"""Two-layer coupled flow + wave-packet model.

Counterpart of swraytracing_tpu/models/coupled2.py, after
qg2layersw_raytrace.m: two-layer QG with imposed shear advanced by
integrating-factor AB3, with wave packets sub-cycled against
time-blended top-layer velocity grids every flow step (packets see the
TOP layer only, :185-189).

The reference adapts dt when its CFL check fails and rebuilds the matrix
exponentials (:154-165); here dt is fixed from the initial CFL with the
same safety factor the reference applies on rebuild (CFL_fraction/2).
The shear-driven flow equilibrates, so a fixed dt at half-CFL matches
the reference's post-adaptation dt.

A chunk is a Python loop over flow steps, each a fixed sequence of device
launches with no host synchronisation (time and step count live on the
host), or on the card, once the AB3 bootstrap is over and the packets are
released, one captured CUDA graph a save interval, replayed
(models/step_graph.py, chosen in coupled.run_lockstep_chunk).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.grid import SpectralGrid, resolve_device
from .dispersion import Dispersion
from .coupled import (CoupledCarry, ModelStep, lockstep_step,
                      ring_packet_ics, run_lockstep_chunk, build_march_spec,
                      march_n_fields, window_threshold)
from .qg2 import (QG2Params, QG2Operators, qg2_init, qg2_step,
                  build_operators, initial_q2_ring, top_layer_flow,
                  max_speed2)

__all__ = ["Coupled2Config", "Coupled2Setup", "setup_coupled2",
           "coupled2_flow_packet_step", "run_coupled2_chunk"]


class Coupled2Config(NamedTuple):
    """Mirrors qg2layersw_raytrace's signature (:1) and hard-coded
    constants (:13, :24-34)."""

    nx: int = 256
    n_packets: int = 50
    near_inertial_factor: float = 2.0
    T_Fr_days: float = 6000.0
    packet_delay_days: float = 1000.0
    U_g: float = 0.4
    f: float = 3.0
    Cg: float = 1.0
    L: float = 20.0                     # qg2layersw_raytrace.m:13
    shear: float = 0.5                  # :28
    beta: float = 0.0
    r: float = 0.4                      # :33
    nu_tune: float = 0.1                # :34
    alpha: int = 4                      # :32
    CFL_fraction: float = 0.25          # :31
    steps_per_save: int = 10
    packet_steps_per_save: int = 25
    n_substeps: int = 2                 # packet substeps per flow step
    stepper: str = "rk23"
    seed: int = 5                       # rng(5), :25
    ring_ic: bool = True
    one_layer_quirk: bool = False       # packet-flow inversion quirk
    dealias: bool = False
    # Fused packet march (ops/march_window.py): gather each packet's
    # margin-widened stencil window ONCE per flow step and run all
    # substeps in one kernel. Engages at n_packets >= window_min_np.
    fused_march: bool = True
    # Windows hold only (u, v); the march forms the velocity-gradient
    # tensor by differentiating the Lagrange interpolant.
    march_uv_windows: bool = True
    # Accepted so that this config mirrors the JAX package's field for
    # field, and read nowhere: the port's march reads (ncells, K) window
    # rows by cell and gathers nothing, whatever it says.
    march_combined_gather: bool = True
    window_min_np: int = 65536
    # Explicit march margin (cells) overriding required_margin's CFL
    # sizing; None = size from dt and the initial max speed.
    march_margin: int | None = None
    march_fused_build: bool = False     # one-kernel window build


class Coupled2Setup(NamedTuple):
    grid: SpectralGrid
    disp: Dispersion
    params: QG2Params
    ops: QG2Operators
    dt: float
    n_steps: int
    packet_delay: float
    Fr: float
    U0: float
    T: float
    march: object | None = None         # march_window.MarchSpec


def setup_coupled2(cfg: Coupled2Config, device=None,
                   dtype: torch.dtype = torch.float32):
    """Grid, operators, ICs, CFL dt (qg2layersw_raytrace.m:13-81).

    `device=None` means the CUDA device and raises when there is none;
    pass `device="cpu"` to run on the CPU. `dtype` is the real dtype of
    the state (spectra are its complex counterpart). The initial maximum
    speed is read back from the device once, here.
    Returns (setup, carry0).
    """
    device = resolve_device(device)
    grid = SpectralGrid.square(cfg.nx, cfg.L)
    disp = Dispersion(f=cfg.f, Cg=cfg.Cg)
    Kd2 = cfg.f / cfg.Cg

    p = QG2Params(Kd2=Kd2, shear=cfg.shear, beta=cfg.beta, r=cfg.r,
                  nu_tune=cfg.nu_tune, alpha=cfg.alpha, dealias=cfg.dealias)
    qk0 = initial_q2_ring(cfg.seed, grid, cfg.U_g, Kd2, ring=cfg.ring_ic,
                          device=device, dtype=dtype)

    # dt from the initial CFL at the reference's rebuild safety factor
    ops_probe = build_operators(grid, p, 1.0)  # B only needed
    U0 = float(max_speed2(qk0, grid, ops_probe, p))
    Fr = U0 / cfg.Cg
    T = (cfg.T_Fr_days / cfg.f) / Fr**2
    dt = 0.5 * cfg.CFL_fraction * grid.dx / U0
    n_steps = int(np.ceil(T / dt))
    packet_delay = cfg.packet_delay_days / cfg.f

    ops = build_operators(grid, p, dt)

    px0, pk0 = ring_packet_ics(cfg, grid, seed=cfg.seed, device=device,
                               dtype=dtype)
    march = build_march_spec(cfg, grid, dt, U0)
    nf0 = march_n_fields(march)
    fields0 = top_layer_flow(qk0, grid, ops, p, cfg.one_layer_quirk,
                             n_fields=nf0).fields
    carry0 = CoupledCarry(flow_state=qg2_init(qk0), packet_x=px0,
                          packet_k=pk0, prev_fields=fields0)
    setup = Coupled2Setup(grid=grid, disp=disp, params=p, ops=ops, dt=dt,
                          n_steps=n_steps, packet_delay=packet_delay,
                          Fr=Fr, U0=U0, T=T, march=march)
    return setup, carry0


def coupled2_flow_packet_step(carry: CoupledCarry, s: Coupled2Setup,
                              cfg: Coupled2Config) -> CoupledCarry:
    """One two-layer lock-step iteration (qg2layersw_raytrace.m:152-197)."""
    nf = march_n_fields(s.march)
    return lockstep_step(
        carry,
        flow_step_fn=lambda st: qg2_step(st, s.grid, s.ops, s.params),
        fields_fn=lambda st: top_layer_flow(
            st.qk, s.grid, s.ops, s.params, cfg.one_layer_quirk,
            n_fields=nf).fields,
        grid=s.grid, disp=s.disp, dt=s.dt, packet_delay=s.packet_delay,
        n_substeps=cfg.n_substeps, stepper=cfg.stepper, march=s.march,
        window_min_np=window_threshold(cfg))


def run_coupled2_chunk(carry: CoupledCarry, s: Coupled2Setup,
                       cfg: Coupled2Config, n_saves: int,
                       remat: bool = False, diag_fn=None):
    """Advance n_saves * packet_steps_per_save flow steps, emitting a
    packet snapshot per save (qg2layersw_raytrace.m:199-209 cadence).

    Returns (carry, (px (n_saves, 2, Np), pk (n_saves, 2, Np),
    t (n_saves,) float64 on the host)). The chunk itself never
    synchronises with the device; `carry.overflow` is a device tensor for
    the caller to read once the chunk is done.

    diag_fn: optional carry -> tensor device diagnostic. When given, each
    save emits (diag, t) INSTEAD of the full packet arrays and the return
    becomes (carry, (diag (n_saves, ...), t (n_saves,))).

    remat=True rematerialises each lock-step in reverse-mode
    differentiation (see run_coupled_chunk)."""
    return run_lockstep_chunk(
        carry, ModelStep(coupled2_flow_packet_step, s, cfg), s.march,
        cfg.packet_steps_per_save, n_saves, remat, diag_fn,
        window_threshold(cfg))
