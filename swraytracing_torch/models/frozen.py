"""Frozen-flow raytracing.

Counterpart of `raytrace_frozen`, `raytrace_pv_snapshot` and `ring_ics`
of swraytracing_tpu/models/frozen.py:
  * `raytrace_frozen` — packets through a STEADY flow (analytic or
    gridded) with any of the four integrators, reporting the
    absolute-frequency conservation error dOmega/Omega0 — the reference's
    primary integrator-correctness metric
    (SW_zero_background_raytracing.m:85-132, symplectic_full_fourier.m);
  * `raytrace_pv_snapshot` — loads a PV frame from a frame-addressed .bin
    (the reference's or ours), inverts it to a streamfunction as
    SW_zero_background_raytracing.m:26-30 does (psi_k = -q_k/(K_d^2 +
    K^2)), and raytraces through the frozen gridded flow;
  * `raytrace_rsw_restart` — the ray_trace_sw/raytrace_sw.m workflow:
    wave/vortex-decompose an RSW (u, v, h) state, advect packets with the
    geostrophic part + spatially varying depth H = 1 + eta_g using the
    x-k-a stepper with the wave-action equation (step_packet_xka.m:63-91).

As in the JAX package, `raytrace_frozen` steps with the plain integrators
of models/rays.py (through prebuilt windows from 65536 packets on), and
`raytrace_rsw_restart` with rays.rk4_xka_step through the stencil; the
one-kernel march of a frozen flow is ops/march_rays.march_rays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..io import binio
from ..ops.grid import SpectralGrid, as_tensor, resolve_device
from ..ops import interp as _interp
from ..ops import spectral as sp
from .dispersion import Dispersion
from .fields import GriddedFlow, flow_from_qk
from . import rays

__all__ = ["FrozenResult", "raytrace_frozen", "raytrace_pv_snapshot",
           "raytrace_rsw_restart", "ring_ics"]


class FrozenResult(NamedTuple):
    x: torch.Tensor            # (nframes, 2, Np) coordinate-first
    k: torch.Tensor            # (nframes, 2, Np)
    t: torch.Tensor            # (nframes,) float64 on the host
    omega: torch.Tensor        # (nframes, Np) intrinsic frequency
    omega_abs0: torch.Tensor   # (Np,) initial absolute frequency
    omega_abs: torch.Tensor    # (nframes, Np)

    @property
    def conservation_error(self):
        """max |dOmega_abs / Omega_abs(0)| per frame — the
        SW_zero_background_raytracing.m:85-132 metric."""
        return torch.amax(torch.abs((self.omega_abs - self.omega_abs0[None])
                                    / self.omega_abs0[None]), dim=-1)


def ring_ics(n_packets: int, w0: float, disp: Dispersion, L=2 * np.pi,
             seed: int = 146, *, device=None,
             dtype: torch.dtype = torch.float32):
    """Near-inertial ring ICs: |k| = sqrt((w0^2-1) f^2/Cg^2), equally
    spaced angles, uniform random positions from ``np.random.default_rng``
    (qgsw_raytrace.m:54-60). Returns x0, k0 as (2, Np) coordinate-first
    tensors on `device` (None = the CUDA device; raises when there is
    none)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    i = np.arange(1, n_packets + 1)
    kr = np.sqrt((w0**2 - 1.0) * disp.f**2 / disp.Cg**2)
    k0 = kr * np.stack([np.cos(2 * np.pi * i / n_packets),
                        np.sin(2 * np.pi * i / n_packets)], 0)
    x0 = rng.uniform(0.0, L, (2, n_packets))
    return (torch.as_tensor(x0, dtype=dtype, device=device),
            torch.as_tensor(k0, dtype=dtype, device=device))


_STEPPERS = {
    "symplectic": rays.symplectic_step,
    "yoshida4": rays.yoshida4_step,
    "rk4": rays.rk4_step,
    "rk23": rays.rk23_step,
}


def raytrace_frozen(flow, x0, k0, disp: Dispersion, dt: float, nsteps: int,
                    save_every: int = 1, stepper: str = "symplectic"
                    ) -> FrozenResult:
    """Integrate packets through a steady flow and collect the
    conservation diagnostics. Runs on the device of x0.

    A GriddedFlow without windows gets them prebuilt from
    ops.interp._WINDOW_MIN_NP packets on (the JAX package's switch): the
    build amortises over the whole run, and each evaluation gathers one
    row a packet. On one H100 at 512^2 and 2^20 packets, 20 steps in
    float32, the windowed run took 0.73 of the stencil's time, build
    included (chip_smoke.py, phase analytic_path)."""
    if (isinstance(flow, GriddedFlow) and flow.win is None
            and x0.shape[-1] >= _interp._WINDOW_MIN_NP):
        flow = flow.windowed()
    step = _STEPPERS[stepper]
    xs, ks, ts = rays.integrate_rays(
        x0, k0, dt, nsteps, lambda x, k, t: step(x, k, dt, disp, flow),
        save_every=save_every)

    def abs_at(x, k):
        return disp.absolute_frequency(k, flow.at(x[0], x[1]).uv)

    om_abs0 = abs_at(x0, k0)
    nframes = xs.shape[0]
    empty = x0.new_zeros((0, x0.shape[-1]))
    # frame by frame: the stencil gather of one frame is already
    # 36 * 6 values per packet
    om = (torch.stack([disp.omega(ks[j]) for j in range(nframes)])
          if nframes else empty)
    om_abs = (torch.stack([abs_at(xs[j], ks[j]) for j in range(nframes)])
              if nframes else empty)
    return FrozenResult(x=xs, k=ks, t=ts, omega=om, omega_abs0=om_abs0,
                        omega_abs=om_abs)


def raytrace_pv_snapshot(pv_path, frame: int, nx: int, Kd2: float,
                         disp: Dispersion, n_packets: int = 50,
                         w0: float = 2.0, dt: float = 1e-3,
                         nsteps: int = 1000, save_every: int = 10,
                         stepper: str = "symplectic", L=2 * np.pi,
                         seed: int = 146, *, device=None,
                         dtype: torch.dtype = torch.float32
                         ) -> FrozenResult:
    """Frozen-PV-frame raytracing (SW_zero_background_raytracing.m): read
    PV grid frame `frame` (1-based) of an (nx, nx) .bin, invert it, trace
    rays from ring_ics. Runs on `device` (None = the CUDA device; raises
    when there is none) in `dtype`."""
    device = resolve_device(device)
    q = binio.read_field(pv_path, nx, nx, frames=frame)
    grid = SpectralGrid.square(nx, L)
    qk = sp.to_spectral(torch.as_tensor(q, dtype=dtype, device=device), grid)
    flow = GriddedFlow(fields=flow_from_qk(qk, grid, Kd2).fields, grid=grid)
    x0, k0 = ring_ics(n_packets, w0, disp, L, seed, device=device,
                      dtype=dtype)
    return raytrace_frozen(flow, x0, k0, disp, dt, nsteps, save_every,
                           stepper)


def raytrace_rsw_restart(u, v, h, disp: Dispersion, grid: SpectralGrid,
                         x0, k0, a0=None, dt: float = 1e-3,
                         nsteps: int = 1000, save_every: int = 10, *,
                         device=None, dtype: torch.dtype = torch.float32):
    """raytrace_sw.m workflow: wave/vortex-decompose (u, v, h), advect
    packets through the geostrophic flow with depth refraction and the
    wave-action equation (step_packet_xka semantics).

    u, v, h (grids), x0, k0 ((2, Np)) and a0 ((Np,), default ones) are
    numpy arrays or tensors, taken to `device` (None = the CUDA device;
    raises when there is none) in `dtype`. Returns (x, k, a, t) frame
    stacks: (nf, 2, Np) x2 and (nf, Np) on the device, t (nf,) float64 on
    the host.
    """
    from .rsw import RSWParams, wave_vortex_decompose

    device = resolve_device(device)

    def tensor(a):
        return as_tensor(a, dtype, device)

    p = RSWParams(f=disp.f, Cg=disp.Cg)
    (ug, vg, hg), _ = wave_vortex_decompose(tensor(u), tensor(v),
                                            tensor(h), grid, p)
    # geostrophic velocity-gradient grids from the decomposed flow
    Sk = sp.to_spectral(torch.stack([ug, vg]), grid)
    fields = torch.cat([
        torch.stack([ug, vg]),
        sp.to_grid(torch.stack([sp.ddx(Sk[0], grid), sp.ddy(Sk[0], grid),
                                sp.ddx(Sk[1], grid), sp.ddy(Sk[1], grid)]),
                   grid)])
    H = 1.0 + hg
    flow = GriddedFlow(fields=fields, grid=grid)
    x, k = tensor(x0), tensor(k0)
    a = torch.ones_like(x[0]) if a0 is None else tensor(a0)

    xs, ks, as_ = [], [], []
    nframes = nsteps // save_every
    for _ in range(nframes):
        for _ in range(save_every):
            x, k, a = rays.rk4_xka_step(x, k, a, dt, disp, flow, H=H)
        xs.append(x)
        ks.append(k)
        as_.append(a)
    ts = torch.tensor([dt * save_every * (1 + j) for j in range(nframes)],
                      dtype=torch.float64)

    def stack(frames, like):
        return (torch.stack(frames) if frames
                else like.new_zeros((0,) + tuple(like.shape)))

    return stack(xs, x), stack(ks, k), stack(as_, a), ts
