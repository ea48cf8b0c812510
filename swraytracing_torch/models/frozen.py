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

`raytrace_frozen` takes one of two routes by what it can see, and counts
each in `raytrace_frozen.routes`. On the kernel route (CUDA packets,
float32 or float64, a GriddedFlow of six grids with a stencil order the
kernel is built for, the symplectic stepper) each save interval is one
call of ops/march_rays.march_rays, the march kernel (K4) with the packets
ordered by cell. On the plain route (everything else: CPU tensors,
analytic or blended flows, the other three integrators) it steps with the
plain integrators of models/rays.py, as the JAX package does (through
prebuilt windows from 65536 packets on). `raytrace_rsw_restart` takes one
of two routes the same way (`rsw_route`, counted in
`raytrace_rsw_restart.routes`) by the device alone: on a CUDA device, one
call a frame of ops/march_rays.march_xka, the x-k-a march kernel with the
packets ordered by cell (a dtype it has no kernel for raises there); on
the CPU its plain version march_xka_reference, the rays.rk4_xka_step loop
through the stencil. Its seven grids (the
geostrophic velocity, its gradients, the depth factor H) come from
`rsw_restart_fields`.

The port's spans (utils/profiling.span, off unless a spans() or trace()
block is open): swr.frozen (a raytrace_frozen call), swr.frozen.march
(each march_rays call of the kernel route) and swr.frozen.diag (a frame's
omega and Omega_abs, both routes); swr.rsw (a raytrace_rsw_restart call),
swr.rsw.fields (its seven grids) and swr.rsw.march (each march call,
either route); inside march_rays and march_xka, ops/march_rays opens
swr.rays.order around each ordering by cell.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..io import binio
from ..ops.grid import SpectralGrid, as_tensor, resolve_device
from ..ops import interp as _interp
from ..ops import march_rays as _march_rays
from ..ops import spectral as sp
from ..utils.profiling import span
from .dispersion import Dispersion
from .fields import GriddedFlow, flow_from_qk
from . import rays

__all__ = ["FrozenResult", "raytrace_frozen", "raytrace_pv_snapshot",
           "raytrace_rsw_restart", "rsw_restart_fields", "ring_ics"]


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


# Calls of raytrace_frozen by route, also raytrace_frozen.routes (a dict
# of the module, so a wrapper put in the function's place counts the same)
_ROUTES_TAKEN = {"kernel": 0, "plain": 0}


def frozen_route(flow, x0, k0, stepper: str) -> str:
    """The route raytrace_frozen takes: "kernel" for CUDA packets in
    float32 or float64 marched by the symplectic stepper through a
    GriddedFlow of six grids, of their dtype and device, whose stencil
    order the march kernel is built for (ops/march_rays._ORDERS); "plain"
    for everything else."""
    if not (stepper == "symplectic" and isinstance(flow, GriddedFlow)
            and x0.is_cuda and x0.dtype in (torch.float32, torch.float64)
            and flow.order in _march_rays._ORDERS):
        return "plain"
    grid = flow.grid
    same = all(t.dtype == x0.dtype and t.device == x0.device
               for t in (k0, flow.fields))
    six = tuple(flow.fields.shape) == (6, grid.nx, grid.ny)
    return "kernel" if same and six else "plain"


def raytrace_frozen(flow, x0, k0, disp: Dispersion, dt: float, nsteps: int,
                    save_every: int = 1, stepper: str = "symplectic"
                    ) -> FrozenResult:
    """Integrate packets through a steady flow and collect the
    conservation diagnostics: nsteps // save_every frames, one after each
    save_every steps (steps past the last whole frame are not taken). Runs
    on the device of x0, by the route frozen_route gives.

    The kernel route marches each frame's save_every steps in one call of
    ops/march_rays.march_rays (the kernel's segments and orderings inside
    it), and evaluates Omega_abs through the stencil on the velocity grids
    alone: on one H100 at 2^20 packets 2.0 ms an evaluation, against 4.0
    ms through the six grids and 14.1 ms a call for windows built once and
    read five times. On the plain route a GriddedFlow without windows gets
    them prebuilt from ops.interp._WINDOW_MIN_NP packets on (the JAX
    package's switch): the build amortises over the whole run, and each
    evaluation gathers one row a packet. On one H100 at 512^2 and 2^20
    packets, 20 steps in float32, the windowed run took 0.73 of the
    stencil's time, build included (chip_smoke.py, phase analytic_path)."""
    with span("swr.frozen"):
        route = frozen_route(flow, x0, k0, stepper)
        _ROUTES_TAKEN[route] += 1
        if route == "kernel":
            return _frozen_kernel(flow, x0, k0, disp, dt, nsteps, save_every)
        return _frozen_plain(flow, x0, k0, disp, dt, nsteps, save_every,
                             stepper)


raytrace_frozen.routes = _ROUTES_TAKEN


def _frozen_kernel(flow, x0, k0, disp, dt, nsteps, save_every):
    """The kernel route of raytrace_frozen: one march_rays call a frame
    (on CPU tensors march_rays runs its plain version, which the tests
    hold this route's frames to)."""
    fields, grid = flow.fields.contiguous(), flow.grid
    x, k = x0.contiguous(), k0.contiguous()
    xs, ks = [], []
    for _ in range(nsteps // save_every):
        with span("swr.frozen.march"):
            x, k = _march_rays.march_rays(fields, x, k, grid, disp, dt,
                                          save_every, flow.order)
        xs.append(x)
        ks.append(k)
    empty = x0.new_zeros((0,) + tuple(x0.shape))
    ts = torch.tensor([(j + 1) * save_every * dt for j in range(len(xs))],
                      dtype=torch.float64)

    def abs_at(x, k):
        return disp.absolute_frequency(
            k, torch.stack(flow.velocity_at(x[0], x[1])))

    return _diagnosed(disp, abs_at, x0, k0,
                      torch.stack(xs) if xs else empty,
                      torch.stack(ks) if ks else empty, ts)


def _frozen_plain(flow, x0, k0, disp, dt, nsteps, save_every, stepper):
    """The plain route of raytrace_frozen: the integrator's steps one by
    one (models/rays.integrate_rays)."""
    if (isinstance(flow, GriddedFlow) and flow.win is None
            and x0.shape[-1] >= _interp._WINDOW_MIN_NP):
        flow = flow.windowed()
    step = _STEPPERS[stepper]
    xs, ks, ts = rays.integrate_rays(
        x0, k0, dt, nsteps, lambda x, k, t: step(x, k, dt, disp, flow),
        save_every=save_every)

    def abs_at(x, k):
        return disp.absolute_frequency(k, flow.at(x[0], x[1]).uv)

    return _diagnosed(disp, abs_at, x0, k0, xs, ks, ts)


def _diagnosed(disp, abs_at, x0, k0, xs, ks, ts) -> FrozenResult:
    """The frames xs, ks (nframes, 2, Np) at times ts with their omega and
    Omega_abs, and Omega_abs at the start, through abs_at(x, k)."""
    with span("swr.frozen.diag"):
        om_abs0 = abs_at(x0, k0)
    nframes = xs.shape[0]
    empty = x0.new_zeros((0, x0.shape[-1]))
    # frame by frame: the stencil gather of one frame is already
    # 36 * 6 values per packet
    om, om_abs = [], []
    for j in range(nframes):
        with span("swr.frozen.diag"):
            om.append(disp.omega(ks[j]))
            om_abs.append(abs_at(xs[j], ks[j]))
    return FrozenResult(x=xs, k=ks, t=ts,
                        omega=torch.stack(om) if nframes else empty,
                        omega_abs0=om_abs0,
                        omega_abs=torch.stack(om_abs) if nframes else empty)


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


def rsw_restart_fields(u, v, h, grid: SpectralGrid, p) -> torch.Tensor:
    """The seven grids the x-k-a march reads from an RSW (u, v, h) state
    (raytrace_sw.m:25-53): the wave/vortex decomposition's geostrophic
    part (models/rsw.wave_vortex_decompose), its four velocity gradients
    by spectral differentiation, and the depth factor H = 1 + eta_g.
    Returns (7, nx, ny) [ug, vg, ug_x, ug_y, vg_x, vg_y, H] on the device
    and in the dtype of u; p is the RSWParams (f, Cg)."""
    from .rsw import wave_vortex_decompose

    (ug, vg, hg), _ = wave_vortex_decompose(u, v, h, grid, p)
    Sk = sp.to_spectral(torch.stack([ug, vg]), grid)
    return torch.cat([
        torch.stack([ug, vg]),
        sp.to_grid(torch.stack([sp.ddx(Sk[0], grid), sp.ddy(Sk[0], grid),
                                sp.ddx(Sk[1], grid), sp.ddy(Sk[1], grid)]),
                   grid),
        (1.0 + hg)[None]])


# Calls of raytrace_rsw_restart by route, also raytrace_rsw_restart.routes
_RSW_ROUTES_TAKEN = {"kernel": 0, "plain": 0}


def rsw_route(device) -> str:
    """The route raytrace_rsw_restart takes: "kernel" on a CUDA device,
    whatever the dtype (the kernel's wrapper raises for one it has no
    kernel for: nothing falls back to the plain route on the card);
    "plain" on the CPU."""
    return "kernel" if torch.device(device).type == "cuda" else "plain"


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
    the host; nsteps // save_every frames, one after each save_every
    steps. The stencil is the reference's Iord = 2.

    The seven grids come from rsw_restart_fields, once a call. Each frame
    is then one march call, by the route rsw_route gives (counted in
    raytrace_rsw_restart.routes): on the kernel route
    ops/march_rays.march_xka, the x-k-a kernel with the packets ordered by
    cell; on the plain route its plain version march_xka_reference, the
    rk4_xka_step loop through the stencil. On one H100 at 512^2 and 2^20
    packets the plain route took about 14 ms a step (chip_smoke.py, phase
    solvers_path)."""
    from .rsw import RSWParams

    with span("swr.rsw"):
        device = resolve_device(device)
        route = rsw_route(device)
        _RSW_ROUTES_TAKEN[route] += 1

        def tensor(a):
            return as_tensor(a, dtype, device)

        with span("swr.rsw.fields"):
            fields = rsw_restart_fields(tensor(u), tensor(v), tensor(h),
                                        grid, RSWParams(f=disp.f, Cg=disp.Cg))
        x, k = tensor(x0).contiguous(), tensor(k0).contiguous()
        a = (torch.ones_like(x[0]) if a0 is None
             else tensor(a0).contiguous())
        march = (_march_rays.march_xka if route == "kernel"
                 else _march_rays.march_xka_reference)
        xs, ks, as_ = [], [], []
        nframes = nsteps // save_every
        for _ in range(nframes):
            with span("swr.rsw.march"):
                x, k, a = march(fields, x, k, a, grid, disp, dt, save_every)
            xs.append(x)
            ks.append(k)
            as_.append(a)
        ts = torch.tensor([dt * save_every * (1 + j) for j in range(nframes)],
                          dtype=torch.float64)

        def stack(frames, like):
            return (torch.stack(frames) if frames
                    else like.new_zeros((0,) + tuple(like.shape)))

        return stack(xs, x), stack(ks, k), stack(as_, a), ts


raytrace_rsw_restart.routes = _RSW_ROUTES_TAKEN
