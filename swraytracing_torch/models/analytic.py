"""Analytic background flows.

Counterpart of swraytracing_tpu/models/analytic.py: closed-form
streamfunctions used by the reference experiments,
  * the Childress–Soward cellular flow (ray_trace_sw/raytrace.m:31-37,
    rsw/swkU_tc.m:218-220), optionally translating in x at rate `c`
    (the swkU_tc time-dependent background, translation rate raXT);
  * the cellular test flow psi = A cos(x) cos(y) of rsw/testparticles.m;
  * a Gaussian vortex (a steady vorticity well).

Each factory returns a models.fields.AnalyticFlow whose parameters are
0-dim tensors on `device` (None = the CUDA device, raising when there is
none) in `dtype`. A parameter given as a tensor keeps its autograd graph,
so rays are differentiable w.r.t. (U0, km, a, ...).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.grid import resolve_device
from .fields import AnalyticFlow

__all__ = ["childress_soward", "cellular", "vorticity_well", "CS_PARAMS"]

CS_PARAMS = dict(U0=0.1, km=1.0, a=0.25, c=0.0)


def _params(device, dtype, **values):
    device = resolve_device(device)
    return {name: torch.as_tensor(v, dtype=dtype, device=device)
            for name, v in values.items()}


def _cs_psi(x, y, t, p):
    """psi = U0/km * (sin(km x') sin(km y) + a cos(km x') cos(km y)),
    x' = x - c t (c=0 gives the steady flow of raytrace.m:31)."""
    km = p["km"]
    xs = km * (x - p["c"] * t)
    ys = km * y
    return (p["U0"] / km) * (torch.sin(xs) * torch.sin(ys)
                             + p["a"] * torch.cos(xs) * torch.cos(ys))


def childress_soward(U0=0.1, km=1.0, a=0.25, c=0.0, t=0.0, *, device=None,
                     dtype: torch.dtype = torch.float32) -> AnalyticFlow:
    return AnalyticFlow(params=_params(device, dtype, U0=U0, km=km, a=a, c=c),
                        t=t, psi=_cs_psi)


def _cell_psi(x, y, t, p):
    return p["A"] * torch.cos(x) * torch.cos(y)


def cellular(A=1.0, t=0.0, *, device=None,
             dtype: torch.dtype = torch.float32) -> AnalyticFlow:
    """psi = A cos x cos y — closed particle orbits, the reference's
    advection sanity check (rsw/testparticles.m:10-44)."""
    return AnalyticFlow(params=_params(device, dtype, A=A), t=t,
                        psi=_cell_psi)


def _well_psi(x, y, t, p):
    r2 = (x - p["x0"]) ** 2 + (y - p["y0"]) ** 2
    return p["A"] * torch.exp(-r2 / (2.0 * p["sigma"] ** 2))


def vorticity_well(A=0.5, sigma=1.0, x0=np.pi, y0=np.pi, *, device=None,
                   dtype: torch.dtype = torch.float32) -> AnalyticFlow:
    """Gaussian streamfunction vortex ("steady vorticity-well flow",
    BASELINE.json config 2): azimuthal velocity peaking at r = sigma,
    vorticity well at the core."""
    return AnalyticFlow(params=_params(device, dtype, A=A, sigma=sigma,
                                       x0=x0, y0=y0), psi=_well_psi)
