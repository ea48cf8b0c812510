"""Fused ray march through a frozen gridded flow: all steps in one kernel.

Counterpart of swraytracing_tpu/ops/pallas_ray.py. Stepping a frozen flow
with the plain integrator writes the packet state to device memory every
step and launches a gather per step; the kernel marches each packet
through ALL steps in one launch with its state in registers, so device
memory sees the packet state once in and once out, and the six field
grids (u, v, ux, uy, vx, vy) through the cache.

One device kernel, hand-written CUDA under kernels/csrc, with its plain
PyTorch version beside its wrapper here:

  march_rays_cuda  (csrc/march_rays.cu)   plain: march_rays_reference

`march_rays` picks by the device of the tensors it is given: CPU tensors
go to the plain version, CUDA tensors to the kernel. Nothing falls back:
on a CUDA tensor the kernel launches or the call raises.

Cites: symplectic splitting ode_symplectic.m:13-37; stencil interpolation
qg_flow_ray_trace/interpolate.m:12-50.
"""

from __future__ import annotations

import torch

from .grid import SpectralGrid
from .march_window import _require_cuda

__all__ = ["march_rays_reference", "march_rays_cuda", "march_rays"]

_ORDERS = (1, 2, 3)   # stencil half-widths the kernel is instantiated for
_THREADS = 128        # packets per CUDA block
_NODE = 8             # elements per grid node the kernel reads (NODE there)


def march_rays_reference(fields, x0, k0, grid: SpectralGrid, disp,
                         dt: float, nsteps: int, order: int = 2):
    """Plain PyTorch march with identical semantics (any device): nsteps
    symplectic_step calls on a GriddedFlow. The plain version of
    march_rays_cuda and the CPU path.

    Args:
      fields: (6, nx, ny) stacked [u, v, ux, uy, vx, vy].
      x0, k0: (2, Np) coordinate-first.
    Returns (xN, kN).
    """
    from ..models.fields import GriddedFlow
    from ..models.rays import symplectic_step

    flow = GriddedFlow(fields=fields, grid=grid, order=order)
    x, k = x0, k0
    for _ in range(nsteps):
        x, k = symplectic_step(x, k, dt, disp, flow)
    return x, k


def march_rays_cuda(fields, x0, k0, grid: SpectralGrid, disp, dt: float,
                    nsteps: int, order: int = 2):
    """The frozen-flow march on the card (kernels/csrc/march_rays.cu):
    arguments and results as march_rays_reference, contiguous float32 or
    float64 CUDA tensors only, any Np (the kernel masks its last block).
    One thread per packet, state in registers across all steps. The
    kernel reads the grids node-major, so each call first copies `fields`
    into a (nx, ny, 8) scratch tensor (six fields side by side, two lanes
    of padding); that copy is part of the call. Launches on the current
    stream and does not synchronise. Counts its launches in
    `march_rays_cuda.launches`."""
    from .. import kernels

    if x0.dtype not in (torch.float32, torch.float64):
        raise ValueError("march_rays_cuda: x0 must be float32 or float64, "
                         f"got {x0.dtype}")
    if order not in _ORDERS:
        raise ValueError(f"march_rays_cuda has kernels for order in "
                         f"{_ORDERS}, got {order}")
    Np = x0.shape[-1]
    _require_cuda("march_rays_cuda",
                  ("fields", fields, x0.dtype, (6, grid.nx, grid.ny)),
                  ("x0", x0, x0.dtype, (2, Np)),
                  ("k0", k0, x0.dtype, (2, Np)))
    xN = torch.empty_like(x0)
    kN = torch.empty_like(k0)
    if Np == 0:  # nothing to launch
        return xN, kN
    lib = kernels.load()
    entry = lib.swr_march_rays_f32 if x0.dtype == torch.float32 \
        else lib.swr_march_rays_f64
    with torch.cuda.device(x0.device):
        nodes = fields.new_zeros((grid.nx, grid.ny, _NODE))
        nodes[..., :6] = fields.permute(1, 2, 0)
        err = entry(
            nodes.data_ptr(), x0.data_ptr(), k0.data_ptr(),
            xN.data_ptr(), kN.data_ptr(), Np, grid.nx, grid.ny,
            grid.dx, grid.dy, float(dt), disp.f ** 2, disp.gH,
            int(nsteps), order, _THREADS,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "swr_march_rays")
    march_rays_cuda.launches += 1
    return xN, kN


march_rays_cuda.launches = 0


def march_rays(fields, x0, k0, grid: SpectralGrid, disp, dt: float,
               nsteps: int, order: int = 2):
    """March all packets nsteps symplectic steps through a frozen
    GriddedFlow's fields: the CUDA kernel on CUDA tensors,
    march_rays_reference on CPU tensors. Forward only (as the TPU kernel
    it replaces); differentiate march_rays_reference.

    Args:
      fields: (6, nx, ny) stacked [u, v, ux, uy, vx, vy].
      x0, k0: (2, Np).
    Returns (xN, kN).
    """
    if x0.is_cuda:
        return march_rays_cuda(fields, x0, k0, grid, disp, dt, nsteps, order)
    return march_rays_reference(fields, x0, k0, grid, disp, dt, nsteps,
                                order)
