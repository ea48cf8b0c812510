"""Fused ray march through a frozen gridded flow: the steps in a few kernel
launches, the packets ordered by cell.

Counterpart of swraytracing_tpu/ops/pallas_ray.py. Stepping a frozen flow
with the plain integrator writes the packet state to device memory every
step and launches a gather per step; the kernel marches each packet
through a whole segment of steps in one launch with its state in
registers, and reads the six field grids (u, v, ux, uy, vx, vy) through
the cache. What bounds it on the card is the number of cache lines a
warp's 32 packets ask for with each stencil load, so the packets are
marched in the order of their cells (`packet_cell_keys`), and ordered anew
after every `segment_steps` steps, before neighbours in that order have
drifted apart (`split_steps`). A packet's arithmetic does not depend on
the thread that runs it, and the state crosses a segment boundary in
device memory at full precision: ordered and segmented, the march gives
the bits of one unordered launch.

One device source, hand-written CUDA under kernels/csrc, with the plain
PyTorch versions beside the wrapper here:

  march_rays_cuda  (csrc/march_rays.cu)   plain: march_rays_reference
    the march kernel                        march_rays_reference
    cell_order_cuda (key, histogram,        cell_order_reference
      scatter kernels)                        (packet_cell_keys)
    the segments                            march_rays_segmented_reference

`march_rays` picks by the device of the tensors it is given: CPU tensors
go to the plain version, CUDA tensors to the kernel. Nothing falls back:
on a CUDA tensor the kernel launches or the call raises.

Cites: symplectic splitting ode_symplectic.m:13-37; stencil interpolation
qg_flow_ray_trace/interpolate.m:12-50.
"""

from __future__ import annotations

import torch

from .grid import SpectralGrid
from .interp import _cell_coords
from .march_window import _DTYPE_CODE, _require_cuda

# The entry and its two sides. What else stands in this module (the cell
# key, the ordering, the splitting rule, march_rays_cuda_by) is the inside
# of march_rays_cuda, importable by name for the tests and the smoke run.
__all__ = ["march_rays_reference", "march_rays_cuda", "march_rays"]

_ORDERS = (1, 2, 3)   # stencil half-widths the kernel is instantiated for
_THREADS = 128        # packets per CUDA block
_NODE = 8             # elements per grid node the kernel reads (NODE there)

# How far, in cells, a packet may travel at the fastest group speed before
# the packets are ordered by cell anew. Neighbours in the order carry
# unrelated wavevectors and part at up to twice that speed, so a warp's
# footprint on the grid grows by about twice this many cells over a
# segment. Not a setting: a constant of the kernel's design, read from one
# sweep of the segment length (chip_smoke.py, phase march_rays_segments) at
# one density, 512^2 cells with 2^20 ring-initialised packets (4 a cell) on
# an H100. Other densities have not been measured; the results do not
# depend on it, only the time.
SEGMENT_CELLS = 1.0


def segment_steps(dt: float, grid: SpectralGrid, disp) -> int:
    """The most steps the march takes between two orderings of the packets
    by cell: SEGMENT_CELLS over the cells a packet moves per step at the
    group speed's bound Cg (the flow's own speed, a device value, is left
    out). From host scalars only; at least 1."""
    cells_per_step = disp.Cg * abs(float(dt)) / min(grid.dx, grid.dy)
    if not cells_per_step > 0.0:
        return 2 ** 31 - 1  # nothing moves: one segment
    return max(1, min(2 ** 31 - 1, int(SEGMENT_CELLS / cells_per_step)))


def split_steps(nsteps: int, segment: int) -> list[int]:
    """nsteps as the fewest segments of at most `segment` steps, as even as
    they come (no short tail that pays for an ordering of its own); the
    longer ones first. Empty for nsteps = 0."""
    if segment < 1:
        raise ValueError(f"segment must be at least 1, got {segment}")
    count = -(-int(nsteps) // segment)
    if count == 0:
        return []
    base, longer = divmod(int(nsteps), count)
    return [base + 1] * longer + [base] * (count - longer)


def packet_cell_keys(x, grid: SpectralGrid) -> torch.Tensor:
    """Row-major index i0*ny + j0, int32 in [0, nx*ny), of the cell each
    packet of x (2, Np) stands in: the cell of interp.cell_and_weights
    (x / dx, floored modulo, floor, integer wrap). Plain version of the
    key the histogram kernel of march_rays.cu computes."""
    _, _, i0, j0 = _cell_coords(x[0], x[1], grid)
    # floor of the modulo can be exactly n (a tiny negative x): fold it
    i0 = torch.remainder(i0.to(torch.int32), grid.nx)
    j0 = torch.remainder(j0.to(torch.int32), grid.ny)
    return i0 * grid.ny + j0


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


def march_rays_segmented_reference(fields, x0, k0, grid: SpectralGrid, disp,
                                   dt: float, nsteps: int, order: int = 2,
                                   segment: int | None = None,
                                   ordered: bool = True):
    """Plain version of what march_rays_cuda does around its kernel: the
    steps split by split_steps (segment None: by segment_steps), and each
    segment marched with the packets permuted into the order of their
    cells and the results put back. With ordered=False (the split alone)
    equal to march_rays_reference bit for bit. Ordered, it is equal up to
    the rounding of the stencil sum only: PyTorch's sum on the CPU groups
    its terms by an element's place in the vector, which the kernel on the
    card does not."""
    if segment is None:
        segment = segment_steps(dt, grid, disp)
    x, k = x0, k0
    for steps in split_steps(nsteps, segment):
        if not ordered:
            x, k = march_rays_reference(fields, x, k, grid, disp, dt, steps,
                                        order)
            continue
        perm = cell_order_reference(x, grid)
        xs, ks = march_rays_reference(fields, x[:, perm], k[:, perm], grid,
                                      disp, dt, steps, order)
        x, k = torch.empty_like(xs), torch.empty_like(ks)
        x[:, perm], k[:, perm] = xs, ks
    return x, k


def node_major_fields(fields) -> torch.Tensor:
    """(6, nx, ny) grids as the (nx, ny, 8) array the march kernel reads:
    the six fields of a node side by side, two lanes of padding (one
    aligned 32-byte sector a node in float32)."""
    nodes = fields.new_zeros((*fields.shape[1:], _NODE))
    nodes[..., :6] = fields.permute(1, 2, 0)
    return nodes


def cell_order_reference(x, grid: SpectralGrid) -> torch.Tensor:
    """Plain version of cell_order_cuda: a permutation that sorts the
    packets of x (2, Np) by packet_cell_keys (int64, stable; any order
    inside a cell is as good)."""
    return torch.argsort(packet_cell_keys(x, grid), stable=True)


def cell_order_cuda(x, grid: SpectralGrid) -> torch.Tensor:
    """(Np,) int32 permutation of the packets of x (2, Np) into the order
    of their cells, by a counting sort on the card (march_rays.cu): the
    key and histogram kernel, one cumulative sum over the cells, the
    scatter kernel. The order inside a cell is whatever the atomics give.
    Contiguous float32/float64 CUDA tensor only; launches on the current
    stream and does not synchronise. Counts its orderings (one launch of
    each of the two kernels) in `cell_order_cuda.launches`."""
    from .. import kernels

    Np = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError("cell_order_cuda: x must be float32 or float64, "
                         f"got {x.dtype}")
    _require_cuda("cell_order_cuda", ("x", x, x.dtype, (2, Np)))
    lib = kernels.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        key = torch.empty(Np, dtype=torch.int32, device=x.device)
        count = torch.zeros(grid.nx * grid.ny, dtype=torch.int32,
                            device=x.device)
        kernels.check(lib.swr_rays_cell_histogram(
            _DTYPE_CODE[x.dtype], x.data_ptr(), Np, grid.nx, grid.ny,
            grid.dx, grid.dy, key.data_ptr(), count.data_ptr(), stream),
            "swr_rays_cell_histogram")
        end = torch.cumsum(count, 0, dtype=torch.int32)
        perm = torch.empty_like(key)
        kernels.check(lib.swr_rays_cell_scatter(
            key.data_ptr(), Np, end.data_ptr(), perm.data_ptr(), stream),
            "swr_rays_cell_scatter")
    cell_order_cuda.launches += 1
    return perm


cell_order_cuda.launches = 0


def march_rays_cuda_by(fields, x0, k0, grid: SpectralGrid, disp, dt: float,
                       nsteps: int, order: int = 2, *,
                       segment: int | None = None, ordered: bool = True):
    """march_rays_cuda with the segment length named (None: segment_steps)
    and the ordering by cell switched on or off. Not part of the module's
    interface: it is there to hold the routes against each other and to
    time them. `ordered=False, segment=nsteps` is one
    launch on the packets as they come. The results are the same bits
    whatever is named. Counts as march_rays_cuda does."""
    from .. import kernels

    if x0.dtype not in _DTYPE_CODE:
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
    if segment is None:
        segment = segment_steps(dt, grid, disp)
    segments = split_steps(nsteps, segment)
    if Np == 0 or not segments:  # nothing to launch
        return x0.clone(), k0.clone()
    xN = torch.empty_like(x0)
    kN = torch.empty_like(k0)
    lib = kernels.load()
    entry = lib.swr_march_rays_f32 if x0.dtype == torch.float32 \
        else lib.swr_march_rays_f64
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        nodes = node_major_fields(fields)  # once per call
        x, k = x0, k0  # later segments march xN, kN in place
        for steps in segments:
            perm = cell_order_cuda(x, grid) if ordered else None
            err = entry(
                nodes.data_ptr(), x.data_ptr(), k.data_ptr(),
                xN.data_ptr(), kN.data_ptr(),
                None if perm is None else perm.data_ptr(), Np, grid.nx,
                grid.ny, grid.dx, grid.dy, float(dt), disp.f ** 2, disp.gH,
                steps, order, _THREADS, stream)
            kernels.check(err, "swr_march_rays")
            march_rays_cuda.launches += 1
            x, k = xN, kN
    march_rays_cuda.last_segments = segments
    return xN, kN


def march_rays_cuda(fields, x0, k0, grid: SpectralGrid, disp, dt: float,
                    nsteps: int, order: int = 2):
    """The frozen-flow march on the card (kernels/csrc/march_rays.cu):
    arguments and results as march_rays_reference, contiguous float32 or
    float64 CUDA tensors only, any Np (the kernel masks its last block).
    One thread per packet, state in registers across a segment of steps;
    the steps are split by split_steps(nsteps, segment_steps(...)), and
    before each segment the packets are ordered by cell on the card (a
    counting sort: two small kernels and a cumulative sum), the march
    kernel reading and writing the state through that permutation. The
    kernel reads the grids node-major, so each call first copies `fields`
    into a (nx, ny, 8) scratch tensor (six fields side by side, two lanes
    of padding); copy and ordering are part of the call. Launches on the
    current stream; does not synchronise and reads no device value on the
    host. Counts the march kernel's launches, one per segment, in
    `march_rays_cuda.launches`, and leaves the latest call's segments (steps
    of each) in `march_rays_cuda.last_segments`."""
    return march_rays_cuda_by(fields, x0, k0, grid, disp, dt, nsteps, order)


march_rays_cuda.launches = 0
march_rays_cuda.last_segments = []


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
