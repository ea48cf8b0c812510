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

The x-k-a march of the RSW restart workflow (ray_trace_sw/raytrace_sw.m)
is the same design for another stepper: step_packet_xka's RK4 on the
position, the wavevector and the wave action, through the six grids and
the depth factor H = 1 + eta_g (seven grids), four stencil evaluations a
step where the Strang step takes one; its packets carry the action a
besides x and k, and the ordering permutes it too.

Two device sources, hand-written CUDA under kernels/csrc (sharing
csrc/rays_stencil.cuh), with the plain PyTorch versions beside the
wrappers here:

  march_rays_cuda  (csrc/march_rays.cu)   plain: march_rays_reference
    the march kernel                        march_rays_reference
    cell_order_cuda (key, histogram,        cell_order_reference
      scatter kernels)                        (packet_cell_keys)
    the segments                            march_rays_segmented_reference
  march_xka_cuda   (csrc/march_xka.cu)    plain: march_xka_reference
    the x-k-a march kernel, the same        march_xka_segmented_reference
      ordering and segments

`march_rays` and `march_xka` pick by the device of the tensors they are
given: CPU tensors go to the plain version, CUDA tensors to the kernel.
Nothing falls back: on a CUDA tensor the kernel launches or the call
raises.

Cites: symplectic splitting ode_symplectic.m:13-37; the x-k-a step
ray_trace_sw/step_packet_xka.m:38-91 and cg_sw.m; stencil interpolation
qg_flow_ray_trace/interpolate.m:12-50.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .grid import SpectralGrid
from .interp import _cell_coords
from .march_window import _DTYPE_CODE, _require_cuda

# The entries and their two sides. What else stands in this module (the cell
# key, the ordering, the splitting rule, march_rays_cuda_by) is the inside
# of march_rays_cuda, importable by name for the tests and the smoke run.
__all__ = ["march_rays_reference", "march_rays_cuda", "march_rays",
           "march_xka_reference", "march_xka_cuda", "march_xka"]

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
    return _segmented_reference(
        lambda state, steps: march_rays_reference(fields, *state, grid, disp,
                                                  dt, steps, order),
        (x0, k0), grid, disp, dt, nsteps, segment, ordered)


def _segmented_reference(march, state, grid: SpectralGrid, disp, dt: float,
                         nsteps: int, segment: int | None, ordered: bool):
    """The segments of march_rays_segmented_reference and
    march_xka_segmented_reference: the steps split by split_steps (segment
    None: by segment_steps), each segment one call march(state, steps),
    ordered by cell with every packet tensor of `state` (x (2, Np) first,
    the packet on the last axis) permuted in and put back."""
    if segment is None:
        segment = segment_steps(dt, grid, disp)
    for steps in split_steps(nsteps, segment):
        if not ordered:
            state = march(state, steps)
            continue
        perm = cell_order_reference(state[0], grid)
        moved = march(tuple(t[..., perm] for t in state), steps)
        state = tuple(torch.empty_like(t) for t in moved)
        for t, m in zip(state, moved):
            t[..., perm] = m
    return state


def node_major_fields(fields) -> torch.Tensor:
    """(nf, nx, ny) grids, nf <= 8, as the (nx, ny, 8) array the ray march
    kernels read: the fields of a node side by side, the lanes past nf
    zero (one aligned 32-byte sector a node in float32). K4 reads six
    (two lanes of padding), the x-k-a march seven (H in lane 6)."""
    if fields.shape[0] > _NODE:
        raise ValueError(f"at most {_NODE} fields a node, got "
                         f"{fields.shape[0]}")
    nodes = fields.new_zeros((*fields.shape[1:], _NODE))
    nodes[..., :fields.shape[0]] = fields.permute(1, 2, 0)
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
    return _march_cuda_segments(
        march_rays_cuda, "swr_march_rays", 6, fields,
        (("x0", x0, (2,)), ("k0", k0, (2,))), (disp.f ** 2, disp.gH), grid,
        disp, dt, nsteps, order, segment, ordered)


def _march_cuda_segments(wrapper, entry: str, nf: int, fields, state,
                         consts, grid: SpectralGrid, disp, dt: float,
                         nsteps: int, order: int, segment: int | None,
                         ordered: bool):
    """The march on the card around one kernel, as march_rays_cuda_by and
    march_xka_cuda_by run it: the checks, the split of the steps, the nf
    grids copied node-major once, then for each segment an ordering of the
    packets by cell and one launch of the C entry `entry` (its _f32 or
    _f64 form), the later segments marching the results in place.
    `state` holds (key, tensor, leading shape) for each packet tensor, x
    first: the kernel reads them through the permutation, in this order,
    and writes fresh tensors of their shapes; `consts` are the entry's
    scalars after dt. Counts the launches in `wrapper.launches` and leaves
    the segments in `wrapper.last_segments`."""
    from .. import kernels

    name = wrapper.__name__
    x0 = state[0][1]
    if x0.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x0 must be float32 or float64, "
                         f"got {x0.dtype}")
    if order not in _ORDERS:
        raise ValueError(f"{name} has kernels for order in {_ORDERS}, "
                         f"got {order}")
    Np = x0.shape[-1]
    _require_cuda(name, ("fields", fields, x0.dtype, (nf, grid.nx, grid.ny)),
                  *((key, t, x0.dtype, (*lead, Np)) for key, t, lead in state))
    if segment is None:
        segment = segment_steps(dt, grid, disp)
    segments = split_steps(nsteps, segment)
    ins = [t for _, t, _ in state]
    if Np == 0 or not segments:  # nothing to launch
        return tuple(t.clone() for t in ins)
    outs = [torch.empty_like(t) for t in ins]
    lib = kernels.load()
    launch = getattr(lib, entry + ("_f32" if x0.dtype == torch.float32
                                   else "_f64"))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        nodes = node_major_fields(fields)  # once per call
        for steps in segments:
            perm = None
            if ordered:
                with span("swr.rays.order"):
                    perm = cell_order_cuda(ins[0], grid)
            err = launch(
                nodes.data_ptr(), *(t.data_ptr() for t in ins),
                *(t.data_ptr() for t in outs),
                None if perm is None else perm.data_ptr(), Np, grid.nx,
                grid.ny, grid.dx, grid.dy, float(dt), *consts, steps, order,
                _THREADS, stream)
            kernels.check(err, entry)
            wrapper.launches += 1
            ins = outs
    wrapper.last_segments = segments
    return tuple(outs)


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


# -- the x-k-a march (step_packet_xka) ---------------------------------------

def march_xka_reference(fields, x0, k0, a0, grid: SpectralGrid, disp,
                        dt: float, nsteps: int, order: int = 2):
    """Plain PyTorch x-k-a march with identical semantics (any device):
    nsteps models/rays.rk4_xka_step calls on a GriddedFlow of the six
    velocity grids, with the depth grid H. The plain version of
    march_xka_cuda and the CPU path.

    Args:
      fields: (7, nx, ny) stacked [u, v, ux, uy, vx, vy, H].
      x0, k0: (2, Np) coordinate-first; a0: (Np,) wave action.
    Returns (xN, kN, aN).
    """
    from ..models.fields import GriddedFlow
    from ..models.rays import rk4_xka_step

    flow = GriddedFlow(fields=fields[:6], grid=grid, order=order)
    x, k, a = x0, k0, a0
    for _ in range(nsteps):
        x, k, a = rk4_xka_step(x, k, a, dt, disp, flow, H=fields[6])
    return x, k, a


def march_xka_segmented_reference(fields, x0, k0, a0, grid: SpectralGrid,
                                  disp, dt: float, nsteps: int,
                                  order: int = 2, segment: int | None = None,
                                  ordered: bool = True):
    """Plain version of what march_xka_cuda does around its kernel, as
    march_rays_segmented_reference is of march_rays_cuda: the steps split
    by split_steps, each segment marched with the packets (x, k and a)
    permuted into the order of their cells and the results put back."""
    return _segmented_reference(
        lambda state, steps: march_xka_reference(fields, *state, grid, disp,
                                                 dt, steps, order),
        (x0, k0, a0), grid, disp, dt, nsteps, segment, ordered)


def march_xka_cuda_by(fields, x0, k0, a0, grid: SpectralGrid, disp,
                      dt: float, nsteps: int, order: int = 2, *,
                      segment: int | None = None, ordered: bool = True):
    """march_xka_cuda with the segment length named (None: segment_steps)
    and the ordering by cell switched on or off, as march_rays_cuda_by is
    for K4: there to hold the routes against each other and to time them.
    The results are the same bits whatever is named. Counts as
    march_xka_cuda does."""
    return _march_cuda_segments(
        march_xka_cuda, "swr_march_xka", 7, fields,
        (("x0", x0, (2,)), ("k0", k0, (2,)), ("a0", a0, ())),
        (disp.f, disp.gH), grid, disp, dt, nsteps, order, segment, ordered)


def march_xka_cuda(fields, x0, k0, a0, grid: SpectralGrid, disp, dt: float,
                   nsteps: int, order: int = 2):
    """The x-k-a march on the card (kernels/csrc/march_xka.cu): arguments
    and results as march_xka_reference, contiguous float32 or float64 CUDA
    tensors only, any Np. One thread per packet, x, k and a in registers
    across a segment of steps; the steps split and the packets ordered by
    cell before each segment as in march_rays_cuda (K4's counting sort),
    the kernel reading and writing x, k and a through that permutation.
    Each call first copies `fields` into a (nx, ny, 8) node-major scratch
    tensor (H in lane 6). Launches on the current stream; does not
    synchronise and reads no device value on the host. Counts its launches,
    one per segment, in `march_xka_cuda.launches`, and leaves the latest
    call's segments in `march_xka_cuda.last_segments`."""
    return march_xka_cuda_by(fields, x0, k0, a0, grid, disp, dt, nsteps,
                             order)


march_xka_cuda.launches = 0
march_xka_cuda.last_segments = []


def march_xka(fields, x0, k0, a0, grid: SpectralGrid, disp, dt: float,
              nsteps: int, order: int = 2):
    """March all packets nsteps x-k-a steps through a frozen RSW frame's
    seven grids: the CUDA kernel on CUDA tensors, march_xka_reference on
    CPU tensors. Forward only; differentiate march_xka_reference.

    Args:
      fields: (7, nx, ny) stacked [u, v, ux, uy, vx, vy, H].
      x0, k0: (2, Np); a0: (Np,).
    Returns (xN, kN, aN).
    """
    if x0.is_cuda:
        return march_xka_cuda(fields, x0, k0, a0, grid, disp, dt, nsteps,
                              order)
    return march_xka_reference(fields, x0, k0, a0, grid, disp, dt, nsteps,
                               order)
