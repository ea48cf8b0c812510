"""Operations and bytes of the frozen-flow march (K4), counted from the
algorithm, not from any kernel's layout.

Operations: the plain algorithm's floating-point operations for one
packet over one Strang step of a stencil of order `order` (S = 2 order + 2
points a side): two drifts, the cell, the S-point weights, the S x S
stencil on six grids and the kick (the arithmetic of
chip_smoke.march_rays_flops_per_packet_step, copied; integer index work is
not counted). 590 at order 2.

Bytes: what the algorithm itself must move in a call of `steps` steps:
the six grids (u, v, u_x, u_y, v_x, v_y) read once, each packet's x and k
read once and written once. The node-major copy of the grids, the
ordering by cell and the segments are one kernel's way of doing the
march and are not counted, so the count is the same whatever kernel
marches.
"""

from .march import bound_s


def flops_per_packet_step(order):
    S = 2 * order + 2
    drift = 5 + 1 + 2 * 4                  # f2 + gH (k.k); sqrt; x += h C
    cell = 2 * 4                           # divide, mod, floor, fraction
    weights = 2 * (S + S * (S - 2) + S)    # a = fr - o; products; / denom
    stencil = S * S + 6 * S * S * 2        # wx wy; multiply-add per grid
    kick = 6 + 4 * 2                       # refraction; x += dt U, k -= dt r
    return 2 * drift + cell + weights + stencil + kick


def flops(order, packets, steps):
    """Operations of `steps` steps of `packets` packets."""
    return flops_per_packet_step(order) * packets * steps


def bytes_moved(nx, ny, packets, itemsize):
    """Bytes of one call, whatever its number of steps."""
    return (6 * nx * ny + 4 * packets * 2) * itemsize


def bound_s_per_step(order, nx, ny, packets, steps, itemsize):
    """The least time a step could take on the chip, by its published
    peaks, in calls of `steps` steps."""
    return bound_s(flops(order, packets, steps),
                   bytes_moved(nx, ny, packets, itemsize)) / steps
