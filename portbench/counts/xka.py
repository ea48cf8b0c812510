"""Operations and bytes of the x-k-a march (march_xka_kernel), counted
from the algorithm, not from any kernel's layout.

Operations: the plain algorithm's floating-point adds and multiplies
(a divide and a square root count one each, integer index work none) for
one packet over one step of step_packet_xka at a stencil of order `order`
(S = 2 order + 2 points a side). An evaluation at a point is the cell (as
counts/rays), the S-point weights of each axis, the S x S products of the
weights and a multiply-add per node and grid. A step evaluates the
velocity (two grids) at the three inner stages of the position RK4 and
all seven grids at the new position; the velocity and H at the step's own
position are the previous step's evaluation there, counted once, so a
call adds one evaluation of three grids at its start, whatever its
number of steps. Then the group velocity, the RK4 combinations of x, k
and a, and div C and grad omega (cg_sw.m). 1561 a step at order 2.

Bytes: what the algorithm itself must move in a call: the seven grids
read once, each packet's x, k and a read once and written once. The
node-major copy of the grids, the ordering by cell and the segments are
one kernel's way of doing the march and are not counted.
"""

from .march import bound_s


def evaluation(order, grids):
    """Operations of one stencil evaluation of `grids` grids at a point."""
    S = 2 * order + 2
    cell = 2 * 4                           # divide, mod, floor, fraction
    weights = 2 * (S + S * (S - 2) + S)    # a = fr - o; products; / denom
    return cell + weights + S * S + grids * S * S * 2


def flops_per_packet_step(order):
    group = (3                             # |k|^2
             + 3 + 1                       # gH H, . |k|^2, f^2 + .; sqrt
             + 2 * 2)                      # C = gH H k / om
    position = (3 * (2 * 2) - 2            # stage points x + x1/2, x + x2/2,
                                           # x + x3
                + 4 * 2 * 2                # dt (U + C) at four stages
                + 2 * 7)                   # x + (x1 + 2 x2 + 2 x3 + x4) / 6
    terms = (3 + 1                         # om at the new H; sqrt
             + 2 * 2                       # c = gH H k / om
             + 2 + 2 + 1 + 2 + 2 + 1       # (k f v - l f u - cx^2 - cy^2)
                                           # / om
             + 2 * 3 + 1 + 1)              # f |k|^2 (v, -u) / (2 om)
    wavevector = (4 * (6 + 2 + 2)          # -dt ((grad U)^T k + grad om)
                  + 3 * (2 * 2) - 2        # stage points
                  + 2 * 7)                 # combination
    action = (2 + 4 + 4 + 3                # -dt a divC at four stages
              + 7)                         # combination
    return (3 * evaluation(order, 2) + evaluation(order, 7) + group
            + position + terms + wavevector + action)


def flops(order, packets, steps):
    """Operations of one call of `steps` steps of `packets` packets."""
    return (flops_per_packet_step(order) * steps
            + evaluation(order, 3)) * packets


def bytes_moved(nx, ny, packets, itemsize):
    """Bytes of one call, whatever its number of steps."""
    return (7 * nx * ny + 5 * packets * 2) * itemsize


def bound_s_per_step(order, nx, ny, packets, steps, itemsize):
    """The least time a step could take on the chip, by its published
    peaks, in calls of `steps` steps."""
    return bound_s(flops(order, packets, steps),
                   bytes_moved(nx, ny, packets, itemsize)) / steps
