"""Operations and bytes of the coupled march (K1), counted from the
algorithm, not from any kernel's layout.

Operations: the plain algorithm's floating-point adds and multiplies for
one packet over one flow step, what the march does on the live 6x6
stencil (the arithmetic of chip_smoke.march_flops_per_packet, commit
701921e; integer index work is not counted).

Bytes: what the algorithm itself must move in a flow step: both
snapshots' velocity grids read once (nf grids of nx x ny each), each
packet's x and k read once and written once, and one overflow word a
member. The window rows are the window build's output layout and are
not counted, so the count is the same whatever kernel computes the
march.
"""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def flops_per_packet(spec):
    """Adds and multiplies of one packet over one flow step."""
    grad = spec.grad_from_interp
    weights = 2 * (6 + 6 * 5)                      # a = fr - o; 6 products
    if grad:
        weights += 2 * 6 * (5 * 3 + 4 + 1)         # derivative weights
    stencil = spec.nf * 36
    contraction = stencil * 3 + stencil * 2        # blend; y contraction
    contraction += spec.nf * 6 * 2                 # x contraction
    if grad:
        contraction += stencil * 2 + spec.nf * 6 * 4 + 4
    cell = 8                                       # scale, mod, floor, frac
    one_eval = weights + contraction + cell
    rhs = one_eval + 20
    per_substep = {"rk23": 3 * rhs + 4 * 2 * 3 + 4 * 7,
                   "rk4": 4 * rhs + 4 * 2 * 3 + 4 * 7,
                   "symplectic": one_eval + 40}[spec.stepper]
    return spec.n_substeps * per_substep


def flops(spec, packets):
    """Operations of a flow step over `packets` packets (all members)."""
    return flops_per_packet(spec) * packets


def bytes_moved(spec, packets, members, itemsize):
    """Bytes of a flow step: `packets` over all `members`."""
    grids = members * 2 * spec.nf * spec.nx * spec.ny * itemsize
    return grids + packets * 4 * itemsize * 2 + members * 4


def bound_s(n_flops, n_bytes):
    """The least time the chip could take, by its published peaks."""
    return max(n_flops / PEAKS["fp32_flop_per_s"],
               n_bytes / PEAKS["hbm_bytes_per_s"])
