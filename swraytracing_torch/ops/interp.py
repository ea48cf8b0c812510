"""Off-grid field evaluation: periodic Lagrangian stencil interpolation.

Counterpart of the stencil path of swraytracing_tpu/ops/interp.py, the
vectorised replacement for the reference's per-particle double loop
(qg_flow_ray_trace/interpolate.m:12-50 and its duplicates). The algorithm
is identical — order-`order` 2-D Lagrangian interpolation on a
(2*order+2)^2 stencil with periodic wraparound (Durran Ch. 6) — with all
packets and all fields evaluated in one batched gather and contraction.

Layout: every per-packet array keeps the packet axis LAST — stencil
indices/weights are (S, Np) and gathered values (nf, S, S, Np) — as in the
JAX package, so the two compare like with like.

Notes vs the reference:
  * The reference's weight formula carries a spurious (-1) sign in each
    1-D basis (denominator (j-i) instead of (i-j), interpolate.m:37-38)
    that cancels in the 2-D product; the sign-correct basis is used here.
  * The reference adds bump=1e-10 to avoid "NaNs" (interpolate.m:13); the
    product-form basis has no division by (a - j), so no bump is needed.

The gather is ONE index_select over all S*S*Np stencil nodes; the JAX
package chunks the packet axis to get around a TPU gather limit, which a
GPU does not have. The (nf, S, S, Np) intermediate and its weighted copy
take 2 * nf * S * S * Np elements: 1.8 GB in float32 at nf=6, order 2 and
2^20 packets.

Gradients: exact w.r.t. both positions (piecewise-polynomial) and field
values (linear), via autograd; the transpose of the gather is a
scatter-add.

The windowed path (`build_windows`, `interp_windowed`) prebuilds every
cell's S x S window of the nf fields once per snapshot, so an evaluation
gathers one row per packet. The JAX package chunks that gather over the
packet axis (`_GATHER_CHUNK`) for a TPU gather fault; here it is one
index_select: the gathered rows take Np * S*S * nf elements, 0.9 GB in
float32 at nf=6, order 2 and 2^20 packets, which an 80 GB card holds, so
nothing is chunked.

An ensemble's members (parallel/ensemble.py) interpolate their own grids
at their own positions in one pass: fields (E, nf, nx, ny) and positions
(E, Np) give (nf, E, Np) values (`interp_stencil_apply`), and window arrays
(E, nx*ny, K) the same (`build_windows`, `interp_windowed`).

`interpolate_cubic` is the periodic bicubic convolution of the reference's
interpolate2.m, done right.
"""

from __future__ import annotations

import torch

from .grid import SpectralGrid

# Packet count from which the window paths engage (GriddedFlow.windowed()
# in models/frozen.raytrace_frozen; the coupled configs' default
# window_min_np): from there a prebuilt window's one row gather a packet
# beats the stencil's S*S point gathers.
_WINDOW_MIN_NP = 65536

__all__ = [
    "lagrange_weights",
    "stencil_and_weights",
    "cell_and_weights",
    "interp_stencil_apply",
    "interpolate",
    "interpolate_stack",
    "build_windows",
    "interp_windowed",
    "interpolate_cubic",
]


def _lagrange_denominators(order: int) -> list[float]:
    offsets = range(-order, order + 2)
    denom = []
    for i in offsets:
        d = 1.0
        for j in offsets:
            if j != i:
                d *= (i - j)
        denom.append(d)
    return denom


def lagrange_weights(frac: torch.Tensor, order: int = 2) -> torch.Tensor:
    """1-D Lagrange basis weights at fractional cell position `frac`.

    Args:
      frac: (...,) tensor in [0, 1), position within the cell relative to
        the left node.
      order: stencil half-width parameter; stencil nodes are the integers
        -order .. order+1 (order=2 -> 6-point, the reference's Iord=2,
        interpolate.m:12).
    Returns:
      (2*order+2, ...) weights (node axis FIRST), summing to 1 over it.
    Each weight is the product of (frac - j) over the other nodes j in
    ascending order, divided by its constant denominator; the ray-march
    kernel (kernels/csrc/march_rays.cu) forms it the same way.
    """
    offsets = list(range(-order, order + 2))
    denom = _lagrange_denominators(order)
    a = [frac - o for o in offsets]
    ws = []
    for idx in range(len(offsets)):
        p = None
        for j in range(len(offsets)):
            if j == idx:
                continue
            p = a[j] if p is None else p * a[j]
        ws.append(p / denom[idx])
    return torch.stack(ws, dim=0)


def _cell_coords(x, y, grid: SpectralGrid):
    """Fractional grid coordinates mod(x / dx, n) and their floors. The
    divisor is a 0-dim tensor: on a CUDA tensor PyTorch turns a division
    by a Python scalar into a multiplication by its reciprocal, which can
    put a packet beside a cell edge into the other cell."""
    xl = torch.remainder(x / x.new_full((), grid.dx), grid.nx)
    yl = torch.remainder(y / y.new_full((), grid.dy), grid.ny)
    return xl, yl, torch.floor(xl), torch.floor(yl)


def stencil_and_weights(x, y, grid: SpectralGrid, order: int = 2):
    """Periodic stencil indices and separable weights for packet
    positions.

    Args:
      x, y: (Np,) positions (any real values; periodic wrap applied), or
        (E, Np) for an ensemble's members.
    Returns:
      (ix, iy, wx, wy): ix, iy int32 (S, Np) grid indices; wx, wy (S, Np);
      (S, E, Np) for members.
    """
    xl, yl, i0, j0 = _cell_coords(x, y, grid)
    wx = lagrange_weights(xl - i0, order)
    wy = lagrange_weights(yl - j0, order)
    offsets = torch.arange(-order, order + 2, dtype=torch.int32,
                           device=x.device).reshape(-1, *([1] * x.dim()))
    # floored integer modulo: floor(mod) can be exactly n (a tiny negative
    # x), and i0 + offset runs below 0 and past n
    ix = torch.remainder(i0[None].to(torch.int32) + offsets, grid.nx)
    iy = torch.remainder(j0[None].to(torch.int32) + offsets, grid.ny)
    return ix, iy, wx, wy


def cell_and_weights(x, y, grid: SpectralGrid, order: int = 2):
    """Cell indices and separable weights only: one (i0, j0) per packet,
    not the (S, Np) per-node index arrays.

    Returns:
      (i0, j0, wx, wy): i0, j0 int32 (Np,) cell indices in [0, n);
      wx, wy (S, Np) Lagrange weights.
    """
    xl, yl, i0, j0 = _cell_coords(x, y, grid)
    wx = lagrange_weights(xl - i0, order)
    wy = lagrange_weights(yl - j0, order)
    # floor of mod can still hit n exactly from float rounding at the
    # right edge; fold it back.
    i0 = torch.remainder(i0.to(torch.int32), grid.nx)
    j0 = torch.remainder(j0.to(torch.int32), grid.ny)
    return i0, j0, wx, wy


def interp_stencil_apply(F, ix, iy, wx, wy):
    """Apply a precomputed stencil to stacked fields.

    Args:
      F: (nf, nx, ny) or (nx, ny) fields; or an ensemble's (E, nf, nx, ny),
        member e's grids read at column e of the stencil.
      ix, iy: (S, Np) int32 indices; wx, wy: (S, Np) weights; (S, E, Np)
        for members.
    Returns:
      (nf, Np) or (Np,) interpolated values; (nf, E, Np) for members.
    """
    if F.dim() == 4:
        return _interp_stencil_members(F, ix, iy, wx, wy)
    single = F.dim() == 2
    if single:
        F = F[None]
    nf, nx, ny = F.shape
    S, Np = ix.shape
    flat_idx = ix[:, None, :] * ny + iy[None, :, :]          # (S, S, Np)
    w2 = wx[:, None, :] * wy[None, :, :]                     # (S, S, Np)
    vals = F.reshape(nf, nx * ny).index_select(1, flat_idx.reshape(-1))
    out = (vals.reshape(nf, S, S, Np) * w2[None]).sum((1, 2))
    return out[0] if single else out


def _interp_stencil_members(F, ix, iy, wx, wy):
    """interp_stencil_apply over an ensemble's members: one gather from the
    members' grids laid side by side, each node offset by its member."""
    E, nf, nx, ny = F.shape
    S = ix.shape[0]
    member = torch.arange(E, device=ix.device)[:, None] * (nx * ny)
    flat_idx = (ix[:, None].to(torch.int64) * ny + iy[None]
                + member)                                  # (S, S, E, Np)
    w2 = wx[:, None] * wy[None]                            # (S, S, E, Np)
    rows = F.transpose(0, 1).reshape(nf, E * nx * ny)
    vals = rows.index_select(1, flat_idx.reshape(-1))
    return (vals.reshape(nf, *flat_idx.shape) * w2[None]).sum((1, 2))


def interpolate(F, x, y, grid: SpectralGrid, order: int = 2):
    """Interpolate a single field to packet positions: the reference's
    `interpolate(x, y, F, dx, dy)` (qg_flow_ray_trace/interpolate.m),
    vectorised over packets."""
    ix, iy, wx, wy = stencil_and_weights(x, y, grid, order)
    return interp_stencil_apply(F, ix, iy, wx, wy)


def interpolate_stack(F, x, y, grid: SpectralGrid, order: int = 2):
    """Interpolate a stack of fields (nf, nx, ny) at shared positions —
    the reference calls `interpolate` 12 times per evaluation
    (interpolate_U.m:5-17); here the stencil is computed once."""
    ix, iy, wx, wy = stencil_and_weights(x, y, grid, order)
    return interp_stencil_apply(F, ix, iy, wx, wy)


def build_windows(F, order: int = 2):
    """Materialise the full (S x S, nf) interpolation window of every grid
    cell: returns W of shape (nx*ny, S*S*nf) where row (i*ny + j) holds
    F[:, i-order:i+order+2, j-order:j+order+2] (periodic) laid out as
    (sx, sy, f). Pure data movement, so exact. The memory cost is (S*S)x
    the field stack (226 MB at 512^2, nf=6, float32). An ensemble's
    (E, nf, nx, ny) fields give (E, nx*ny, S*S*nf)."""
    if F.dim() == 2:
        F = F[None]
    lead, (nf, nx, ny) = F.shape[:-3], F.shape[-3:]
    S = 2 * order + 2
    Fp = torch.cat([F[..., ny - order:], F, F[..., :order + 2]], dim=-1)
    Fp = torch.cat([Fp[..., nx - order:, :], Fp, Fp[..., :order + 2, :]],
                   dim=-2)
    # (..., nf, nx+1, ny+1, Sx, Sy) views of every S x S window; keep
    # nx x ny
    d, n = Fp.dim(), len(lead)
    win = Fp.unfold(d - 2, S, 1).unfold(d - 1, S, 1)[..., :nx, :ny, :, :]
    return win.permute(*range(n), n + 1, n + 2, n + 3, n + 4, n).reshape(
        *lead, nx * ny, S * S * nf)


def interp_windowed(W, nf, x, y, grid: SpectralGrid, order: int = 2):
    """Interpolate nf stacked fields from a prebuilt window array W (see
    build_windows) at packet positions x, y (Np,): one row gathered per
    packet instead of S*S point gathers, the same Lagrange weights.
    Returns (nf, Np). An ensemble's windows (E, nx*ny, K) at positions
    (E, Np) give (nf, E, Np), member e's rows read from W[e]."""
    i0, j0, wx, wy = cell_and_weights(x, y, grid, order)
    starts = i0.to(torch.int64) * grid.ny + j0
    S = 2 * order + 2
    if W.dim() == 3:
        E, ncells, K = W.shape
        member = torch.arange(E, device=W.device)[:, None] * ncells
        g = W.reshape(E * ncells, K).index_select(
            0, (starts + member).reshape(-1)).reshape(E, -1, S, S, nf)
        return torch.einsum("ecxyf,xec,yec->fec", g, wx, wy)
    g = W.index_select(0, starts).reshape(-1, S, S, nf)   # (Np, S, S, nf)
    return torch.einsum("cxyf,xc,yc->fc", g, wx, wy)


def _cubic_conv_weights(frac):
    """Keys cubic-convolution (a=-1/2, MATLAB interp2 'cubic' kernel)
    weights for nodes -1, 0, 1, 2 at fractional position frac in [0,1).
    Returns (4, ...) with the node axis first."""
    t = frac[None]
    w_m1 = -0.5 * t * (1 - t) ** 2
    w_0 = 1 - 2.5 * t ** 2 + 1.5 * t ** 3
    w_1 = 0.5 * t * (1 + 4 * t - 3 * t ** 2)
    w_2 = 0.5 * t ** 2 * (t - 1)
    return torch.cat([w_m1, w_0, w_1, w_2], dim=0)


def interpolate_cubic(F, x, y, grid: SpectralGrid):
    """Periodic bicubic-convolution interpolation — the reference's
    interpolate2.m intent (MATLAB interp2 'cubic' on a periodic
    4-point halo-extended grid), implemented correctly; the reference's
    version is buggy (see why_isnt_interpolate2_working.m:32-49, which
    sweeps y-slices comparing it against the Lagrangian stencil).
    F (nx, ny) or (nf, nx, ny); x, y (Np,)."""
    xl, yl, i0, j0 = _cell_coords(x, y, grid)
    wx = _cubic_conv_weights(xl - i0)
    wy = _cubic_conv_weights(yl - j0)
    offsets = torch.arange(-1, 3, dtype=torch.int32,
                           device=x.device)[:, None]
    ix = torch.remainder(i0[None].to(torch.int32) + offsets, grid.nx)
    iy = torch.remainder(j0[None].to(torch.int32) + offsets, grid.ny)
    return interp_stencil_apply(F, ix, iy, wx, wy)
