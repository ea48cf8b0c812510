"""Fused wave-packet march: all packet substeps of one flow step in one
kernel, fed by ONE window gather per packet per snapshot.

Counterpart of swraytracing_tpu/ops/pallas_window.py. The reference
sub-cycles each flow step with ode23, paying a 6x6 Lagrangian stencil
gather per packet per stage (interpolate.m:12-50 via interpolate_U.m and
qgsw_raytrace.m:149,258-268).

Key observation: over ONE flow step a packet moves at most
dt*(|U|+Cg)/dx cells — under the production CFL that is < 1 cell. So a
stencil window gathered once per flow step, widened by a `margin` of
cells on each side, contains every stencil node that any substage of
that step can touch. The march then needs NO gathers at all:

  per flow step:
    build W  = cell windows of the new snapshot    (K, nx*ny), K = nf*SW^2
    gather   pw = W[cell(x)] per packet, both snapshots
    kernel   all n_substeps x stages in one launch: Lagrange weights,
             margin shift, time blend, dispersion, RK/symplectic update

With (ncells, K) window rows (`tiles_transposed`) the gather is part of
the kernel: a packet reads row cell(x) of both snapshots' window arrays
itself (march_gathered_cuda / fused_march_gathered), and no gathered copy
exists.

Within-margin arithmetic is IDENTICAL to the reference stencil: the same
6 Lagrange weights (Durran Ch. 6, interpolate.m:37-44) are placed at the
packet's current cell inside the wider window; positions that drift past
the margin are clamped to the nearest in-window stencil and counted in
the `overflow` output (callers assert it stays zero; see required_margin).

Three device kernels, hand-written CUDA under kernels/csrc, each with its
plain PyTorch version beside its wrapper here:

  march_cuda          (csrc/march.cuh)          plain: march_reference
  march_gathered_cuda (the same kernel, rows  plain: march_gathered_reference
                       read by cell)
  transpose_cuda      (csrc/transpose.cu)       plain: transpose_reference
  build_windows_cuda  (csrc/build_windows.cu)   plain: build_windows_reference

and the same three over the members of an ensemble, one launch for all
members (the JAX package vmaps its kernels over them,
parallel/ensemble.py), each plain version the loop over members of the
single-member one:

  march_gathered_batched_cuda  plain: march_gathered_batched_reference
  transpose_batched_cuda       plain: transpose_batched_reference
  build_windows_batched_cuda   plain: build_windows_batched_reference

`march_gathered_batched`, `transpose_batched` and `build_windows_batched`
pick between the two by device; nothing differentiates them.

`fused_march`, `fused_march_gathered`, `window_transpose` and
`build_windows_fused` are the differentiable entry points. They pick by
the device of the tensor they are given: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel. Nothing falls back: on a CUDA tensor the kernel launches or the
call raises.

Layouts: packet windows are (K, Np), or (Np, K) gather rows when
`tiles_transposed`. The CUDA kernel takes both through strides. For the
row layouts it copies the rows into shared memory before it marches: each
warp its own 32 packets' rows and then marches them (the `staged` route,
csrc/march.cuh), or producer warps in a persistent block fill a ring of
slots while consumer warps march the packets of the slots already full
(the `ring` route, csrc/march_ring.cuh); the third route, `direct`, reads
every row per thread from device memory. `march_route` is the rule.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import span

__all__ = [
    "MarchSpec",
    "required_margin",
    "max_margin",
    "build_margin_windows",
    "build_windows_reference",
    "build_windows_cuda",
    "build_windows_fused",
    "build_gather_windows",
    "packet_cells",
    "gather_packet_windows",
    "march_reference",
    "march_cuda",
    "fused_march",
    "march_route",
    "staged_block_limit",
    "ring_slots",
    "ring_consumers",
    "march_gathered_reference",
    "march_gathered_cuda",
    "fused_march_gathered",
    "transpose_reference",
    "transpose_cuda",
    "window_transpose",
    "march_gathered_batched_reference",
    "march_gathered_batched_cuda",
    "march_gathered_batched",
    "transpose_batched_reference",
    "transpose_batched_cuda",
    "transpose_batched",
    "build_windows_batched_reference",
    "build_windows_batched_cuda",
    "build_windows_batched",
]

_STEPPERS = ("rk23", "rk4", "symplectic")


class MarchSpec(NamedTuple):
    """Static configuration of the fused march (hashable)."""

    nx: int
    ny: int
    dx: float
    dy: float
    f: float
    Cg: float
    n_substeps: int = 4
    stepper: str = "rk23"          # 'rk23' | 'rk4' | 'symplectic'
    order: int = 2                 # Lagrange stencil half-width (Iord)
    margin: int = 1                # drift allowance, cells per flow step
    nf: int = 6                    # fields: u, v, ux, uy, vx, vy
    # Threads (= packets) per CUDA block of the march kernel on the direct
    # and staged routes (march_route). A tuning value only: the kernel
    # masks its ragged last block itself, so the packet count need not be
    # a multiple of it. On the staged route a block's warps must fit their
    # rows into one SM's shared memory; a block too large for that raises.
    # One warp a block packs an SM fullest whatever the row size, and
    # measured no slower than larger blocks on either route. The ring
    # route does not read it: its block, one an SM, is RING_PRODUCERS
    # producer warps and ring_consumers(spec, dtype) consumer warps.
    block: int = 32
    tiles_transposed: bool = False # pw passed as (Np, K) gather rows
    # Windows carry only (u, v) (nf=2); the march evaluates the
    # velocity-gradient tensor by DIFFERENTIATING the Lagrange
    # interpolant (w'_i(fx) w_j(fy) / dx) instead of interpolating
    # spectrally differentiated grids (grid_U.m:1-18). 3x smaller windows;
    # the accuracy cost is 5th order in dx.
    grad_from_interp: bool = False
    # Both snapshots' packet windows arrive in ONE gathered array,
    # stacked on the K axis ((2K, Np), or (Np, 2K) tiles_transposed).
    # fused_march's pw2 argument is then a dummy. Read by march_reference,
    # march_cuda and fused_march only: the gathered entries
    # (march_gathered_*, what the lock-step calls for (ncells, K) rows)
    # take the two window arrays themselves and gather nothing.
    combined_gather: bool = False
    # Build the (ncells, K) window array in ONE kernel
    # (build_windows_fused) instead of shifted copies + the tiled
    # transpose: the window array is written once and never re-read.
    # Takes effect with tiles_transposed; same output bit for bit.
    fused_build: bool = False

    @property
    def S(self) -> int:
        return 2 * self.order + 2

    @property
    def SW(self) -> int:
        return self.S + 2 * self.margin

    @property
    def K(self) -> int:
        return self.nf * self.SW * self.SW


def required_margin(dt: float, u_max: float, Cg: float, dx: float,
                    headroom: float = 3.0, nx: int | None = None,
                    order: int = 2) -> int:
    """Margin (cells) covering the worst-case packet drift over one flow
    step: |dx/dt| <= |U| + |Cg_group| <= u_max + Cg (group speed of the
    SW dispersion is bounded by Cg). `headroom` scales u_max because the
    flow can strengthen past its initial maximum during the run; the
    march's overflow counter catches violations at runtime.

    With `nx` given, the margin is capped so the window (SW = 2*order+2
    + 2*margin) never exceeds the periodic grid. A capped margin that
    proves too small surfaces through the overflow counter."""
    m = max(1, int(np.ceil(dt * (headroom * u_max + Cg) / dx)))
    if nx is not None:
        m = min(m, max_margin(nx, order))
    return m


def max_margin(nx: int, order: int = 2) -> int:
    """Largest margin whose window still fits the periodic grid."""
    return max(1, (nx - (2 * order + 2)) // 2)


# ---------------------------------------------------------------------------
# Window build + gather
# ---------------------------------------------------------------------------

def _check_window_fits(nx: int, ny: int, spec: MarchSpec):
    if spec.order + 1 + spec.margin > min(nx, ny):
        raise ValueError(
            f"march window (margin={spec.margin}, SW={spec.SW}) exceeds the "
            f"{nx}x{ny} periodic grid; cap the margin with "
            "required_margin(..., nx=) / max_margin")


def _shifted_views(F: torch.Tensor, spec: MarchSpec) -> torch.Tensor:
    """View [..., f, sx, sy, i, j] = F[..., f, i + sx - lo, j + sy - lo]
    (periodic, lo = order + margin) of the periodically padded fields
    (..., nf, nx, ny); leading axes (an ensemble's members) pass through."""
    F = F[..., :spec.nf, :, :]  # grad_from_interp (nf=2) keeps (u, v)
    nx, ny = F.shape[-2:]
    _check_window_fits(nx, ny, spec)
    lo = spec.order + spec.margin
    hi = spec.order + 1 + spec.margin
    Fp = torch.cat([F[..., ny - lo:], F, F[..., :hi]], dim=-1)
    Fp = torch.cat([Fp[..., nx - lo:, :], Fp, Fp[..., :hi, :]], dim=-2)
    d = Fp.dim()
    return Fp.unfold(d - 2, nx, 1).unfold(d - 1, ny, 1)


def build_margin_windows(F: torch.Tensor, spec: MarchSpec) -> torch.Tensor:
    """(nf, nx, ny) fields -> (K, nx*ny) cell-window array W:
    W[(f*SW + sx)*SW + sy, i*ny + j] = F[f, i + sx - (order+margin),
    j + sy - (order+margin)] (periodic). Rows are shifted flattened
    copies of the fields, written by one strided copy. An ensemble's
    (E, nf, nx, ny) fields give (E, K, nx*ny), member by member the same."""
    shifted = _shifted_views(F, spec)
    nx, ny = shifted.shape[-2:]
    return shifted.reshape(*shifted.shape[:-5], spec.K, nx * ny)


def build_windows_reference(F: torch.Tensor, spec: MarchSpec) -> torch.Tensor:
    """Plain version of build_windows_cuda: (nf, nx, ny) fields ->
    (nx*ny, K) gather rows, W[i*ny + j, (f*SW + sx)*SW + sy] =
    F[f, i + sx - (order+margin), j + sy - (order+margin)] (periodic),
    by one strided copy of the padded fields. Equal to
    build_margin_windows(F, spec).T bit for bit."""
    shifted = _shifted_views(F, spec)
    nx, ny = shifted.shape[-2:]
    return shifted.permute(3, 4, 0, 1, 2).reshape(nx * ny, spec.K)


def build_gather_windows(F: torch.Tensor, spec: MarchSpec) -> torch.Tensor:
    """Cell-window array in the layout gather_packet_windows expects:
    (K, ncells) when tiles_transposed=False, else (ncells, K) for
    contiguous row gathers: in one pass with spec.fused_build
    (build_windows_fused), else through window_transpose (the transpose
    kernel on a CUDA tensor). Both serve any nx, ny.

    An ensemble's (E, nf, nx, ny) fields give (E, ...) arrays, member by
    member the same, through the batched kernels (build_windows_batched,
    transpose_batched): one launch for all members. Runs inside the span
    swr.windows (utils/profiling.span)."""
    with span("swr.windows"):
        if F.dim() == 4:
            if spec.tiles_transposed and spec.fused_build:
                return build_windows_batched(F, spec)
            W = build_margin_windows(F, spec)
            return transpose_batched(W) if spec.tiles_transposed else W
        if spec.tiles_transposed and spec.fused_build:
            return build_windows_fused(F, spec)
        W = build_margin_windows(F, spec)
        if not spec.tiles_transposed:
            return W
        return window_transpose(W)


def packet_cells(x: torch.Tensor, y: torch.Tensor, spec: MarchSpec):
    """Origin cell of each packet: (oi, oj) int32 in [0, n), of the shape
    of x and y ((Np,), or (E, Np) for an ensemble's members). The divisor
    is a 0-dim tensor: on a CUDA tensor PyTorch turns a division by a
    Python scalar into a multiplication by its reciprocal, which can put a
    packet beside a cell edge into the other cell."""
    xl = torch.remainder(x / x.new_full((), spec.dx), spec.nx)
    yl = torch.remainder(y / y.new_full((), spec.dy), spec.ny)
    oi = torch.floor(xl).to(torch.int32)
    oj = torch.floor(yl).to(torch.int32)
    oi = torch.where(oi >= spec.nx, oi - spec.nx, oi)
    oj = torch.where(oj >= spec.ny, oj - spec.ny, oj)
    return oi, oj


def gather_packet_windows(W: torch.Tensor, oi, oj, spec: MarchSpec):
    """One row (or column) gather per packet: W -> pw.

    tiles_transposed=False: W is (K, ncells); gathers columns -> (K, Np).
    tiles_transposed=True: W is (ncells, K); gathers rows -> (Np, K).

    Feeds the pre-gathered march (march_reference / march_cuda /
    fused_march): the (K, ncells) layout's route, and the plain version of
    the gathered march. On the card the lock-step does not come here for
    (ncells, K) rows; the kernel reads them by cell. Counts its calls in
    `gather_packet_windows.calls`, so a run can show that."""
    gather_packet_windows.calls += 1
    starts = oi.to(torch.int64) * spec.ny + oj
    if spec.tiles_transposed:
        return W.index_select(0, starts)      # (Np, K)
    return W.index_select(1, starts)          # (K, Np)


gather_packet_windows.calls = 0


# ---------------------------------------------------------------------------
# Shared march arithmetic (the plain version of the march kernel;
# csrc/march.cuh computes the same thing, thread per packet)
# ---------------------------------------------------------------------------

def _lagrange_denominators(order: int):
    offs = list(range(-order, order + 2))
    denom = []
    for i in offs:
        d = 1.0
        for j in offs:
            if j != i:
                d *= (i - j)
        denom.append(d)
    return offs, denom


def _lagrange_ws(fr: torch.Tensor, order: int):
    """S Lagrange basis weights at fractional position fr (B,) in [0,1)
    for nodes -order..order+1 (interpolate.m:33-44, sign-correct form).
    The denominators are constants; the products multiply by their
    reciprocals."""
    offs, denom = _lagrange_denominators(order)
    a = [fr - o for o in offs]
    ws = []
    for idx in range(len(offs)):
        p = None
        for j in range(len(offs)):
            if j == idx:
                continue
            p = a[j] if p is None else p * a[j]
        ws.append(p * (1.0 / denom[idx]))
    return ws


def _lagrange_dws(fr: torch.Tensor, order: int):
    """d/dfr of the S Lagrange basis weights (exact — the basis is a
    degree-(S-1) polynomial): L_i'(fr) = sum_m Pi_{j != i,m}(fr - o_j)
    / denom_i. The physical derivative needs a further 1/dx scale at the
    call site."""
    offs, denom = _lagrange_denominators(order)
    a = [fr - o for o in offs]
    dws = []
    for idx in range(len(offs)):
        s = None
        for m in range(len(offs)):
            if m == idx:
                continue
            p = None
            for j in range(len(offs)):
                if j == idx or j == m:
                    continue
                p = a[j] if p is None else p * a[j]
            if p is None:  # order 0: two nodes, constant derivative
                p = torch.ones_like(fr)
            s = p if s is None else s + p
        dws.append(s * (1.0 / denom[idx]))
    return dws


def _extended_weights(ws, d: torch.Tensor, spec: MarchSpec) -> torch.Tensor:
    """Place the S stencil weights into the SW-wide window at integer
    shift d (B,) in [-margin, margin]: row p of the result holds
    ws[p - d - margin] (zero outside). Returns (SW, B)."""
    SW, m = spec.SW, spec.margin
    pio = torch.arange(SW, dtype=torch.int32, device=d.device)[:, None]
    t = pio - (d + m)[None, :]
    zero = torch.zeros((), dtype=ws[0].dtype, device=d.device)
    out = torch.zeros((SW, d.shape[0]), dtype=ws[0].dtype, device=d.device)
    for s in range(len(ws)):
        out = out + torch.where(t == s, ws[s][None, :], zero)
    return out


def _eval_fields(pw1, pw2, x0, x1, alpha: float, oi, oj, spec: MarchSpec):
    """Interpolate the 6 time-blended fields at packet positions from
    the margin windows. pw*: (nf, SW, SW, B); returns ((6, B), ov)
    where ov (B,) int32 is the margin excess (0 when in-window)."""
    nx, ny, m = spec.nx, spec.ny, spec.margin
    xl = torch.remainder(x0 * (1.0 / spec.dx), nx)
    yl = torch.remainder(x1 * (1.0 / spec.dy), ny)
    i0f = torch.floor(xl)
    j0f = torch.floor(yl)
    fx = xl - i0f
    fy = yl - j0f
    i0 = i0f.to(torch.int32)
    j0 = j0f.to(torch.int32)
    i0 = torch.where(i0 >= nx, i0 - nx, i0)   # floor(mod) fp edge
    j0 = torch.where(j0 >= ny, j0 - ny, j0)
    di = i0 - oi
    di = torch.where(di > nx // 2, di - nx, di)
    di = torch.where(di < -(nx // 2), di + nx, di)
    dj = j0 - oj
    dj = torch.where(dj > ny // 2, dj - ny, dj)
    dj = torch.where(dj < -(ny // 2), dj + ny, dj)
    ov = torch.clamp(torch.maximum(di.abs(), dj.abs()) - m, min=0)
    di = torch.clamp(di, -m, m)
    dj = torch.clamp(dj, -m, m)
    wex = _extended_weights(_lagrange_ws(fx, spec.order), di, spec)
    wey = _extended_weights(_lagrange_ws(fy, spec.order), dj, spec)
    v = (1.0 - alpha) * pw1 + alpha * pw2             # blend
    # SEPARABLE contraction: the 2-D stencil weight is wex (x) wey, so
    # contract the y axis once per field, then finish with SW-long x
    # contractions (y first, then x: the kernel keeps this order).
    ty = (v * wey[None, None, :, :]).sum(2)           # (nf, SW, B)
    if not spec.grad_from_interp:
        vals = (ty * wex[None, :, :]).sum(1)          # (nf, B)
        return vals, ov
    # nf=2 windows (u, v): the velocity-gradient tensor comes from the
    # DERIVATIVE of the Lagrange interpolant.
    dwex = _extended_weights(_lagrange_dws(fx, spec.order), di, spec)
    dwey = _extended_weights(_lagrange_dws(fy, spec.order), dj, spec)
    tdy = (v * dwey[None, None, :, :]).sum(2)         # (nf, SW, B)
    u = (ty[0] * wex).sum(0)
    vv = (ty[1] * wex).sum(0)
    ux = (ty[0] * dwex).sum(0) * (1.0 / spec.dx)
    uy = (tdy[0] * wex).sum(0) * (1.0 / spec.dy)
    vx = (ty[1] * dwex).sum(0) * (1.0 / spec.dx)
    vy = (tdy[1] * wex).sum(0) * (1.0 / spec.dy)
    return torch.stack([u, vv, ux, uy, vx, vy]), ov


def _march_core(pw1, pw2, x0, x1, k0, k1, oi, oj, sub_dt, spec: MarchSpec):
    """All n_substeps of one flow step. pw*: (nf, SW, SW, B); sub_dt is
    the substep length (dt_flow / n_substeps; 0 freezes packets), a
    0-dim tensor of the packets' dtype. The flow blend fraction ramps
    alpha = (i + stage)/n over the step, exactly the reference's
    interpolate_U convention (interpolate_U.m:19-23). Steppers: rk23 =
    Bogacki-Shampine stages of MATLAB's ode23 (qgsw_raytrace.m:149),
    rk4, symplectic = Strang phi1/phi2/phi1 (ode_symplectic.m:33-37)."""
    n = spec.n_substeps
    gH = spec.Cg ** 2
    f2 = spec.f ** 2
    h = sub_dt
    ov_tot = torch.zeros(x0.shape, dtype=torch.int32, device=x0.device)

    def rhs(xx0, xx1, kk0, kk1, alpha):
        F, ov = _eval_fields(pw1, pw2, xx0, xx1, alpha, oi, oj, spec)
        om = torch.sqrt(f2 + gH * (kk0 * kk0 + kk1 * kk1))
        inv = 1.0 / om
        return (F[0] + gH * kk0 * inv, F[1] + gH * kk1 * inv,
                -(F[2] * kk0 + F[4] * kk1), -(F[3] * kk0 + F[5] * kk1),
                ov)

    for i in range(n):
        a0 = i / n
        da = 1.0 / n
        if spec.stepper == "rk23":
            d = rhs(x0, x1, k0, k1, a0)
            e = rhs(x0 + 0.5 * h * d[0], x1 + 0.5 * h * d[1],
                    k0 + 0.5 * h * d[2], k1 + 0.5 * h * d[3],
                    a0 + 0.5 * da)
            g = rhs(x0 + 0.75 * h * e[0], x1 + 0.75 * h * e[1],
                    k0 + 0.75 * h * e[2], k1 + 0.75 * h * e[3],
                    a0 + 0.75 * da)
            c = h / 9.0
            x0 = x0 + c * (2.0 * d[0] + 3.0 * e[0] + 4.0 * g[0])
            x1 = x1 + c * (2.0 * d[1] + 3.0 * e[1] + 4.0 * g[1])
            k0 = k0 + c * (2.0 * d[2] + 3.0 * e[2] + 4.0 * g[2])
            k1 = k1 + c * (2.0 * d[3] + 3.0 * e[3] + 4.0 * g[3])
            ov_tot = torch.maximum(
                ov_tot, torch.maximum(d[4], torch.maximum(e[4], g[4])))
        elif spec.stepper == "rk4":
            d = rhs(x0, x1, k0, k1, a0)
            e = rhs(x0 + 0.5 * h * d[0], x1 + 0.5 * h * d[1],
                    k0 + 0.5 * h * d[2], k1 + 0.5 * h * d[3],
                    a0 + 0.5 * da)
            g = rhs(x0 + 0.5 * h * e[0], x1 + 0.5 * h * e[1],
                    k0 + 0.5 * h * e[2], k1 + 0.5 * h * e[3],
                    a0 + 0.5 * da)
            q = rhs(x0 + h * g[0], x1 + h * g[1],
                    k0 + h * g[2], k1 + h * g[3], a0 + da)
            c = h / 6.0
            x0 = x0 + c * (d[0] + 2.0 * (e[0] + g[0]) + q[0])
            x1 = x1 + c * (d[1] + 2.0 * (e[1] + g[1]) + q[1])
            k0 = k0 + c * (d[2] + 2.0 * (e[2] + g[2]) + q[2])
            k1 = k1 + c * (d[3] + 2.0 * (e[3] + g[3]) + q[3])
            ov_tot = torch.maximum(
                ov_tot, torch.maximum(torch.maximum(d[4], e[4]),
                                      torch.maximum(g[4], q[4])))
        elif spec.stepper == "symplectic":
            om = torch.sqrt(f2 + gH * (k0 * k0 + k1 * k1))
            cinv = 0.5 * h * gH / om
            x0 = x0 + cinv * k0
            x1 = x1 + cinv * k1
            F, ov = _eval_fields(pw1, pw2, x0, x1, a0 + 0.5 * da,
                                 oi, oj, spec)
            k0n = k0 - h * (F[2] * k0 + F[4] * k1)
            k1n = k1 - h * (F[3] * k0 + F[5] * k1)
            x0 = x0 + h * F[0]
            x1 = x1 + h * F[1]
            k0, k1 = k0n, k1n
            om = torch.sqrt(f2 + gH * (k0 * k0 + k1 * k1))
            cinv = 0.5 * h * gH / om
            x0 = x0 + cinv * k0
            x1 = x1 + cinv * k1
            ov_tot = torch.maximum(ov_tot, ov)
        else:
            raise ValueError(f"unknown stepper {spec.stepper!r}")
    return x0, x1, k0, k1, ov_tot


def _check_spec(spec: MarchSpec):
    if spec.grad_from_interp != (spec.nf == 2) or spec.nf not in (2, 6):
        raise ValueError(
            "the march takes nf=6 windows (u, v and the four gradients) or, "
            "with grad_from_interp, nf=2 windows (u, v); got "
            f"nf={spec.nf}, grad_from_interp={spec.grad_from_interp}")
    if spec.stepper not in _STEPPERS:
        raise ValueError(f"unknown stepper {spec.stepper!r}")
    if spec.order != 2:
        raise ValueError(f"the march supports order 2 only, got {spec.order}")


def march_reference(pw1, pw2, xk, oi, oj, sub_dt, spec: MarchSpec):
    """Plain PyTorch fused march over all packets at once (any device):
    the plain version of march_cuda, the CPU path, and what fused_march
    differentiates. pw*: (K, Np) (or (Np, K) when spec.tiles_transposed);
    xk (4, Np) = [x, y, kx, ky]; sub_dt a Python float or 0-dim tensor;
    returns (xk_out (4, Np), overflow (Np,) int32).

    combined_gather: pw1 carries BOTH snapshots stacked on the K axis
    ((2K, Np) / (Np, 2K)); pw2 is ignored (pass any tensor)."""
    _check_spec(spec)
    if spec.combined_gather:
        w = pw1.t() if spec.tiles_transposed else pw1          # (2K, Np)
        p = w.reshape(2, spec.nf, spec.SW, spec.SW, -1)
        p1, p2 = p[0], p[1]
    else:
        if spec.tiles_transposed:
            pw1 = pw1.t()
            pw2 = pw2.t()
        p1 = pw1.reshape(spec.nf, spec.SW, spec.SW, -1)
        p2 = pw2.reshape(spec.nf, spec.SW, spec.SW, -1)
    h = torch.as_tensor(sub_dt, dtype=xk.dtype, device=xk.device)
    r = _march_core(p1, p2, xk[0], xk[1], xk[2], xk[3], oi, oj, h, spec)
    return torch.stack(r[:4]), r[4]


def march_gathered_reference(win1, win2, xk, oi, oj, sub_dt, spec: MarchSpec):
    """Plain version of march_gathered_cuda, the CPU path, and what
    fused_march_gathered differentiates: gather each packet's window from
    the two cell-window arrays (build_gather_windows' layout: (ncells, K)
    rows when spec.tiles_transposed, else (K, ncells)), then
    march_reference on the two gathered arrays. spec.combined_gather is
    not read: stacking the two snapshots before one gather and splitting
    them again gives these same values bit for bit. Returns
    (xk_out (4, Np), overflow (Np,) int32)."""
    pw1 = gather_packet_windows(win1, oi, oj, spec)
    pw2 = gather_packet_windows(win2, oi, oj, spec)
    return march_reference(pw1, pw2, xk, oi, oj, sub_dt,
                           spec._replace(combined_gather=False))


# ---------------------------------------------------------------------------
# CUDA wrappers (kernels/csrc/march.cuh, transpose.cu, build_windows.cu)
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _require_cuda(name: str, *tensors):
    """What a kernel wrapper takes: each of `tensors`, given as (key,
    tensor, dtype, shape), a contiguous CUDA tensor of this dtype and
    shape. Types and shapes of all are checked first, then where they lie.
    Anything else raises; nothing is converted on the way."""
    for key, t, dtype, shape in tensors:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: `{key}` must be {dtype} {tuple(shape)}; got "
                f"{t.dtype} {tuple(t.shape)}")
    for key, t, _, _ in tensors:
        if not t.is_cuda:
            raise ValueError(
                f"{name} launches a CUDA kernel: `{key}` lies on {t.device}, "
                "not on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: `{key}` must be contiguous")


# Shared memory one SM can give its blocks on sm_90 (227 KB): the same
# number as SMEM_PER_SM in kernels/csrc/march.cuh.
SMEM_PER_SM = 232448


def staged_warp_bytes(spec: MarchSpec, dtype: torch.dtype) -> int:
    """Shared memory one warp's 32 rows take on the staged route: both
    snapshots' K values per packet, rows an odd 2K + 1 elements apart."""
    return 32 * (2 * spec.K + 1) * (torch.finfo(dtype).bits // 8)


def staged_block_limit(spec: MarchSpec, dtype: torch.dtype) -> int:
    """The largest MarchSpec.block the staged route takes for these rows:
    as many warps as fit their rows into one SM's shared memory, at most
    256 threads; 0 where not even one warp's rows fit."""
    return min(256, 32 * (SMEM_PER_SM // staged_warp_bytes(spec, dtype)))


# The ring route's block (kernels/csrc/march_ring.cuh, whose constants of
# the same names these are): RING_PRODUCERS producer warps, one for each
# of an SM's four sub-partitions (one warp alone issues the element-sized
# copies too slowly to keep up with the rows), and consumer warps.
RING_PRODUCERS = 4
# Shared memory a ring slot takes beside its 32 rows: its two barriers.
RING_BARRIER_BYTES = 16
# Slots of the ring that no consumer warp holds: the producers' copies in
# flight while the other slots are marched, C = S - RING_SPARE_SLOTS. Of 7
# slots (float32, K = 128), 4 consumers measured faster than 5 or 6 at both
# entries (`ms_by_route` in chip_smoke.py's kernels line).
RING_SPARE_SLOTS = 3
# Consumer warps a ring block takes at most: with the producers, 384
# threads, as many as the kernel's registers allow (a float64 ring holds
# at most 6 slots, so at most 288 threads).
RING_MAX_CONSUMERS = 8
# Consumer warps below which march_route keeps the staged route: with 1
# (float32 at K = 200 or 384, float64 at K = 128 or 200) the ring measured
# 1.27 to 2.24 times the staged route's time at the main shape's packets,
# with 4 (float32 at K = 128) 0.94 (march_routes_* of chip_smoke.py).
RING_MIN_CONSUMERS = 4


def ring_slots(spec: MarchSpec, dtype: torch.dtype) -> int:
    """Slots of the ring route's block: as many batches of 32 rows, in the
    staged route's layout, as fit in one SM's shared memory beside two
    8-byte barriers each; floor(SMEM_PER_SM / staged_warp_bytes) on every
    row size the march takes. The route needs 2."""
    return SMEM_PER_SM // (staged_warp_bytes(spec, dtype) + RING_BARRIER_BYTES)


def ring_consumers(spec: MarchSpec, dtype: torch.dtype) -> int:
    """Consumer warps of a ring block: RING_SPARE_SLOTS slots fewer than
    the ring holds, at least 1 and at most RING_MAX_CONSUMERS; always
    fewer than the slots, as the kernel requires."""
    return max(1, min(ring_slots(spec, dtype) - RING_SPARE_SLOTS,
                      RING_MAX_CONSUMERS))


def march_route(spec: MarchSpec, dtype: torch.dtype) -> str:
    """Which way the march kernel reads its window rows, from the layout
    and (2K, element size) alone. The (K, Np) layout is always "direct"
    (every thread reads its own row from device memory as it goes): its
    loads are coalesced across packets already. The row layouts take
    "ring" (producer warps of a persistent block copy rows into a ring of
    shared-memory slots while consumer warps march) where the ring holds
    RING_MIN_CONSUMERS consumer warps beside its spare slots; else
    "staged" (each warp first copies its 32 packets' rows into shared
    memory with coalesced asynchronous copies, then marches them) while
    one warp's rows fit; else "direct". Staging measured no slower than
    per-thread loads even with a single warp resident. The ring's readings
    (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700.00 W, ms a call in a run
    of calls, float32, K = 128, 4 consumer warps): the ensemble's launch at
    Run I's shape 0.1295 against the staged route's 0.1349 and 0.1314 in
    the same run; a single member's at the main shape 0.5535 against
    0.5903 and 0.5862. Both entries read it faster, so both take it.
    A rule on shapes, not a fallback: a launch that fails raises."""
    if not spec.tiles_transposed:
        return "direct"
    if ring_consumers(spec, dtype) >= RING_MIN_CONSUMERS:
        return "ring"
    return "staged" if staged_block_limit(spec, dtype) >= 32 else "direct"


_ROUTES = ("staged", "direct", "ring")


def _checked_route(name, spec: MarchSpec, dtype, route, consumers=None):
    """The route a march launch takes and the threads of its block:
    `route`, or where that is None the one march_route gives. The block is
    spec.block on the staged and direct routes, and 32 x (RING_PRODUCERS +
    consumer warps) on the ring route, the consumers `consumers` or where
    that is None ring_consumers(spec, dtype). Raises for an unknown route,
    a block the route does not take, and consumers named off the ring
    route."""
    if route is None:
        route = march_route(spec, dtype)
    if route not in _ROUTES:
        raise ValueError(f"{name}: route must be 'staged', 'direct', 'ring' "
                         f"or None, got {route!r}")
    if not (32 <= spec.block <= 256 and spec.block % 32 == 0):
        raise ValueError("MarchSpec.block must be a multiple of 32 in "
                         f"[32, 256], got {spec.block}")
    if consumers is not None and route != "ring":
        raise ValueError(f"{name}: consumer warps are a setting of the ring "
                         f"route, not of the {route} route")
    if route == "staged":
        limit = staged_block_limit(spec, dtype)
        if spec.block > limit:
            raise ValueError(
                f"{name}: the staged route keeps 32 rows of 2K+1 = "
                f"{2 * spec.K + 1} {dtype} values per warp in shared "
                f"memory ({staged_warp_bytes(spec, dtype)} bytes of "
                f"{SMEM_PER_SM} per SM), so MarchSpec.block can be at most "
                f"{limit} here; got {spec.block}")
        return route, spec.block
    if route == "direct":
        return route, spec.block
    slots = ring_slots(spec, dtype)
    if slots < 2:
        raise ValueError(
            f"{name}: the ring route needs two slots of 32 rows of 2K+1 = "
            f"{2 * spec.K + 1} {dtype} values in one SM's shared memory "
            f"({staged_warp_bytes(spec, dtype)} bytes a slot of "
            f"{SMEM_PER_SM}); {slots} fits")
    if consumers is None:
        consumers = ring_consumers(spec, dtype)
    if not 1 <= consumers <= min(slots - 1, RING_MAX_CONSUMERS):
        raise ValueError(
            f"{name}: the ring route's {slots} slots take 1 to "
            f"{min(slots - 1, RING_MAX_CONSUMERS)} consumer warps; got "
            f"{consumers}")
    return route, 32 * (RING_PRODUCERS + consumers)


def _march_entry(lib, route, dtype, batched=False):
    """The C entry of the march kernel for this route and type."""
    name = ("swr_march_" + ("batched_" if batched else "")
            + ("" if route == "direct" else route + "_")
            + ("f32" if dtype == torch.float32 else "f64"))
    return name, getattr(lib, name)


def _launch_march(wrapper, p1, p2, s_packet, s_elem, gathered, xk, oi, oj,
                  sub_dt, spec: MarchSpec, route, consumers=None):
    """Launch the march kernel for `wrapper` (march_cuda or
    march_gathered_cuda) on checked arguments (p1, p2: device addresses of
    the two snapshots' windows), by `route` or, where that is None, by the
    route march_route gives (on the ring route with `consumers` consumer
    warps, or ring_consumers'). Adds the launch to `wrapper.launches` and,
    under the route it took, to `wrapper.launches_by_route`. Returns
    (xk_out, overflow)."""
    from .. import kernels

    route, threads = _checked_route(wrapper.__name__, spec, xk.dtype, route,
                                    consumers)
    Np = xk.shape[-1]
    out = torch.empty_like(xk)
    ov = torch.empty((Np,), dtype=torch.int32, device=xk.device)
    if Np == 0:  # nothing to launch
        return out, ov
    name, entry = _march_entry(kernels.load(), route, xk.dtype)
    with torch.cuda.device(xk.device):
        err = entry(
            p1, p2, s_packet, s_elem, int(gathered),
            xk.data_ptr(), oi.data_ptr(), oj.data_ptr(),
            out.data_ptr(), ov.data_ptr(), Np, float(sub_dt),
            spec.nx, spec.ny, 1.0 / spec.dx, 1.0 / spec.dy,
            spec.f ** 2, spec.Cg ** 2, spec.margin, spec.n_substeps,
            spec.nf, _STEPPERS.index(spec.stepper), threads,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, name)
    wrapper.launches += 1
    wrapper.launches_by_route[route] += 1
    return out, ov


def _require_march_inputs(name, windows, xk, oi, oj, spec: MarchSpec):
    """The checks both march wrappers make; `windows` as _require_cuda
    takes them."""
    _check_spec(spec)
    if xk.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: xk must be float32 or float64, got "
                         f"{xk.dtype}")
    Np = xk.shape[-1]
    _require_cuda(name, *windows, ("xk", xk, xk.dtype, (4, Np)),
                  ("oi", oi, torch.int32, (Np,)),
                  ("oj", oj, torch.int32, (Np,)))


def march_cuda(pw1, pw2, xk, oi, oj, sub_dt, spec: MarchSpec):
    """The fused march on the card (kernels/csrc/march.cuh) from
    pre-gathered packet windows: arguments and results as march_reference,
    CUDA tensors only. One thread per packet, rows read by the route
    march_route gives; `sub_dt` is passed to the kernel as a scalar.
    Launches on the current stream and does not synchronise. Counts its
    launches in `march_cuda.launches`, and by the route each took in
    `march_cuda.launches_by_route`."""
    Np = xk.shape[-1]
    K = spec.K
    rows = 2 * K if spec.combined_gather else K
    pw_shape = (Np, rows) if spec.tiles_transposed else (rows, Np)
    windows = [("pw1", pw1, xk.dtype, pw_shape)]
    if not spec.combined_gather:
        windows.append(("pw2", pw2, xk.dtype, pw_shape))
    _require_march_inputs("march_cuda", windows, xk, oi, oj, spec)

    # Strides in elements: from one packet to the next, and from one
    # window component to the next. Both layouts are the same kernel.
    if spec.tiles_transposed:
        s_packet, s_elem = rows, 1
    else:
        s_packet, s_elem = 1, Np
    p1 = pw1.data_ptr()
    if spec.combined_gather:
        p2 = p1 + K * s_elem * pw1.element_size()
    else:
        p2 = pw2.data_ptr()
    return _launch_march(march_cuda, p1, p2, s_packet, s_elem, False, xk, oi,
                         oj, sub_dt, spec, None)


march_cuda.launches = 0
march_cuda.launches_by_route = dict.fromkeys(_ROUTES, 0)


def march_gathered_cuda(win1, win2, xk, oi, oj, sub_dt, spec: MarchSpec,
                        route=None, consumers=None):
    """The fused march on the card with the gather inside the kernel
    (kernels/csrc/march.cuh): arguments and results as
    march_gathered_reference, CUDA tensors only, (ncells, K) window rows
    only (spec.tiles_transposed; a (K, ncells) array has no contiguous row
    to read, that layout gathers first and calls march_cuda). A packet
    reads row oi*ny + oj of win1 and of win2; `oi`, `oj` are trusted to lie
    in [0, nx) and [0, ny), as packet_cells makes them. Rows are read by
    the route march_route gives; `route` ("staged", "ring" or "direct")
    names one instead, to hold the routes against each other and to time
    them (the results are the same bits; a staged launch whose block does
    not fit raises, as does a ring launch where two slots do not fit), and
    `consumers` the ring block's consumer warps (ring_consumers' by
    default). Launches on the current stream and does not synchronise.
    Counts its launches in `march_gathered_cuda.launches`, and by the route
    each took in `march_gathered_cuda.launches_by_route`."""
    name = "march_gathered_cuda"
    if not spec.tiles_transposed:
        raise ValueError(
            f"{name} reads (ncells, K) window rows (tiles_transposed=True); "
            "for (K, ncells) arrays gather with gather_packet_windows and "
            "call march_cuda")
    win_shape = (spec.nx * spec.ny, spec.K)
    _require_march_inputs(name, [("win1", win1, xk.dtype, win_shape),
                                 ("win2", win2, xk.dtype, win_shape)],
                          xk, oi, oj, spec)
    return _launch_march(march_gathered_cuda, win1.data_ptr(),
                         win2.data_ptr(), spec.K, 1, True, xk, oi, oj, sub_dt,
                         spec, route, consumers)


march_gathered_cuda.launches = 0
march_gathered_cuda.launches_by_route = dict.fromkeys(_ROUTES, 0)


def transpose_reference(W: torch.Tensor) -> torch.Tensor:
    """Plain version of transpose_cuda: (A, B) -> contiguous (B, A)."""
    return W.t().contiguous()


def transpose_cuda(W: torch.Tensor, direction: str = "forward"
                   ) -> torch.Tensor:
    """Tiled transpose on the card (kernels/csrc/transpose.cu): contiguous
    (A, B) float32/float64 CUDA tensor -> contiguous (B, A), any A and B.
    Launches on the current stream and does not synchronise. Counts its
    launches in `transpose_cuda.launches`, and under `direction`
    ("forward", or "backward" where window_transpose's backward calls it)
    in `transpose_cuda.launches_by_direction`."""
    from .. import kernels

    if W.dim() != 2 or W.dtype not in _DTYPE_CODE:
        raise ValueError("transpose_cuda takes a 2-D float32/float64 tensor; "
                         f"got {W.dtype} {tuple(W.shape)}")
    if direction not in transpose_cuda.launches_by_direction:
        raise ValueError(f"transpose_cuda: unknown direction {direction!r}")
    _require_cuda("transpose_cuda", ("W", W, W.dtype, W.shape))
    A, B = W.shape
    out = torch.empty((B, A), dtype=W.dtype, device=W.device)
    if A == 0 or B == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(W.device):
        err = lib.swr_transpose(
            _DTYPE_CODE[W.dtype], W.data_ptr(), out.data_ptr(), A, B,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "swr_transpose")
    transpose_cuda.launches += 1
    transpose_cuda.launches_by_direction[direction] += 1
    return out


transpose_cuda.launches = 0
transpose_cuda.launches_by_direction = {"forward": 0, "backward": 0}


def build_windows_cuda(F: torch.Tensor, spec: MarchSpec) -> torch.Tensor:
    """One-kernel window build on the card (kernels/csrc/build_windows.cu):
    contiguous (>= nf, nx, ny) float32/float64 CUDA fields -> contiguous
    (nx*ny, K) gather rows, as build_windows_reference, for any nx, ny
    and margin that fits the grid. The kernel wraps the periodic indices
    itself; no padded copy is made. Launches on the current stream and
    does not synchronise. Counts its launches in
    `build_windows_cuda.launches`."""
    from .. import kernels

    if F.dim() != 3 or F.dtype not in _DTYPE_CODE:
        raise ValueError("build_windows_cuda takes (nf, nx, ny) float32/"
                         f"float64 fields; got {F.dtype} {tuple(F.shape)}")
    _require_cuda("build_windows_cuda", ("F", F, F.dtype, F.shape))
    F = F[:spec.nf]  # a leading slice of a contiguous tensor: contiguous
    nf, nx, ny = F.shape
    if nf != spec.nf:
        raise ValueError(f"build_windows_cuda: spec.nf={spec.nf} but F holds "
                         f"{nf} fields")
    _check_window_fits(nx, ny, spec)
    out = torch.empty((nx * ny, spec.K), dtype=F.dtype, device=F.device)
    if out.numel() == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(F.device):
        err = lib.swr_build_windows(
            _DTYPE_CODE[F.dtype], F.data_ptr(), out.data_ptr(), nf, nx, ny,
            spec.SW, spec.order + spec.margin,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "swr_build_windows")
    build_windows_cuda.launches += 1
    return out


build_windows_cuda.launches = 0


# ---------------------------------------------------------------------------
# Differentiable entry points
# ---------------------------------------------------------------------------

class _BuildWindowsFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, F, spec):
        ctx.spec = spec
        ctx.f_meta = (F.shape, F.dtype, F.device)
        if F.is_cuda:
            return build_windows_cuda(F.contiguous(), spec)
        return build_windows_reference(F, spec)

    @staticmethod
    def backward(ctx, ct):
        # The build is linear in F: its cotangent is the linear transpose
        # of the plain build (a periodic scatter-add), whatever F held.
        shape, dtype, device = ctx.f_meta
        with torch.enable_grad():
            leaf = torch.zeros(shape, dtype=dtype, device=device,
                               requires_grad=True)
            (dF,) = torch.autograd.grad(
                build_windows_reference(leaf, ctx.spec), leaf, ct)
        return dF, None


def build_windows_fused(F: torch.Tensor, spec: MarchSpec) -> torch.Tensor:
    """Differentiable one-pass window build (nf, nx, ny) -> (ncells, K):
    the build kernel on a CUDA tensor, build_windows_reference on a CPU
    tensor. The backward is the linear transpose of the plain build on
    either device (there is no backward kernel, as in the JAX package)."""
    return _BuildWindowsFused.apply(F, spec)



class _WindowTranspose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, W):
        if W.is_cuda:
            return transpose_cuda(W.contiguous())
        return transpose_reference(W)

    @staticmethod
    def backward(ctx, ct):
        # a transpose's cotangent is the transpose of the cotangent
        if ct.is_cuda:
            return transpose_cuda(ct.contiguous(), direction="backward")
        return transpose_reference(ct)


def window_transpose(W: torch.Tensor) -> torch.Tensor:
    """Differentiable (A, B) -> (B, A) contiguous transpose: the transpose
    kernel on a CUDA tensor, transpose_reference on a CPU tensor, forward
    and backward."""
    return _WindowTranspose.apply(W)


def _march_forward(ctx, kernel, plain, w1, w2, xk, oi, oj, sub_dt, spec):
    """Forward of a differentiable march: its kernel on CUDA tensors, its
    plain version on CPU tensors; the inputs are saved for the backward."""
    out, ov = (kernel if xk.is_cuda else plain)(w1, w2, xk, oi, oj, sub_dt,
                                                spec)
    dt_is_tensor = isinstance(sub_dt, torch.Tensor)
    ctx.save_for_backward(w1, w2, xk, oi, oj,
                          *([sub_dt] if dt_is_tensor else []))
    ctx.sub_dt = None if dt_is_tensor else sub_dt
    ctx.spec = spec
    ctx.mark_non_differentiable(ov)
    return out, ov


def _march_backward(ctx, plain, ct_xk):
    """Cotangents of a march's inputs (w1, w2, xk, oi, oj, sub_dt, spec) by
    autograd through its plain version on the saved inputs, inside the
    span swr.march.backward."""
    w1, w2, xk, oi, oj, *rest = ctx.saved_tensors
    sub_dt = rest[0] if rest else ctx.sub_dt
    needs = ctx.needs_input_grad
    args = [w1, w2, xk, sub_dt]
    wanted = [needs[0], needs[1], needs[2], needs[5]]
    with span("swr.march.backward"), torch.enable_grad():
        leaves = [a.detach().requires_grad_(True) if w else a
                  for a, w in zip(args, wanted)]
        out, _ = plain(leaves[0], leaves[1], leaves[2], oi, oj, leaves[3],
                       ctx.spec)
        diff = [a for a, w in zip(leaves, wanted) if w]
        grads = iter(torch.autograd.grad(out, diff, ct_xk,
                                         allow_unused=True))
    g = [next(grads) if w else None for w in wanted]
    return g[0], g[1], g[2], None, None, g[3], None


class _FusedMarch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        return _march_forward(ctx, march_cuda, march_reference, *inputs)

    @staticmethod
    def backward(ctx, ct_xk, _ct_ov):
        return _march_backward(ctx, march_reference, ct_xk)


class _FusedMarchGathered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        return _march_forward(ctx, march_gathered_cuda,
                              march_gathered_reference, *inputs)

    @staticmethod
    def backward(ctx, ct_xk, _ct_ov):
        return _march_backward(ctx, march_gathered_reference, ct_xk)


def fused_march_gathered(win1, win2, xk, oi, oj, sub_dt, spec: MarchSpec):
    """Differentiable fused march from the two cell-window arrays.
    Forward: march_gathered_cuda on CUDA tensors (gather inside the
    kernel), march_gathered_reference on CPU tensors. Backward: always
    differentiates march_gathered_reference on the saved inputs (there is
    no backward kernel, as in the JAX package), giving gradients for win1
    and win2 (a scatter-add over the packets that share a cell), xk and
    sub_dt (when it is a tensor), none for oi, oj. Saves the two window
    arrays, not a gathered copy. Returns (xk_out (4, Np), overflow (Np,)
    int32)."""
    return _FusedMarchGathered.apply(win1, win2, xk, oi, oj, sub_dt, spec)


def fused_march(pw1, pw2, xk, oi, oj, sub_dt, spec: MarchSpec):
    """Differentiable fused march. Forward: the CUDA kernel on CUDA
    tensors, march_reference on CPU tensors. Backward: always
    differentiates march_reference on the saved inputs (same arithmetic;
    the cotangent w.r.t. the packet windows is dense per-packet weight
    outer products — no scatter), giving gradients for pw1, pw2, xk and
    sub_dt (when it is a tensor), none for oi, oj. Returns
    (xk_out (4, Np), overflow (Np,) int32)."""
    return _FusedMarch.apply(pw1, pw2, xk, oi, oj, sub_dt, spec)


# ---------------------------------------------------------------------------
# Ensemble members (B5): the three window-path kernels over a leading member
# axis, one launch for all members
# ---------------------------------------------------------------------------

def march_gathered_batched_reference(win1, win2, xk, oi, oj, sub_dt,
                                     spec: MarchSpec):
    """Plain version of march_gathered_batched_cuda: march_gathered_reference
    member by member. win1, win2: (E, ncells, K) (or (E, K, ncells) when not
    spec.tiles_transposed); xk (E, 4, Np); oi, oj (E, Np) int32; sub_dt (E,),
    each member's substep length (0 freezes its packets). Returns
    (xk_out (E, 4, Np), overflow (E, Np) int32)."""
    outs = [march_gathered_reference(win1[e], win2[e], xk[e], oi[e], oj[e],
                                     sub_dt[e], spec)
            for e in range(xk.shape[0])]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([ov for _, ov in outs]))


def march_gathered_batched_cuda(win1, win2, xk, oi, oj, sub_dt,
                                spec: MarchSpec, route=None, consumers=None):
    """The fused march of every member of an ensemble in ONE launch
    (kernels/csrc/march.cuh, the member on the grid's second axis):
    arguments and results as march_gathered_batched_reference, contiguous
    CUDA tensors only, (ncells, K) rows only (spec.tiles_transposed).
    `sub_dt` is a float64 (E,) CUDA tensor, read by the kernel and rounded
    to the packets' type as march_gathered_cuda rounds its argument, so a
    member's result is the bits of its single-member launch. Rows are read
    by the route march_route gives, or by `route` (on the ring route with
    `consumers` consumer warps, as march_gathered_cuda takes them). The
    ring route numbers the batches of 32 packets over all members, so its
    persistent blocks run on from one member into the next. Launches on
    the current stream and does not synchronise. Counts its launches in
    `march_gathered_batched_cuda.launches`, and by route in
    `.launches_by_route`."""
    from .. import kernels

    name = "march_gathered_batched_cuda"
    if not spec.tiles_transposed:
        raise ValueError(f"{name} reads (ncells, K) window rows "
                         "(tiles_transposed=True)")
    _check_spec(spec)
    if xk.dim() != 3 or xk.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: xk must be float32 or float64 (E, 4, Np), "
                         f"got {xk.dtype} {tuple(xk.shape)}")
    E, Np = xk.shape[0], xk.shape[-1]
    ncells = spec.nx * spec.ny
    _require_cuda(name, ("win1", win1, xk.dtype, (E, ncells, spec.K)),
                  ("win2", win2, xk.dtype, (E, ncells, spec.K)),
                  ("xk", xk, xk.dtype, (E, 4, Np)),
                  ("oi", oi, torch.int32, (E, Np)),
                  ("oj", oj, torch.int32, (E, Np)),
                  ("sub_dt", sub_dt, torch.float64, (E,)))
    if E > 65535:
        raise ValueError(f"{name}: at most 65535 members, got {E}")
    route, threads = _checked_route(name, spec, xk.dtype, route, consumers)
    out = torch.empty_like(xk)
    ov = torch.empty((E, Np), dtype=torch.int32, device=xk.device)
    if E == 0 or Np == 0:
        return out, ov
    entry_name, entry = _march_entry(kernels.load(), route, xk.dtype,
                                     batched=True)
    with torch.cuda.device(xk.device):
        err = entry(
            win1.data_ptr(), win2.data_ptr(), E, ncells, spec.K,
            xk.data_ptr(), oi.data_ptr(), oj.data_ptr(), out.data_ptr(),
            ov.data_ptr(), Np, sub_dt.data_ptr(), spec.nx, spec.ny,
            1.0 / spec.dx, 1.0 / spec.dy, spec.f ** 2, spec.Cg ** 2,
            spec.margin, spec.n_substeps, spec.nf,
            _STEPPERS.index(spec.stepper), threads,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, entry_name)
    march_gathered_batched_cuda.launches += 1
    march_gathered_batched_cuda.launches_by_route[route] += 1
    return out, ov


march_gathered_batched_cuda.launches = 0
march_gathered_batched_cuda.launches_by_route = dict.fromkeys(_ROUTES, 0)


def march_gathered_batched(win1, win2, xk, oi, oj, sub_dt, spec: MarchSpec):
    """The members' fused march: march_gathered_batched_cuda on CUDA
    tensors (one launch), march_gathered_batched_reference on CPU
    tensors. `sub_dt` is an (E,) float64 tensor on the packets' device.
    Not differentiable (the ensemble is not differentiated, here or in the
    JAX package). Returns (xk_out (E, 4, Np), overflow (E, Np) int32)."""
    if xk.is_cuda:
        return march_gathered_batched_cuda(win1, win2, xk, oi, oj, sub_dt,
                                           spec)
    return march_gathered_batched_reference(win1, win2, xk, oi, oj, sub_dt,
                                            spec)


def transpose_batched_reference(W: torch.Tensor) -> torch.Tensor:
    """Plain version of transpose_batched_cuda: transpose_reference member
    by member, (E, A, B) -> (E, B, A)."""
    return torch.stack([transpose_reference(w) for w in W])


def transpose_batched_cuda(W: torch.Tensor) -> torch.Tensor:
    """E tiled transposes in ONE launch (kernels/csrc/transpose.cu, the
    member on the grid's second axis): contiguous (E, A, B) float32/float64
    CUDA tensor -> contiguous (E, B, A), exact. Launches on the current
    stream and does not synchronise. Counts its launches in
    `transpose_batched_cuda.launches`."""
    from .. import kernels

    if W.dim() != 3 or W.dtype not in _DTYPE_CODE:
        raise ValueError("transpose_batched_cuda takes an (E, A, B) "
                         f"float32/float64 tensor; got {W.dtype} "
                         f"{tuple(W.shape)}")
    _require_cuda("transpose_batched_cuda", ("W", W, W.dtype, W.shape))
    E, A, B = W.shape
    if E > 65535:
        raise ValueError(f"transpose_batched_cuda: at most 65535 members, "
                         f"got {E}")
    out = torch.empty((E, B, A), dtype=W.dtype, device=W.device)
    if out.numel() == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(W.device):
        err = lib.swr_transpose_batched(
            _DTYPE_CODE[W.dtype], W.data_ptr(), out.data_ptr(), E, A, B,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "swr_transpose_batched")
    transpose_batched_cuda.launches += 1
    return out


transpose_batched_cuda.launches = 0


def transpose_batched(W: torch.Tensor) -> torch.Tensor:
    """(E, A, B) -> contiguous (E, B, A): transpose_batched_cuda on a CUDA
    tensor (one launch), transpose_batched_reference on a CPU tensor."""
    if W.is_cuda:
        return transpose_batched_cuda(W.contiguous())
    return transpose_batched_reference(W)


def build_windows_batched_reference(F: torch.Tensor,
                                    spec: MarchSpec) -> torch.Tensor:
    """Plain version of build_windows_batched_cuda: build_windows_reference
    member by member, (E, >= nf, nx, ny) -> (E, nx*ny, K)."""
    return torch.stack([build_windows_reference(f, spec) for f in F])


def build_windows_batched_cuda(F: torch.Tensor,
                               spec: MarchSpec) -> torch.Tensor:
    """The one-kernel window build of every member in ONE launch
    (kernels/csrc/build_windows.cu, the member on the grid's second axis):
    (E, >= nf, nx, ny) float32/float64 CUDA fields, contiguous -> contiguous
    (E, nx*ny, K), exactly as build_windows_batched_reference. Launches on
    the current stream and does not synchronise. Counts its launches in
    `build_windows_batched_cuda.launches`."""
    from .. import kernels

    if F.dim() != 4 or F.dtype not in _DTYPE_CODE:
        raise ValueError("build_windows_batched_cuda takes (E, nf, nx, ny) "
                         f"float32/float64 fields; got {F.dtype} "
                         f"{tuple(F.shape)}")
    _require_cuda("build_windows_batched_cuda", ("F", F, F.dtype, F.shape))
    E, nf_all, nx, ny = F.shape
    if nf_all < spec.nf:
        raise ValueError(f"build_windows_batched_cuda: spec.nf={spec.nf} but "
                         f"F holds {nf_all} fields")
    if E > 65535:
        raise ValueError(f"build_windows_batched_cuda: at most 65535 members, "
                         f"got {E}")
    _check_window_fits(nx, ny, spec)
    out = torch.empty((E, nx * ny, spec.K), dtype=F.dtype, device=F.device)
    if out.numel() == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(F.device):
        # each member's first nf fields are contiguous; members lie
        # F.stride(0) elements apart
        err = lib.swr_build_windows_batched(
            _DTYPE_CODE[F.dtype], F.data_ptr(), out.data_ptr(), E,
            F.stride(0), spec.nf, nx, ny, spec.SW, spec.order + spec.margin,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "swr_build_windows_batched")
    build_windows_batched_cuda.launches += 1
    return out


build_windows_batched_cuda.launches = 0


def build_windows_batched(F: torch.Tensor, spec: MarchSpec) -> torch.Tensor:
    """(E, nf, nx, ny) -> (E, nx*ny, K) in one pass:
    build_windows_batched_cuda on a CUDA tensor (one launch),
    build_windows_batched_reference on a CPU tensor."""
    if F.is_cuda:
        return build_windows_batched_cuda(F.contiguous(), spec)
    return build_windows_batched_reference(F, spec)
