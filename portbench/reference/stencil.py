"""The 6x6 Lagrange stencil on a periodic grid, plain.

Copied from swraytracing_torch/ops/interp.py and the arithmetic of
ops/march_window._eval_fields (commit 701921e), which the march kernel
computes: 2-D Lagrange interpolation of order 2 (nodes -2..3 around the
packet's cell, interpolate.m:12-50) of the velocity grids (u, v), and the
velocity-gradient tensor as the derivative of that interpolant
(w_i'(fx) w_j(fy) / dx). Here every stencil node is read from the grid
itself, with periodic wraparound: no window, no margin.
"""

import numpy as np
import torch

OFFSETS = (-2, -1, 0, 1, 2, 3)


def _basis():
    """Monomial coefficients (6, 6) of the 6 Lagrange basis polynomials,
    w_i(fr) = prod_{j != i} (fr - o_j) / (o_i - o_j), and (6, 5) of their
    derivatives, float64: lowest power first."""
    w, dw = [], []
    for i, oi in enumerate(OFFSETS):
        p = np.poly1d([1.0])
        for j, oj in enumerate(OFFSETS):
            if j != i:
                p = p * np.poly1d([1.0, -oj]) / (oi - oj)
        w.append(p.coeffs[::-1])
        dw.append(p.deriv().coeffs[::-1])
    return np.array(w), np.array(dw)


W_COEF, DW_COEF = _basis()


def weights(fr):
    """(w, dw): the 6 basis weights and their derivatives at fractional
    position fr (...,), each (..., 6), from the polynomials' coefficients
    (the same polynomials as the product form, evaluated in one pass)."""
    powers = torch.stack([torch.ones_like(fr), fr, fr * fr, fr ** 3,
                          fr ** 4, fr ** 5], -1)[..., None, :]
    c = torch.as_tensor(W_COEF, dtype=fr.dtype, device=fr.device)
    d = torch.as_tensor(DW_COEF, dtype=fr.dtype, device=fr.device)
    return (powers * c).sum(-1), (powers[..., :5] * d).sum(-1)


def _cell(x, d, n):
    xl = torch.remainder(x / d, n)
    i0 = torch.floor(xl)
    return torch.remainder(i0.long(), n), xl - i0


def flow_at(G, x, y, dx, dy):
    """u, v, u_x, u_y, v_x, v_y, each (E, P), of the grids G (E, 2, nx, ny)
    at positions x, y (E, P)."""
    E, _, nx, ny = G.shape
    i0, fx = _cell(x, dx, nx)
    j0, fy = _cell(y, dy, ny)
    wx, dwx = weights(fx)                                   # (E, P, 6)
    wy, dwy = weights(fy)
    off = torch.tensor(OFFSETS, device=x.device)
    ix = torch.remainder(i0[..., None] + off, nx)           # (E, P, 6)
    iy = torch.remainder(j0[..., None] + off, ny)
    idx = (ix[..., :, None] * ny + iy[..., None, :]).reshape(E, 1, -1)
    vals = torch.gather(G.reshape(E, 2, nx * ny), 2,
                        idx.expand(E, 2, idx.shape[-1]))
    vals = vals.reshape(E, 2, x.shape[1], 6, 6)             # node (a, b)
    ty = (vals * wy[:, None, :, None, :]).sum(-1)           # (E, 2, P, 6)
    tdy = (vals * dwy[:, None, :, None, :]).sum(-1)
    wx, dwx = wx[:, None], dwx[:, None]
    u, v = (ty * wx).sum(-1).unbind(1)
    ux, vx = ((ty * dwx).sum(-1) / dx).unbind(1)
    uy, vy = ((tdy * wx).sum(-1) / dy).unbind(1)
    return u, v, ux, uy, vx, vy
