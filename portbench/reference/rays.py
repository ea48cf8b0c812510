"""One flow step of the packets, plain: n rk23 substeps through the
time-blended flow.

Copied from swraytracing_torch/ops/march_window._march_core and
models/coupled.lockstep_step (commit 701921e): the ray equations
dx/dt = U + Cg^2 k / omega, dk/dt = -(grad U)^T k with
omega = sqrt(f^2 + Cg^2 |k|^2); Bogacki-Shampine stages (MATLAB's
ode23); the flow blended linearly between the step's two snapshots at
alpha = (i + stage) / n (interpolate_U.m:19-23).
"""

import torch

from . import exact
from .stencil import flow_at


def flow_step(G1, G2, x, k, h, n, f, Cg, dx, dy, rnd=exact):
    """x, k (E, 2, P) after n rk23 substeps of length h (E,) (0 holds a
    member's packets) from snapshot G1 to G2 (E, 2, nx, ny)."""
    gH = Cg * Cg
    h = h.to(x.dtype)[:, None, None]

    def rhs(xx, kk, alpha):
        G = (1.0 - alpha) * G1 + alpha * G2
        u, v, ux, uy, vx, vy = flow_at(G, xx[:, 0], xx[:, 1], dx, dy)
        om = torch.sqrt(f * f + gH * (kk * kk).sum(1))
        dx_dt = torch.stack([u + gH * kk[:, 0] / om,
                             v + gH * kk[:, 1] / om], 1)
        dk_dt = torch.stack([-(ux * kk[:, 0] + vx * kk[:, 1]),
                             -(uy * kk[:, 0] + vy * kk[:, 1])], 1)
        return dx_dt, dk_dt

    for i in range(n):
        a0, da = i / n, 1.0 / n
        d = rhs(x, k, a0)
        e = rhs(x + 0.5 * h * d[0], k + 0.5 * h * d[1], a0 + 0.5 * da)
        g = rhs(x + 0.75 * h * e[0], k + 0.75 * h * e[1], a0 + 0.75 * da)
        c = h / 9.0
        x = rnd(x + c * (2.0 * d[0] + 3.0 * e[0] + 4.0 * g[0]))
        k = rnd(k + c * (2.0 * d[1] + 3.0 * e[1] + 4.0 * g[1]))
    return x, k
