"""O(1)-memory exact gradients through the symplectic ray loop.

Counterpart of swraytracing_tpu/models/reversible.py. Reverse-mode
differentiation through N ray steps stores O(N) packet states; this
module exploits the exact invertibility of the Strang splitting
(ode_symplectic.m:13-37):

    step = phi1(dt/2) o phi2(dt) o phi1(dt/2)

  * phi1 (free drift, x += dt/2 C(k), k frozen) inverts in closed form;
  * phi2 (flow kick at the pre-kick position x: x' = x + dt U(x),
    k' = k - dt (grad U)^T(x) k) inverts by
      - fixed-point iteration for x (x = x' - dt U(x); a contraction with
        factor dt*|grad U|, the CFL number, so a handful of iterations
        reaches machine precision), and
      - an exact 2x2 linear solve for k (k' = (I - dt G^T) k with
        G = grad U at the reconstructed x).

The backward (a torch.autograd.Function) keeps ONLY the final state and
the flow's tensors; it re-derives each previous state with the inverse
map and takes one step's vector-Jacobian product there by
torch.autograd.grad, summing the cotangents of (x0, k0) and of the flow's
tensors (AnalyticFlow.params and a tensor `t`, or GriddedFlow.fields and
its windows). Memory is O(1) in the number of steps; compute is about
twice a forward pass plus one step's VJP per step.

As in the JAX package this covers steady flows; the coupled models
rematerialise each lock-step instead (run_coupled_chunk(remat=True)),
because inverting the filtered QG step amplifies roundoff.
"""

from __future__ import annotations

import dataclasses

import torch

from .dispersion import Dispersion
from .fields import AnalyticFlow, GriddedFlow
from .rays import _phi1, symplectic_step

__all__ = ["make_reversible_integrator", "inverse_symplectic_step"]

_FP_ITERS = 8  # fixed-point iterations for the phi2 position inverse


def _phi2_inverse(x1, k1, dt, flow, alpha=0.0):
    """Invert the flow kick: find (x, k) with x1 = x + dt U(x),
    k1 = k - dt (grad U)^T(x) k."""
    x = x1
    for _ in range(_FP_ITERS):
        x = x1 - dt * flow.at(x[0], x[1], alpha).uv
    ev = flow.at(x[0], x[1], alpha)
    # k1 = (I - dt G^T) k, G^T rows: [u_x, v_x; u_y, v_y]
    a = 1.0 - dt * ev.u_x
    b = -dt * ev.v_x
    c = -dt * ev.u_y
    d = 1.0 - dt * ev.v_y
    det = a * d - b * c
    k = torch.stack([(d * k1[0] - b * k1[1]) / det,
                     (-c * k1[0] + a * k1[1]) / det], dim=0)
    return x, k


def inverse_symplectic_step(x, k, dt, disp: Dispersion, flow, alpha=0.0):
    """Exact inverse of rays.symplectic_step (to fixed-point tolerance)."""
    x, k = _phi1(x, k, -0.5 * dt, disp)
    x, k = _phi2_inverse(x, k, dt, flow, alpha)
    x, k = _phi1(x, k, -0.5 * dt, disp)
    return x, k


def _flow_tensors(flow):
    """The flow's differentiable tensors and a function that rebuilds the
    flow from replacements of them (in the same order)."""
    if isinstance(flow, AnalyticFlow):
        names = list(flow.params)
        with_t = isinstance(flow.t, torch.Tensor)
        tensors = [flow.params[n] for n in names] + ([flow.t] if with_t
                                                      else [])

        def rebuild(ts):
            return dataclasses.replace(
                flow, params=dict(zip(names, ts[:len(names)])),
                t=ts[len(names)] if with_t else flow.t)
        return tensors, rebuild
    if isinstance(flow, GriddedFlow):
        tensors = [flow.fields] + ([flow.win] if flow.win is not None
                                   else [])

        def rebuild(ts):
            return dataclasses.replace(
                flow, fields=ts[0], win=ts[1] if len(ts) > 1 else None)
        return tensors, rebuild
    raise TypeError("the reversible integrator takes an AnalyticFlow or a "
                    f"GriddedFlow, got {type(flow).__name__}")


class _Reversible(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, k0, rebuild, disp, dt, nsteps, alpha, *flow_ts):
        flow = rebuild(list(flow_ts))
        x, k = x0, k0
        for _ in range(nsteps):
            x, k = symplectic_step(x, k, dt, disp, flow, alpha)
        ctx.save_for_backward(x, k, *flow_ts)
        ctx.args = (rebuild, disp, dt, nsteps, alpha)
        return x, k

    @staticmethod
    def backward(ctx, xbar, kbar):
        rebuild, disp, dt, nsteps, alpha = ctx.args
        x, k, *flow_ts = ctx.saved_tensors
        flow = rebuild(flow_ts)
        want = list(ctx.needs_input_grad[7:])
        fbar = [torch.zeros_like(t) if w else None
                for t, w in zip(flow_ts, want)]
        for _ in range(nsteps):
            x, k = inverse_symplectic_step(x, k, dt, disp, flow, alpha)
            with torch.enable_grad():
                xl = x.detach().requires_grad_(True)
                kl = k.detach().requires_grad_(True)
                leaves = [t.detach().requires_grad_(w)
                          for t, w in zip(flow_ts, want)]
                x1, k1 = symplectic_step(xl, kl, dt, disp, rebuild(leaves),
                                         alpha)
                diff = [xl, kl] + [t for t, w in zip(leaves, want) if w]
                grads = torch.autograd.grad((x1, k1), diff, (xbar, kbar),
                                            allow_unused=True)
            xbar, kbar = grads[0], grads[1]
            rest = iter(grads[2:])
            for i, w in enumerate(want):
                if w:
                    g = next(rest)
                    if g is not None:
                        fbar[i] = fbar[i] + g
        return (xbar, kbar, None, None, None, None, None, *fbar)


def make_reversible_integrator(disp: Dispersion, dt: float, nsteps: int,
                               alpha: float = 0.0):
    """Build `integrate(x0, k0, flow) -> (xN, kN)`: nsteps symplectic
    steps whose backward takes O(1) memory in nsteps (see the module
    docstring). `flow` is an AnalyticFlow or a GriddedFlow; gradients
    reach x0, k0 and the flow's tensors (AnalyticFlow.params, a tensor
    `t`; GriddedFlow.fields and .win) wherever they require them."""

    def integrate(x0, k0, flow):
        tensors, rebuild = _flow_tensors(flow)
        return _Reversible.apply(x0, k0, rebuild, disp, dt, nsteps, alpha,
                                 *tensors)

    return integrate
