"""The coupled lock-step, plain: flow steps, then the packets through
each step's two velocity snapshots (models/coupled.lockstep_step, commit
701921e): the packets move with substep dt / n once the time after the
flow step passes the packet delay, and the omega histogram is taken
after every `save_every` steps.

The flow runs first over all the steps, keeping every step's velocity
grids; the packets then follow in blocks, so the reference fits beside
any packet count.
"""

import torch

from . import exact, hist
from .rays import flow_step


def flow_and_packets(step_flow, velocity, state, x, k, steps, save_every,
                     sub_dt, n_sub, f, Cg, dx, dy, bins, omega_max,
                     block=1 << 20, rnd=exact):
    """state: the flow's (qk, r1, r2, n); x, k (E, 2, P); sub_dt(s) the
    members' (E,) substep length of step s. Returns (state, x, k, rows
    (E, steps // save_every, bins + 1))."""
    grids = [velocity(state[0], rnd)]
    for s in range(steps):
        state = step_flow(state, s, rnd)
        grids.append(velocity(state[0], rnd))
    xs, ks, rows = [], [], 0
    for b0 in range(0, x.shape[-1], block):
        xb, kb = x[..., b0:b0 + block], k[..., b0:b0 + block]
        saved = []
        for s in range(steps):
            xb, kb = flow_step(grids[s], grids[s + 1], xb, kb, sub_dt(s),
                               n_sub, f, Cg, dx, dy, rnd)
            if (s + 1) % save_every == 0:
                saved.append(hist.counts(kb, f, Cg, bins, omega_max))
        xs.append(xb)
        ks.append(kb)
        rows = rows + torch.stack(saved, 1)
    return state, torch.cat(xs, -1), torch.cat(ks, -1), rows
