"""The gradient of a packet statistic with respect to the flow, for
sensitivity studies: the two-layer model through
`models.coupled2.run_coupled2_chunk(remat=True)`.

A unit runs steps_per_save lock-steps from the current state with the PV
spectrum `qk` requiring grad, takes L = var(omega) of the packets at the
end (GRAD_r05's statistic) and back-propagates dL/dqk; the next unit
starts from the detached carry. One host read a unit: L, whether the
gradient is finite, and the overflow. As in forward.py, a sampled unit
keeps its input and its answers (the end state, L and dL/dqk) for the
reference, and the start is checked by itself. The carried velocity
grids of the step before are a constant of the unit, in the program and
in the reference alike.
"""

import dataclasses
import time

import torch
from torch.profiler import record_function

from swraytracing_torch.models.coupled2 import run_coupled2_chunk

from .. import compare
from ..reference import exact, lowp, packets
from ..reference.qg2 import QG2
from ..reference.rays import flow_step
from . import forward


def omega_var(k, f, Cg):
    """var(omega) of packets k (..., 2, P) and the omegas."""
    om = torch.sqrt(f * f + Cg * Cg * (k * k).sum(-2))
    return om.var(correction=0), om


class Cell(forward.Cell):
    kind = "grad"

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.events = []

    def warmup(self):
        super().warmup()
        self.events = []

    def unit(self, keep=False, saves=None):
        cfg, c = self.cfg, self.carry
        qk = c.flow_state.qk.detach().requires_grad_(True)
        c_in = dataclasses.replace(
            c, flow_state=dataclasses.replace(c.flow_state, qk=qk))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if qk.is_cuda else None
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        with record_function("bench.forward"):
            c2, _ = run_coupled2_chunk(c_in, self.s, cfg, 1, remat=True)
            L, _ = omega_var(c2.packet_k, cfg.f, cfg.Cg)
        if ev:
            ev[1].record()
        with record_function("bench.backward"):
            if L.requires_grad:
                L.backward()
            else:       # L does not depend on the flow: no gradient came
                qk.grad = torch.full_like(qk, float("nan"))
        if ev:
            ev[2].record()
            self.events.append(ev)
        enqueue_s = time.perf_counter() - t0
        with record_function("bench.host_read"):
            host = torch.stack([L.detach(),
                                torch.isfinite(qk.grad).all().to(L.dtype),
                                c2.overflow.to(L.dtype)]).cpu()
        ok = bool(torch.isfinite(host[0])) and bool(host[1])
        ov = int(host[2])
        self.overflow = max(self.overflow, ov)
        fs = c2.flow_state
        self.carry = dataclasses.replace(
            c2, flow_state=dataclasses.replace(
                fs, qk=fs.qk.detach(), rhs_m1=fs.rhs_m1.detach(),
                rhs_m2=fs.rhs_m2.detach()),
            packet_x=c2.packet_x.detach(), packet_k=c2.packet_k.detach(),
            prev_fields=c2.prev_fields.detach(),
            overflow=torch.zeros_like(c2.overflow))
        if keep:
            st = c.flow_state
            self.samples.append({
                "in": (st.qk, st.rhs_m1, st.rhs_m2, st.step,
                       c.packet_x, c.packet_k),
                "out": (self.carry.flow_state.qk, self.carry.packet_x,
                        self.carry.packet_k, float(host[0]), qk.grad)})
        return {"steps": self.steps, "work": self.steps * cfg.n_packets,
                "enqueue_s": enqueue_s, "ok": ok and not ov}

    def timings(self):
        if not self.events:
            return {}
        self.events[-1][2].synchronize()
        fwd = sum(e[0].elapsed_time(e[1]) for e in self.events) / 1e3
        bwd = sum(e[1].elapsed_time(e[2]) for e in self.events) / 1e3
        return {"grad": {"units": len(self.events), "forward_s": fwd,
                         "backward_s": bwd}}

    # -- the comparison -----------------------------------------------

    def reference(self, rnd=exact, dtype=torch.float64,
                  block=1 << 18):
        """The reference's start, and for each sample the end state, L
        and dL/dqk from its input: the flow's steps once, with their
        graph; the packets in blocks, first for omega's mean, then each
        block's share of dL/domega = 2 (omega - mean) / N back through it."""
        cfg, c = self.cfg, self.config["Coupled2Config"]
        R = QG2(c, self.device, dtype)
        qk0, _, dt = R.initial(self.seed, cfg.U_g, rnd)
        x0, k0 = map(rnd, packets.ring(self.seed, cfg.n_packets,
                                       cfg.near_inertial_factor, cfg.f,
                                       cfg.Cg, cfg.L, self.device, dtype))
        R.set_dt(dt)
        delay = cfg.packet_delay_days / cfg.f
        runs = []
        for smp in self.samples:
            qk, r1, r2, n, x, k = smp["in"]
            cd = qk0.dtype
            leaf = rnd(qk.to(cd, copy=True)).requires_grad_(True)
            grids = [R.velocity(leaf.detach(), rnd)[None]]
            st = (leaf, rnd(r1.to(cd)), rnd(r2.to(cd)))
            hs = []
            for s in range(self.steps):
                st = R.step(*st, n + s, rnd)
                grids.append(R.velocity(st[0], rnd)[None])
                hs.append(torch.tensor(
                    [dt / cfg.n_substeps if (n + s + 1) * dt > delay
                     else 0.0], dtype=dtype, device=self.device))
            x, k = rnd(x.to(dtype))[None], rnd(k.to(dtype))[None]

            def packets_through(b0, grids):
                xb, kb = x[..., b0:b0 + block], k[..., b0:b0 + block]
                for s in range(self.steps):
                    xb, kb = flow_step(grids[s], grids[s + 1], xb, kb, hs[s],
                                       cfg.n_substeps, cfg.f, cfg.Cg,
                                       R.grid.dx, R.grid.dy, rnd)
                return xb, kb

            P = x.shape[-1]
            with torch.no_grad():
                ends = [packets_through(b0, [g.detach() for g in grids])
                        for b0 in range(0, P, block)]
            xe = torch.cat([e[0] for e in ends], -1)[0]
            ke = torch.cat([e[1] for e in ends], -1)[0]
            L, om = omega_var(ke, cfg.f, cfg.Cg)
            mean = om.mean()
            del ends
            for b0 in range(0, P, block):
                _, kb = packets_through(b0, grids)
                omb = torch.sqrt(cfg.f ** 2 + cfg.Cg ** 2 * (kb * kb).sum(-2))
                coef = (2.0 * (omb - mean) / P).detach()
                (coef * omb).sum().backward(retain_graph=True)
            runs.append((st[0].detach(), xe, ke, float(L), leaf.grad))
        return (qk0, x0, k0, dt), runs

    def numbers(self, start, runs, ref_start, ref_runs):
        cfg = self.cfg
        dx = cfg.L / cfg.nx
        qk0, x0, k0, dt = start
        rq, rx, rk, rdt = ref_start
        out = {"start_rel": max(compare.rel_l2(qk0, rq),
                                compare.periodic_start(x0, rx, dx),
                                compare.k_max_rel(k0, rk),
                                abs(dt / rdt - 1.0))}
        gaps = {"qk_rel": [], "x_max_cells": [], "k_max_rel": [],
                "loss_rel": [], "grad_rel": []}
        for (qk, x, k, L, g), (q, xr, kr, Lr, gr) in zip(runs, ref_runs):
            gaps["qk_rel"].append(compare.rel_l2(qk, q))
            gaps["x_max_cells"].append(compare.x_max_cells(x, xr, cfg.L, dx))
            gaps["k_max_rel"].append(compare.k_max_rel(k, kr))
            gaps["loss_rel"].append(abs(L / Lr - 1.0))
            gaps["grad_rel"].append(compare.rel_l2(g, gr))
        out.update({k: max(v) for k, v in gaps.items()})
        return out

    def check(self):
        ref_start, ref_runs = self.reference()
        runs = [smp["out"] for smp in self.samples]
        out = self.numbers(self.start, runs, ref_start, ref_runs)
        out["overflow"] = self.overflow
        return out

    def control(self):
        ref_start, ref_runs = self.reference()
        low_start, low_runs = self.reference(lowp, torch.float32)
        return self.numbers(low_start, low_runs, ref_start, ref_runs)
