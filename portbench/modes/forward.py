"""A forward coupled run of the two-layer model, chunk by chunk, as the
production driver runs it in diagnostic mode (drivers._run_coupled).

A unit is one call of `models.coupled2.run_coupled2_chunk`: steps_per_save
flow steps and the omega-histogram row after them, times
saves_per_unit; then one host read of the finite flag, the overflow and
the rows. A sampled unit keeps its input state and its output, and the
reference runs the same steps from that input: the program's own state
(PV, the AB history, the step count, the packets), as a simulation can
only be followed. The start (the initial state and dt made from the
seed) is checked by itself.
"""

import copy
import dataclasses
import time

import torch
from torch.profiler import record_function

from swraytracing_torch.analysis.device_diag import (OmegaHistSpec,
                                                     omega_hist_counts)
from swraytracing_torch.models.coupled2 import (Coupled2Config,
                                                run_coupled2_chunk,
                                                setup_coupled2)

from .. import compare
from ..counts import march as counts
from ..reference import exact, lowp, packets
from ..reference.coupled import flow_and_packets
from ..reference.qg2 import QG2


def _judged(cfg):
    """Refuse a configuration whose path the reference does not follow."""
    if (cfg.dealias or not cfg.ring_ic or cfg.stepper != "rk23"
            or not (cfg.fused_march and cfg.march_uv_windows)
            or getattr(cfg, "one_layer_quirk", False)
            or getattr(cfg, "reference_quirks", False)):
        raise ValueError("the reference follows the fused rk23 march with "
                         "uv windows, the ring IC and no dealiasing or "
                         "quirks")


class Cell:
    kind = "forward"

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        p = dict(config["Coupled2Config"], n_packets=traffic["n_packets"],
                 packet_steps_per_save=traffic["steps_per_save"], seed=seed)
        self.cfg = cfg = Coupled2Config(**p)
        _judged(cfg)
        self.s, c0 = setup_coupled2(cfg, device=self.device, dtype=self.dtype)
        if self.s.march is None:
            raise ValueError("the reference judges the fused march only: "
                             "n_packets below window_min_np")
        self.start = (c0.flow_state.qk, c0.packet_x, c0.packet_k, self.s.dt)
        if "bins" in traffic:
            self.wmax = traffic["omega_max_factor"] \
                * cfg.near_inertial_factor * cfg.f
            spec = OmegaHistSpec(n_bins=traffic["bins"], omega_max=self.wmax,
                                 f=cfg.f, Cg=cfg.Cg, omega_min=cfg.f,
                                 log_bins=True)

            def diag(c):
                with record_function("bench.diag"):
                    return omega_hist_counts(c.packet_k, spec)

            self.diag = diag
        self.n_members = 1
        self.carry = c0
        self.samples = []
        self.overflow = 0
        self.steps = traffic["steps_per_save"] * traffic["saves_per_unit"]

    def warmup(self):
        for _ in range(self.traffic["warmup_units"]):
            self.unit()
        self.carry_start = self.carry

    def restart(self):
        self.carry = self.carry_start

    def _chunk(self, c_in, saves):
        """One call of the entry: (carry, histogram rows)."""
        c, (hc, _) = run_coupled2_chunk(c_in, self.s, self.cfg, saves,
                                        diag_fn=self.diag)
        return c, hc

    def unit(self, keep=False, saves=None):
        saves = saves or self.traffic["saves_per_unit"]
        c_in, E = self.carry, self.n_members
        t0 = time.perf_counter()
        with record_function("bench.chunk"):
            c, hc = self._chunk(c_in, saves)
        enqueue_s = time.perf_counter() - t0
        with record_function("bench.host_read"):
            flags = torch.cat([
                torch.isfinite(c.flow_state.qk).reshape(E, -1).all(1),
                c.overflow.reshape(-1)]).to(hc.dtype)
            host = torch.cat([flags, hc.reshape(-1)]).cpu()
        finite = bool(host[:E].all())
        ov = int(host[E:2 * E].max())
        if ov:
            self.overflow = max(self.overflow, ov)
            c = dataclasses.replace(c, overflow=torch.zeros_like(c.overflow))
        self.carry = c
        if keep:
            st = c_in.flow_state
            self.samples.append({
                "in": (st.qk, st.rhs_m1, st.rhs_m2, copy.copy(st.step),
                       c_in.packet_x, c_in.packet_k),
                "out": (c.flow_state.qk, c.packet_x, c.packet_k),
                "rows": host[2 * E:].reshape(hc.shape)})
        steps = self.traffic["steps_per_save"] * saves
        return {"steps": steps, "work": steps * self.cfg.n_packets * E,
                "enqueue_s": enqueue_s, "ok": finite and not ov}

    def march_bound_s_per_step(self):
        E, n = self.n_members, self.cfg.n_packets
        return counts.bound_s(
            counts.flops(self.s.march, E * n),
            counts.bytes_moved(self.s.march, E * n, E, self.dtype.itemsize))

    def timings(self):
        return {}

    def release(self):
        self.carry = self.carry_start = None

    # -- the comparison -----------------------------------------------

    def reference(self, rnd=exact, dtype=torch.float64):
        """The reference's start and its run from each sample's input."""
        cfg, c = self.cfg, self.config["Coupled2Config"]
        R = QG2(c, self.device, dtype)
        qk0, _, dt = R.initial(self.seed, cfg.U_g, rnd)
        x0, k0 = map(rnd, packets.ring(self.seed, cfg.n_packets,
                                       cfg.near_inertial_factor, cfg.f,
                                       cfg.Cg, cfg.L, self.device, dtype))
        R.set_dt(dt)
        delay = cfg.packet_delay_days / cfg.f
        cd = qk0.dtype
        runs = []
        for smp in self.samples:
            qk, r1, r2, n, x, k = smp["in"]
            state = (rnd(qk.to(cd)), rnd(r1.to(cd)), rnd(r2.to(cd)), n)

            def step(st, s, rnd):
                q, a, b = R.step(st[0], st[1], st[2], st[3], rnd)
                return (q, a, b, st[3] + 1)

            def sub_dt(s, n=n):
                h = dt / cfg.n_substeps if (n + s + 1) * dt > delay else 0.0
                return torch.tensor([h], dtype=dtype, device=self.device)

            st, xe, ke, rows = flow_and_packets(
                step, lambda q, rnd: R.velocity(q, rnd)[None], state,
                rnd(x.to(dtype))[None], rnd(k.to(dtype))[None], self.steps,
                cfg.packet_steps_per_save, sub_dt, cfg.n_substeps, cfg.f,
                cfg.Cg, R.grid.dx, R.grid.dy, self.traffic["bins"],
                [self.wmax], rnd=rnd)
            runs.append((st[0], xe[0], ke[0], rows[0]))
        return (qk0, x0, k0, dt), runs

    def numbers(self, start, runs, ref_start, ref_runs):
        cfg = self.cfg
        return compare.unit_numbers(
            start, runs, ref_start, ref_runs, cfg.L, cfg.L / cfg.nx,
            cfg.n_packets, self.traffic["check"].get("early_rows"))

    def check(self):
        ref_start, ref_runs = self.reference()
        runs = [smp["out"] + (smp["rows"],) for smp in self.samples]
        out = self.numbers(self.start, runs, ref_start, ref_runs)
        out["overflow"] = self.overflow
        return out

    def control(self):
        """The numbers with the reference in bfloat16 storage (float32
        arithmetic) put in the program's place."""
        ref_start, ref_runs = self.reference()
        low_start, low_runs = self.reference(lowp, torch.float32)
        return self.numbers(low_start, low_runs, ref_start, ref_runs)
