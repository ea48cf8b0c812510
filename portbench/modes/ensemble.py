"""An ensemble sweep of the one-layer model, every member in one program,
chunk by chunk as the sweep driver runs it (drivers._run_sweep_ensemble).

A unit is one call of `parallel.ensemble.run_ensemble_chunk`: for every
member, steps_per_save flow steps and the member's omega-histogram row
after them, times saves_per_unit; then one host read of the members'
finite flags, their overflow counts and the rows. As in forward.py, a
sampled unit keeps its input state and output, the reference runs the
same steps from that input, and the start is checked by itself.
"""

import numpy as np
import torch
from torch.profiler import record_function

from swraytracing_torch.analysis.device_diag import (OmegaHistSpec,
                                                     omega_hist_counts)
from swraytracing_torch.models.coupled import CoupledConfig
from swraytracing_torch.parallel.ensemble import (run_ensemble_chunk,
                                                  setup_ensemble)

from ..reference import exact, packets
from ..reference.coupled import flow_and_packets
from ..reference.qg import QG
from . import forward


class Cell(forward.Cell):
    """forward.Cell's unit, restart and comparison over the members."""

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.members = [tuple(m) for m in config["members"]]
        base = dict(config["CoupledConfig"], n_packets=traffic["n_packets"],
                    packet_steps_per_save=traffic["steps_per_save"],
                    seed=seed)
        self.cfgs = [CoupledConfig(**dict(base, near_inertial_factor=w0,
                                          U_g=ug))
                     for w0, ug in self.members]
        self.cfg = cfg = self.cfgs[0]
        forward._judged(cfg)
        self.s, es, c0 = setup_ensemble(self.cfgs, device=self.device,
                                        dtype=self.dtype)
        if self.s.march is None:
            raise ValueError("the reference judges the fused march only: "
                             "n_packets below window_min_np")
        self.es = es.replace(T=[config["T_member"]] * len(self.members))
        self.start = (c0.flow_state.qk, c0.packet_x, c0.packet_k, es.dt)
        self.wmax = [traffic["omega_max_factor"] * w0 * cfg.f
                     for w0, _ in self.members]
        spec = OmegaHistSpec(n_bins=traffic["bins"], omega_max=1.0,
                             f=cfg.f, Cg=cfg.Cg, omega_min=cfg.f,
                             log_bins=True)
        wmax = torch.as_tensor(self.wmax, dtype=self.dtype,
                               device=self.device)

        def diag(c, i):
            with record_function("bench.diag"):
                return omega_hist_counts(c.packet_k, spec, omega_max=wmax[i])

        self.diag = diag
        self.n_members = len(self.members)
        self.carry = c0
        self.samples = []
        self.overflow = 0
        self.steps = traffic["steps_per_save"] * traffic["saves_per_unit"]

    def _chunk(self, c_in, saves):
        c, (hc, _) = run_ensemble_chunk(c_in, self.es, self.s, self.cfg,
                                        saves, diag_fn=self.diag)
        return c, hc

    # -- the comparison -----------------------------------------------

    def reference(self, rnd=exact, dtype=torch.float64):
        cfg = self.cfg
        R = QG(dict(self.config["CoupledConfig"]), self.device, dtype)
        ics = [R.initial(self.seed, ug, rnd) for _, ug in self.members]
        qk0 = torch.stack([a[0] for a in ics])
        dts = np.array([a[2] for a in ics])
        xk = [packets.ring(self.seed, cfg.n_packets, w0, cfg.f, cfg.Cg,
                           cfg.L, self.device, dtype)
              for w0, _ in self.members]
        x0 = rnd(torch.stack([a[0] for a in xk]))
        k0 = rnd(torch.stack([a[1] for a in xk]))
        delay = cfg.packet_delay_days / cfg.f
        runs = []
        for smp in self.samples:
            qk, r1, r2, n, x, k = smp["in"]
            cd = qk0.dtype
            state = (rnd(qk.to(cd)), rnd(r1.to(cd)), rnd(r2.to(cd)), n)

            def step(st, s, rnd):
                q, a, b = R.step(st[0], st[1], st[2], st[3], dts, rnd)
                return (q, a, b, st[3] + 1)

            def sub_dt(s, n=n):
                h = np.where((n + s + 1) * dts > delay,
                             dts / cfg.n_substeps, 0.0)
                return torch.as_tensor(h, dtype=dtype, device=self.device)

            st, xe, ke, rows = flow_and_packets(
                step, R.velocity, state, rnd(x.to(dtype)), rnd(k.to(dtype)),
                self.steps, self.traffic["steps_per_save"], sub_dt,
                cfg.n_substeps, cfg.f, cfg.Cg, R.grid.dx, R.grid.dy,
                self.traffic["bins"], self.wmax, rnd=rnd)
            runs.append((st[0], xe, ke, rows))
        return (qk0, x0, k0, dts), runs
