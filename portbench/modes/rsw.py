"""RSW restart-frame raytracing: packets through one frozen nonlinear RSW
frame, as ray_trace_sw/raytrace_sw.m runs it with step_packet_xka.m.

Set-up: the initial state of run_swkU.m / wavespecic2d.m from the seed
(models/examples.wave_and_geostrophic_spectrum_ic: a wave bath plus
narrow-band geostrophic flow) advanced spinup_steps swk AB3 steps
(models/rsw.simulate_rsw), which stands in for the restart frame; the
packets' ring from the seed (models/frozen.ring_ics), wave action 1.

A unit is one call of `models.frozen.raytrace_rsw_restart`, looked up on
its module at every call (so that a span put in its place runs): the
frame decomposed into seven grids, then nsteps x-k-a steps, a frame every
save_every; then each frame's omega histogram row and the action's sum,
min and max, and one host read of the flag that every frame is finite,
the count of packets left non-finite, the rows and the action figures.
The next unit starts from the last frame. A sampled unit keeps its input
packets and its frames, and the reference marches the same steps from
that input through its own decomposition of the program's frame; the
start (the initial state and the packets from the seed), the frame
itself (against the reference's own float64 spin-up) and the program's
seven grids (models/frozen.rsw_restart_fields, against the reference's
decomposition of the same frame) are checked by themselves.
"""

import time

import torch
from torch.profiler import record_function

from swraytracing_torch.analysis.device_diag import (OmegaHistSpec,
                                                     omega_hist_counts)
from swraytracing_torch.models import examples, rsw
from swraytracing_torch.models import frozen as frozen_mod
from swraytracing_torch.models.dispersion import Dispersion
from swraytracing_torch.models.frozen import ring_ics
from swraytracing_torch.ops.grid import SpectralGrid

from .. import compare
from ..counts import xka as counts
from ..reference import exact, lowp, packets
from ..reference import rsw as ref
from .frozen import k_packet_rel


def a_rel(ap, ar):
    """Widest wave-action gap of one packet as a share of that packet's
    own action in the reference."""
    return float(((ap.to(ar.dtype) - ar).abs() / ar.abs()).max())


class Cell:
    kind = "forward"

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        c = config
        if c["order"] != 2:
            raise ValueError("the reference follows a stencil of order 2")
        self.grid = grid = SpectralGrid.square(c["nx"], c["L"])
        self.disp = Dispersion(f=c["f"], Cg=c["Cg"])
        self.params = rsw.RSWParams(f=c["f"], Cg=c["Cg"], **c["rsw_params"])
        (u, v, h), _ = examples.wave_and_geostrophic_spectrum_ic(
            grid, c["f"], c["Cg"], c["aw"], c["ag"], c["k_max_wave"],
            c["k_geo_lo"], c["k_geo_hi"], seed=seed)
        state = rsw.rsw_init(u, v, h, grid, self.params, device=self.device,
                             dtype=self.dtype)
        _, frames, _, _, _ = rsw.simulate_rsw(state, grid, self.params,
                                              c["spinup_steps"],
                                              c["spinup_steps"])
        self.frame = frames[-1]
        self.x, self.k = ring_ics(traffic["n_packets"], traffic["w0"],
                                  self.disp, c["L"], seed,
                                  device=self.device, dtype=self.dtype)
        self.a = torch.ones_like(self.x[0])
        ic = torch.stack([torch.as_tensor(s, device=self.device)
                          for s in (u, v, h)]).to(self.dtype)
        self.start = (ic, self.x, self.k)
        self.wmax = traffic["omega_max_factor"] * traffic["w0"] * c["f"]
        self.spec = OmegaHistSpec(n_bins=traffic["bins"],
                                  omega_max=self.wmax, f=c["f"], Cg=c["Cg"],
                                  omega_min=c["f"], log_bins=True)
        self.samples = []
        self.overflow = 0

    def warmup(self):
        # the cell measures raytrace_rsw_restart's kernel route: on the
        # card the warm-up has to take it, and a program whose entry has no
        # route counter has no such route
        routes = getattr(frozen_mod.raytrace_rsw_restart, "routes", None)
        if routes is None:
            raise RuntimeError("raytrace_rsw_restart has no kernel route")
        before = routes["kernel"]
        for _ in range(self.traffic["warmup_units"]):
            self.unit()
        if self.device.type == "cuda" and routes["kernel"] == before:
            raise RuntimeError("raytrace_rsw_restart did not take its "
                               "kernel route on the card")
        self.state_start = (self.x, self.k, self.a)

    def restart(self):
        self.x, self.k, self.a = self.state_start

    def unit(self, keep=False, saves=None):
        t, c = self.traffic, self.config
        x_in, k_in, a_in = self.x, self.k, self.a
        t0 = time.perf_counter()
        with record_function("bench.chunk"):
            xs, ks, as_, _ = frozen_mod.raytrace_rsw_restart(
                *self.frame, self.disp, self.grid, x_in, k_in, a_in,
                dt=c["dt"], nsteps=t["nsteps"], save_every=t["save_every"],
                device=self.device, dtype=self.dtype)
        enqueue_s = time.perf_counter() - t0
        with record_function("bench.diag"):
            rows = omega_hist_counts(ks, self.spec)
            action = torch.stack([as_.sum(-1), as_.amin(-1), as_.amax(-1)])
        with record_function("bench.host_read"):
            finite = (torch.isfinite(xs).all() & torch.isfinite(ks).all()
                      & torch.isfinite(as_).all())
            last = torch.cat([xs[-1], ks[-1], as_[-1][None]])
            bad = (~torch.isfinite(last)).any(0).sum()
            flags = torch.stack([finite.to(rows.dtype), bad.to(rows.dtype)])
            host = torch.cat([flags, rows.reshape(-1),
                              action.reshape(-1).to(rows.dtype)]).cpu()
        finite, bad = bool(host[0]), int(host[1])
        self.overflow = max(self.overflow, bad)
        self.x, self.k, self.a = xs[-1], ks[-1], as_[-1]
        if keep:
            self.samples.append({
                "in": (x_in, k_in, a_in), "out": (xs, ks, as_),
                "rows": host[2:2 + rows.numel()].reshape(rows.shape)})
        steps = t["nsteps"] // t["save_every"] * t["save_every"]
        return {"steps": steps, "work": steps * t["n_packets"],
                "enqueue_s": enqueue_s, "ok": finite and not bad}

    def march_bound_s_per_step(self):
        c, t = self.config, self.traffic
        return counts.bound_s_per_step(c["order"], c["nx"], c["nx"],
                                       t["n_packets"], t["save_every"],
                                       self.dtype.itemsize)

    def timings(self):
        return {}

    def release(self):
        self.x = self.k = self.a = self.state_start = None

    # -- the comparison -----------------------------------------------

    def reference(self, rnd=exact, dtype=torch.float64):
        """The reference's start, its spun-up frame, its seven grids of
        the program's frame and its march from each sample's input."""
        c, t = self.config, self.traffic
        S0 = ref.initial(self.seed, c, self.device, dtype, rnd)
        x0, k0 = map(rnd, packets.ring(self.seed, t["n_packets"], t["w0"],
                                       c["f"], c["Cg"], c["L"], self.device,
                                       dtype))
        frame = ref.SWK(c, self.device, dtype).spin_up(S0,
                                                       c["spinup_steps"], rnd)
        G = ref.seven_grids(c, rnd(self.frame.to(dtype)), rnd)
        runs = []
        for smp in self.samples:
            x, k, a = (rnd(s.to(dtype)) for s in smp["in"])
            runs.append(ref.march(G, x, k, a, c["dt"], t["nsteps"],
                                  t["save_every"], c["f"], c["Cg"],
                                  self.grid.dx, self.grid.dy, t["bins"],
                                  self.wmax, rnd=rnd))
        return (S0, x0, k0), frame, G, runs

    def numbers(self, prog, ref_):
        """The compared numbers of `prog` against `ref_`, each (start,
        frame, seven grids, runs)."""
        (S0, x0, k0), frame, G, runs = prog
        (rS0, rx0, rk0), rframe, rG, rruns = ref_
        c, n = self.config, self.traffic["n_packets"]
        dx = c["L"] / c["nx"]
        out = {"start_rel": max(compare.rel_l2(S0, rS0),
                                compare.periodic_start(x0, rx0, dx),
                                compare.k_max_rel(k0, rk0)),
               "snapshot_rel": compare.rel_l2(frame, rframe),
               "fields_rel": compare.rel_l2(G, rG)}
        gaps = {"x_max_cells": [], "k_max_rel": [], "k_packet_rel": [],
                "a_rel": [], "hist_moved": [], "hist_total": []}
        for (x, k, a, rows), (xr, kr, ar, rr) in zip(runs, rruns):
            gaps["x_max_cells"].append(compare.x_max_cells(x, xr, c["L"],
                                                           dx))
            gaps["k_max_rel"].append(compare.k_max_rel(k, kr))
            gaps["k_packet_rel"].append(k_packet_rel(k, kr))
            gaps["a_rel"].append(a_rel(a, ar))
            gaps["hist_moved"].append(compare.hist_moved(rows, rr, n))
            gaps["hist_total"].append(compare.hist_total(rows, n))
        out.update({key: max(v) for key, v in gaps.items()})
        return out

    def program(self):
        G = frozen_mod.rsw_restart_fields(*self.frame, self.grid,
                                          self.params)
        return (self.start, self.frame, G,
                [smp["out"] + (smp["rows"],) for smp in self.samples])

    def check(self):
        out = self.numbers(self.program(), self.reference())
        out["overflow"] = self.overflow
        return out

    def control(self):
        """The numbers with the reference in bfloat16 storage (float32
        arithmetic) put in the program's place."""
        return self.numbers(self.reference(lowp, torch.float32),
                            self.reference())
