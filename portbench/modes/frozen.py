"""Frozen-snapshot raytracing: packets through one frozen one-layer QG PV
frame, as SW_zero_background_raytracing.m and symplectic_full_fourier.m
run it.

Set-up: the ring IC from the seed (models/qg.initial_q_ring, normalised
to U_g) advanced spinup_steps AB3 steps at its CFL time step
(models/qg.qg_step), then frozen: its six grids u, v, u_x, u_y, v_x, v_y
(models/fields.flow_from_qk), and the packets' ring from the seed
(models/frozen.ring_ics).

A unit is one call of `models.frozen.raytrace_frozen`: nsteps symplectic
steps, a frame every save_every, each frame's omega and Omega_abs; then
each frame's omega histogram row and its largest |dOmega_abs /
Omega_abs(0)| (the script's check), and one host read of the flag that
every frame is finite, the count of packets left non-finite, the rows and
those largest changes (infinite where a packet's Omega_abs(0) rounds to
zero, as the script's would be: not a failure).
The next unit starts from the last frame. A sampled unit keeps its input
packets, its frames and their Omega_abs, and the reference marches the
same steps from that input through its own inversion of the program's
frozen PV; the start (the IC and the packets from the seed) and the
frozen PV itself (against the reference's own float64 spin-up) are
checked by themselves. The conservation check is compared with
|Omega_abs(0)| held at least omega(k(0)) from zero (reference/frozen's
conservation_error): with U_g = 1 the Doppler shift U . k reaches omega,
and the script's ratio is ill-conditioned where it does; it is infinite
where a float32 Omega_abs(0) rounds to zero.
"""

import time

import torch
from torch.profiler import record_function

from swraytracing_torch.analysis.device_diag import (OmegaHistSpec,
                                                     omega_hist_counts)
from swraytracing_torch.models.dispersion import Dispersion
from swraytracing_torch.models.fields import flow_from_qk
from swraytracing_torch.models.frozen import raytrace_frozen, ring_ics
from swraytracing_torch.models.qg import (QGParams, inertial_ring_forcing,
                                          initial_q_ring, max_speed,
                                          qg_init, qg_step)
from swraytracing_torch.ops import spectral as sp
from swraytracing_torch.ops.grid import SpectralGrid

from .. import compare
from ..counts import rays as counts
from ..reference import exact, lowp, packets
from ..reference import frozen as ref
from ..reference.qg import QG


def k_packet_rel(kp, kr):
    """Widest wavevector gap of one packet as a share of that packet's
    own |k| in the reference: a packet's wavevector grows by orders of
    magnitude where the frozen strain captures it, so a gap over the
    packets' rms |k| (k_max_rel) can hide a wrong packet of ordinary
    |k|."""
    d = torch.linalg.vector_norm(kp.to(kr.dtype) - kr, dim=-2)
    return float((d / torch.linalg.vector_norm(kr, dim=-2)).max())


class Cell:
    kind = "forward"

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        c = config
        if c["stepper"] != "symplectic" or c["order"] != 2:
            raise ValueError("the reference follows the symplectic stepper "
                             "through a stencil of order 2")
        grid = SpectralGrid.square(c["nx"], c["L"])
        self.disp = Dispersion(f=c["f"], Cg=c["Cg"])
        qk0 = initial_q_ring(seed, grid, c["U_g"], c["Kd2"],
                             device=self.device, dtype=self.dtype)
        qp = QGParams(Kd2=c["Kd2"], beta=c["beta"], r_drag=c["r_drag"],
                      dt=c["CFL_fraction"] * grid.dx / float(
                          max_speed(qk0, grid, c["Kd2"])),
                      forcing=inertial_ring_forcing(
                          c["forcing_strength"], grid, c["f"], c["Cg"]),
                      filter=sp.exp_filter(grid))
        state = qg_init(qk0)
        for _ in range(c["spinup_steps"]):
            state = qg_step(state, grid, qp)
        self.qk = state.qk
        self.flow = flow_from_qk(self.qk, grid, c["Kd2"], order=c["order"])
        self.x, self.k = ring_ics(traffic["n_packets"], traffic["w0"],
                                  self.disp, c["L"], seed,
                                  device=self.device, dtype=self.dtype)
        self.start = (qk0, self.x, self.k)
        self.wmax = traffic["omega_max_factor"] * traffic["w0"] * c["f"]
        self.spec = OmegaHistSpec(n_bins=traffic["bins"],
                                  omega_max=self.wmax, f=c["f"], Cg=c["Cg"],
                                  omega_min=c["f"], log_bins=True)
        self.samples = []
        self.overflow = 0

    def warmup(self):
        # the cell measures raytrace_frozen's kernel route (K4): on the
        # card the warm-up has to take it, and a program whose entry has
        # no route counter has no such route
        routes = getattr(raytrace_frozen, "routes", None)
        if routes is None:
            raise RuntimeError("raytrace_frozen has no kernel route")
        before = routes["kernel"]
        for _ in range(self.traffic["warmup_units"]):
            self.unit()
        if self.device.type == "cuda" and routes["kernel"] == before:
            raise RuntimeError("raytrace_frozen did not take its kernel "
                               "route on the card")
        self.x_start, self.k_start = self.x, self.k

    def restart(self):
        self.x, self.k = self.x_start, self.k_start

    def unit(self, keep=False, saves=None):
        t, c = self.traffic, self.config
        x_in, k_in = self.x, self.k
        t0 = time.perf_counter()
        with record_function("bench.chunk"):
            res = raytrace_frozen(self.flow, x_in, k_in, self.disp, c["dt"],
                                  t["nsteps"], t["save_every"], c["stepper"])
        enqueue_s = time.perf_counter() - t0
        with record_function("bench.diag"):
            rows = omega_hist_counts(res.k, self.spec)
            cons = res.conservation_error
        with record_function("bench.host_read"):
            finite = torch.isfinite(res.x).all() & torch.isfinite(res.k).all()
            bad = (~torch.isfinite(torch.cat([res.x[-1], res.k[-1]]))
                   ).any(0).sum()
            flags = torch.stack([finite.to(rows.dtype), bad.to(rows.dtype)])
            host = torch.cat([flags, rows.reshape(-1),
                              cons.to(rows.dtype)]).cpu()
        finite, bad = bool(host[0]), int(host[1])
        self.overflow = max(self.overflow, bad)
        self.x, self.k = res.x[-1], res.k[-1]
        if keep:
            self.samples.append({
                "in": (x_in, k_in), "out": (res.x, res.k),
                "rows": host[2:2 + rows.numel()].reshape(rows.shape),
                "omega_abs": (res.omega_abs, res.omega_abs0)})
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
        self.x = self.k = self.x_start = self.k_start = None

    # -- the comparison -----------------------------------------------

    def reference(self, rnd=exact, dtype=torch.float64):
        """The reference's start, its spun-up PV, its six grids of the
        program's frozen PV and its march from each sample's input."""
        c, t = self.config, self.traffic
        R = QG(c, self.device, dtype)
        q0, _, flow_dt = R.initial(self.seed, c["U_g"], rnd)
        x0, k0 = map(rnd, packets.ring(self.seed, t["n_packets"], t["w0"],
                                       c["f"], c["Cg"], c["L"], self.device,
                                       dtype))
        qk = ref.spin_up(R, q0, flow_dt, c["spinup_steps"], rnd)
        G = ref.six_grids(R, rnd(self.qk.to(q0.dtype)), rnd)
        runs = []
        for smp in self.samples:
            x, k = (rnd(a.to(dtype)) for a in smp["in"])
            runs.append(ref.march(G, x, k, c["dt"], t["nsteps"],
                                  t["save_every"], c["f"], c["Cg"],
                                  R.grid.dx, R.grid.dy, t["bins"],
                                  self.wmax, rnd=rnd))
        return (q0, x0, k0), qk, G, runs

    def numbers(self, prog, ref_):
        """The compared numbers of `prog` against `ref_`, each (start,
        frozen PV, six grids, runs)."""
        (q0, x0, k0), qk, G, runs = prog
        (rq0, rx0, rk0), rqk, rG, rruns = ref_
        c, n = self.config, self.traffic["n_packets"]
        dx = c["L"] / c["nx"]
        out = {"start_rel": max(compare.rel_l2(q0[None], rq0[None]),
                                compare.periodic_start(x0, rx0, dx),
                                compare.k_max_rel(k0, rk0)),
               "snapshot_rel": compare.rel_l2(qk[None], rqk[None]),
               "fields_rel": compare.rel_l2(G, rG)}
        gaps = {"x_max_cells": [], "k_max_rel": [], "k_packet_rel": [],
                "hist_moved": [], "hist_total": [], "cons_gap": []}
        for (x, k, rows, cons), (xr, kr, rr, cr) in zip(runs, rruns):
            gaps["x_max_cells"].append(compare.x_max_cells(x, xr, c["L"],
                                                           dx))
            gaps["k_max_rel"].append(compare.k_max_rel(k, kr))
            gaps["k_packet_rel"].append(k_packet_rel(k, kr))
            gaps["hist_moved"].append(compare.hist_moved(rows, rr, n))
            gaps["hist_total"].append(compare.hist_total(rows, n))
            gaps["cons_gap"].append(float(
                (cons.double().cpu() - cr.double().cpu()).abs().max()))
        out.update({key: max(v) for key, v in gaps.items()})
        return out

    def program(self):
        c = self.config
        return (self.start, self.qk, self.flow.fields,
                [smp["out"] + (smp["rows"], ref.conservation_error(
                    *smp["omega_abs"], ref.omega(smp["in"][1], c["f"],
                                                 c["Cg"])))
                 for smp in self.samples])

    def check(self):
        out = self.numbers(self.program(), self.reference())
        out["overflow"] = self.overflow
        return out

    def control(self):
        """The numbers with the reference in bfloat16 storage (float32
        arithmetic) put in the program's place."""
        return self.numbers(self.reference(lowp, torch.float32),
                            self.reference())
