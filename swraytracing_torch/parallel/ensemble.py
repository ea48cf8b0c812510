"""Parameter-sweep ensembles: every member of a sweep in one program.

Counterpart of swraytracing_tpu/parallel/ensemble.py. The reference runs
its 20-config (w0, U_g) sweep as independent SLURM tasks
(runqgsw_raytrace.sbatch:10, parameters.txt); the JAX package vmaps the
one-layer coupled model over a leading member axis. Here the member axis
is written out: every tensor of the carry has it first, the flow solver,
the field grids and the window builds run all members in one pass, and
each kernel of the fused packet march launches once per ensemble step for
all members (ops/march_window: march_gathered_batched,
transpose_batched, build_windows_batched).

Each member has its own dt, packet delay, T and U0 (EnsembleSetup, host
float64 arrays). Its `t` and `step` live on the host (numpy (E,) float64
and int64), so the live mask (t < T), the release gate (t > delay) and
each member's substep length are known without reading the device. The
per-member tensors a step needs (dt coefficients, substep lengths, the
live mask) are uploaded only when their values change — at a release, a
freeze or a resume (ops/grid.host_array_tensor) — so a step queues its
launches without a host-device synchronisation.

A member past its T freezes bit for bit, as in the JAX package: the step
runs with dt = 0 for it (qg_step would still apply the spectral filter and
roll the AB history and step count), and then its old state is selected
wholesale, apart from the carried window array, whose content a frozen
member never reads (its substep length is 0).

One MarchSpec, its margin the ensemble maximum of the members' own,
serves every member: the margin sizes the windows, not the arithmetic, so
a member marches as it would alone as long as no packet out-drifts the
window; the kernel counts overflow per member.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..models.coupled import (CoupledCarry, CoupledConfig, lockstep_step,
                              march_n_fields, prepare_carry_windows,
                              setup_coupled, window_threshold)
from ..models.fields import flow_from_qk
from ..models.qg import QGState, qg_step
from ..ops.grid import host_array_tensor, resolve_device

__all__ = ["EnsembleSetup", "setup_ensemble", "run_ensemble_chunk",
           "sweep_configs"]


@dataclasses.dataclass(frozen=True)
class EnsembleSetup:
    """Per-member parameters, host float64 arrays of shape (E,)."""

    dt: np.ndarray
    packet_delay: np.ndarray
    T: np.ndarray            # total simulation time of each member
    U0: np.ndarray           # setup-time maximum flow speed

    def replace(self, **changes) -> "EnsembleSetup":
        return dataclasses.replace(
            self, **{k: np.asarray(v, np.float64) for k, v in changes.items()})


def sweep_configs(base: CoupledConfig | None = None,
                  w0s=(2.0, 4.0, 8.0, 16.0),
                  ugs=(0.2, 0.4, 0.6, 0.8, 1.0)) -> list:
    """The reference's parameters.txt grid as CoupledConfigs."""
    base = base or CoupledConfig()
    return [base._replace(near_inertial_factor=w0, U_g=ug)
            for w0 in w0s for ug in ugs]


def _stack_carries(carries) -> CoupledCarry:
    """The members' single carries stacked on a leading member axis."""
    states = [c.flow_state for c in carries]
    state = QGState(
        qk=torch.stack([st.qk for st in states]),
        rhs_m1=torch.stack([st.rhs_m1 for st in states]),
        rhs_m2=torch.stack([st.rhs_m2 for st in states]),
        t=np.asarray([st.t for st in states], np.float64),
        step=np.asarray([st.step for st in states], np.int64))
    return CoupledCarry(
        flow_state=state,
        packet_x=torch.stack([c.packet_x for c in carries]),
        packet_k=torch.stack([c.packet_k for c in carries]),
        prev_fields=torch.stack([c.prev_fields for c in carries]))


def setup_ensemble(cfgs: Sequence[CoupledConfig], device=None,
                   dtype: torch.dtype = torch.float32):
    """Batched carry and per-member parameters from a config list.

    All members must share (nx, L, f, Cg, n_packets); the swept quantities
    (w0 -> packet ring radius, U_g -> PV amplitude and hence dt) vary per
    member. `device=None` means the CUDA device and raises when there is
    none; `device="cpu"` runs on the CPU.

    Returns (s, es, carry_b): `s` is member 0's CoupledSetup, its march
    spec (when the members' configuration engages the fused march) widened
    to the ensemble-maximum margin; es the EnsembleSetup; carry_b the
    members' carries stacked on a leading axis.
    """
    device = resolve_device(device)
    ref = cfgs[0]
    for c in cfgs:
        assert (c.nx, c.L, c.f, c.Cg, c.n_packets) == \
            (ref.nx, ref.L, ref.f, ref.Cg, ref.n_packets), \
            "ensemble members must share grid/packet shapes"
    setups, carries = zip(*(setup_coupled(c, device=device, dtype=dtype)
                            for c in cfgs))
    marches = [s.march for s in setups]
    if any(m is None for m in marches):
        # engagement is a pure function of the shared config fields
        # (n_packets, stepper, window_min_np), so it is all-or-nothing
        assert all(m is None for m in marches), \
            "march engagement must be uniform across ensemble members"
        march = None
    else:
        march = marches[0]._replace(margin=max(m.margin for m in marches))
    s = setups[0]._replace(march=march)
    es = EnsembleSetup(
        dt=np.asarray([st.dt for st in setups], np.float64),
        packet_delay=np.asarray([st.packet_delay for st in setups],
                                np.float64),
        T=np.asarray([st.T for st in setups], np.float64),
        U0=np.asarray([st.U0 for st in setups], np.float64))
    return s, es, _stack_carries(carries)


def _select_live(new: CoupledCarry, old: CoupledCarry,
                 live: np.ndarray) -> CoupledCarry:
    """The new carry for live members and the old one, bit for bit, for
    frozen ones; the window array is the new one for all (a frozen member's
    windows are never read)."""
    dev = new.packet_x.device
    mask = host_array_tensor(live, torch.bool, dev)

    def sel(a, b):
        return torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), a, b)

    fn, fo = new.flow_state, old.flow_state
    state = QGState(qk=sel(fn.qk, fo.qk), rhs_m1=sel(fn.rhs_m1, fo.rhs_m1),
                    rhs_m2=sel(fn.rhs_m2, fo.rhs_m2),
                    t=np.where(live, fn.t, fo.t),
                    step=np.where(live, fn.step, fo.step))
    overflow = new.overflow
    if overflow is not None and old.overflow is not None:
        overflow = sel(overflow, old.overflow)
    return CoupledCarry(flow_state=state,
                        packet_x=sel(new.packet_x, old.packet_x),
                        packet_k=sel(new.packet_k, old.packet_k),
                        prev_fields=sel(new.prev_fields, old.prev_fields),
                        prev_win=new.prev_win, overflow=overflow)


def run_ensemble_chunk(carry_b: CoupledCarry, es: EnsembleSetup, s, cfg,
                       n_saves: int, diag_fn=None):
    """Advance every member n_saves * packet_steps_per_save flow steps;
    members past their own T freeze. `s` is the shared CoupledSetup of
    setup_ensemble (its march spec the ensemble one); each member's dt,
    delay and T come from `es`.

    Returns (carry, (px (E, n_saves, 2, Np), pk (E, n_saves, 2, Np),
    t (E, n_saves) float64 on the host)). Nothing in the chunk
    synchronises with the device; `carry.overflow` ((E,) int32 on the
    fused march) is for the caller to read once the chunk is done.

    diag_fn: optional (carry, i) -> (E, ...) device diagnostic, given the
    members' carry and their indices i = arange(E) on the device (what the
    JAX package's vmapped diag_fn(c, i) gives stacked); each save then
    emits (diag (E, n_saves, ...), t) instead of the packet arrays.
    """
    grid, disp, qp = s.grid, s.disp, s.qg_params
    march = s.march
    nf = march_n_fields(march)
    threshold = window_threshold(cfg)
    dev = carry_b.packet_x.device
    members = torch.arange(carry_b.packet_x.shape[0], device=dev)
    carry = prepare_carry_windows(carry_b, False, march, threshold)

    def member_step(c):
        t = c.flow_state.t
        live = t < es.T
        live_dt = np.where(live, es.dt, 0.0)
        released = t + live_dt > es.packet_delay
        sub_dt = host_array_tensor(
            np.where(released, live_dt / cfg.n_substeps, 0.0), torch.float64,
            dev)
        new = lockstep_step(
            c, flow_step_fn=lambda st: qg_step(st, grid, qp, dt=live_dt),
            fields_fn=lambda st: flow_from_qk(st.qk, grid, qp.Kd2,
                                              n_fields=nf).fields,
            grid=grid, disp=disp, dt=None, packet_delay=None,
            n_substeps=cfg.n_substeps, stepper=cfg.stepper, march=march,
            window_min_np=threshold, sub_dt=sub_dt)
        return new if live.all() else _select_live(new, c, live)

    saves, ts = [], []
    for _ in range(n_saves):
        for _ in range(cfg.packet_steps_per_save):
            carry = member_step(carry)
        ts.append(carry.flow_state.t.copy())
        if diag_fn is not None:
            saves.append((diag_fn(carry, members),))
        else:
            saves.append((carry.packet_x, carry.packet_k))
    stacked = tuple(torch.stack(col, dim=1) for col in zip(*saves))
    return carry, (*stacked, torch.as_tensor(np.stack(ts, axis=1)))
