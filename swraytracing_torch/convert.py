"""Carry state and operators across the package boundary as plain numpy.

A run of the JAX package (swraytracing_tpu) can hand its state to this
package, and the reverse, without either package seeing the other's
objects: the carrier is a dict of numpy arrays with the carry's field
names,

    {"flow_state": {"qk", "rhs_m1", "rhs_m2", "t", "step"},
     "packet_x", "packet_k", "prev_fields", "prev_win", "overflow"}

where "prev_win" and "overflow" may be None (or absent). The flow state is
the one-layer solver's when "qk" has rank 2 (nx, nky) and the two-layer
solver's when it has rank 3 (2, nx, nky), unless "t" is a 1-d array: then
it is an ensemble's one-layer state, (E, nx, nky) spectra and the members'
times and step counts (parallel/ensemble.py), and `ensemble_from_numpy`
turns the JAX package's EnsembleSetup fields and batched carry into the
port's.

An RSW solver's state (models/rsw.py) crosses as
{"Sk", "rhs_m1", "rhs_m2", "t", "dt", "step", "blown"}
(`rsw_state_from_numpy`, `rsw_state_to_numpy`), so a JAX run of the RSW
solver can be continued here, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.grid import complex_dtype, resolve_device
from .models.coupled import CoupledCarry
from .models.qg import QGParams, QGState
from .models.qg2 import QG2Operators, QG2State
from .models.rsw import RSWState

__all__ = ["carry_from_numpy", "carry_to_numpy", "operators_from_numpy",
           "qg_params_from_numpy", "ensemble_from_numpy",
           "rsw_state_from_numpy", "rsw_state_to_numpy"]


def carry_from_numpy(tree: dict, device=None,
                     dtype: torch.dtype = torch.float32) -> CoupledCarry:
    """Build a CoupledCarry from a dict of numpy arrays: a QGState when
    `qk` has rank 2, a QG2State when it has rank 3. Real arrays become
    `dtype`, spectra its complex counterpart, on `device` (None = the CUDA
    device; raises when there is none). `t` and `step` become host
    scalars. Every array is copied: the carry never aliases the caller's
    numpy memory."""
    device = resolve_device(device)
    cd = complex_dtype(dtype)

    def real(a):
        return None if a is None else torch.tensor(
            np.asarray(a), dtype=dtype, device=device)

    def spec(a):
        return torch.tensor(np.asarray(a), dtype=cd, device=device)

    fs = tree["flow_state"]
    rank = np.ndim(fs["qk"])
    if np.ndim(fs["t"]) == 1:    # an ensemble's members
        if rank != 3:
            raise ValueError("an ensemble's flow_state['qk'] must be "
                             f"(E, nx, nky); got rank {rank}")
        state = QGState(qk=spec(fs["qk"]), rhs_m1=spec(fs["rhs_m1"]),
                        rhs_m2=spec(fs["rhs_m2"]),
                        t=np.array(fs["t"], dtype=np.float64),
                        step=np.array(fs["step"], dtype=np.int64))
    else:
        if rank not in (2, 3):
            raise ValueError("flow_state['qk'] must be (nx, nky) or "
                             f"(2, nx, nky); got rank {rank}")
        State = QGState if rank == 2 else QG2State
        state = State(qk=spec(fs["qk"]), rhs_m1=spec(fs["rhs_m1"]),
                      rhs_m2=spec(fs["rhs_m2"]), t=float(fs["t"]),
                      step=int(fs["step"]))
    ov = tree.get("overflow")
    if ov is not None:
        ov = torch.tensor(np.asarray(ov), dtype=torch.int32, device=device)
    return CoupledCarry(flow_state=state, packet_x=real(tree["packet_x"]),
                        packet_k=real(tree["packet_k"]),
                        prev_fields=real(tree["prev_fields"]),
                        prev_win=real(tree.get("prev_win")), overflow=ov)


def carry_to_numpy(carry: CoupledCarry) -> dict:
    """The inverse of carry_from_numpy: copies every tensor to the host
    (one synchronisation) and returns the dict of numpy arrays."""

    def arr(t):
        return None if t is None else t.detach().cpu().numpy()

    fs = carry.flow_state
    members = isinstance(fs.t, np.ndarray)
    return {
        "flow_state": {"qk": arr(fs.qk), "rhs_m1": arr(fs.rhs_m1),
                       "rhs_m2": arr(fs.rhs_m2),
                       "t": (np.array(fs.t, np.float64) if members
                             else np.float64(fs.t)),
                       "step": (np.array(fs.step, np.int32) if members
                                else np.int32(fs.step))},
        "packet_x": arr(carry.packet_x),
        "packet_k": arr(carry.packet_k),
        "prev_fields": arr(carry.prev_fields),
        "prev_win": arr(carry.prev_win),
        "overflow": arr(carry.overflow),
    }


def operators_from_numpy(B, expLdt, expL2dt, dt) -> QG2Operators:
    """QG2Operators from host-built arrays (for example the JAX package's
    `build_operators` output), kept in float64 / complex128 on the host;
    the stepping functions take their device view from it."""
    return QG2Operators(B=np.asarray(B, dtype=np.float64),
                        expLdt=np.asarray(expLdt, dtype=np.complex128),
                        expL2dt=np.asarray(expL2dt, dtype=np.complex128),
                        dt=float(dt))


def qg_params_from_numpy(Kd2, dt, forcing=None, filter=None, *, beta=0.0,
                         r_drag=0.1, dealias=False,
                         reference_quirks=False) -> QGParams:
    """QGParams from host arrays (for example the forcing and filter of a
    JAX run's `CoupledSetup.qg_params`), kept in float64 on the host; the
    stepping functions take their device view from it."""
    def host(a):
        return None if a is None else np.array(a, dtype=np.float64)

    return QGParams(Kd2=float(Kd2), beta=float(beta), r_drag=float(r_drag),
                    dt=float(dt), forcing=host(forcing), filter=host(filter),
                    dealias=bool(dealias),
                    reference_quirks=bool(reference_quirks))


def ensemble_from_numpy(es: dict, tree: dict, device=None,
                        dtype: torch.dtype = torch.float32):
    """The port's (EnsembleSetup, batched carry) from numpy: `es` holds the
    JAX package's EnsembleSetup fields ("dt", "packet_delay", "T", "U0",
    each (E,)), `tree` the batched carry as carry_from_numpy takes it
    (t and step (E,)). The parameters stay float64 on the host."""
    from .parallel.ensemble import EnsembleSetup

    setup = EnsembleSetup(**{key: np.array(es[key], dtype=np.float64)
                             for key in ("dt", "packet_delay", "T", "U0")})
    return setup, carry_from_numpy(tree, device=device, dtype=dtype)


def rsw_state_from_numpy(tree: dict, device=None,
                         dtype: torch.dtype = torch.float32) -> RSWState:
    """An RSWState from a dict of numpy arrays (for example a JAX
    RSWState's fields): the spectra become `dtype`'s complex type, `dt`
    `dtype`, `t` a float64 and `blown` a bool 0-dim tensor, all on
    `device` (None = the CUDA device; raises when there is none); `step`
    a host int. Every array is copied."""
    device = resolve_device(device)
    cd = complex_dtype(dtype)

    def spec(a):
        return torch.tensor(np.asarray(a), dtype=cd, device=device)

    return RSWState(Sk=spec(tree["Sk"]), rhs_m1=spec(tree["rhs_m1"]),
                    rhs_m2=spec(tree["rhs_m2"]),
                    t=torch.tensor(float(tree["t"]), dtype=torch.float64,
                                   device=device),
                    dt=torch.tensor(float(tree["dt"]), dtype=dtype,
                                    device=device),
                    step=int(tree["step"]),
                    blown=torch.tensor(bool(tree["blown"]), device=device))


def rsw_state_to_numpy(state: RSWState) -> dict:
    """The inverse of rsw_state_from_numpy: every tensor to the host (`t`
    float64, `step` int32, `blown` bool, as numpy scalars or arrays)."""
    def arr(t):
        return t.detach().cpu().numpy()

    return {"Sk": arr(state.Sk), "rhs_m1": arr(state.rhs_m1),
            "rhs_m2": arr(state.rhs_m2), "t": arr(state.t),
            "dt": arr(state.dt), "step": np.int32(state.step),
            "blown": arr(state.blown)}
