"""The chunk loop's graph route: a save interval's lock-steps captured once
as one CUDA graph and replayed once a save (models/coupled.run_lockstep_chunk).

A lock-step is about 90 device launches made from Python, and on the card
the host takes longer to enqueue them than the card takes to run them
(1.5-1.6 ms of host against 1.03 ms of device a step at 512^2 with 2^20
packets). Once the AB3 bootstrap is over (flow step 2 on) and the packets
are released, every step launches the same sequence on tensors of the same
shapes with the same scalar arguments: `t` and `step` live on the host,
the substep length is one constant, and nothing synchronises. That
sequence, steps_per_save steps of it, is captured once (torch.cuda.graph)
and replayed, so the host enqueues one graph a save. The graph is the eager
step captured: the same hand-written kernels and the same cuFFT and
elementwise calls in the same order, so every number is the eager loop's,
bit for bit.

The rule, `refusals`: a chunk takes the graph route where its carry lies on
a CUDA device and is a single run's, the fused march is engaged, remat is
off, autograd would record nothing (grad mode off, or no tensor of the
carry requires grad), the step function is a `ModelStep` (which shows its
setup), there are steps to run, the flow is past its bootstrap (step >= 2)
and the chunk's first step is released (t + dt > packet_delay), so that
every step of it marches by dt / n_substeps. Any other chunk runs the eager
loop.

A graph is kept by what decides its launches: the model's step function,
its setup (held, and matched by identity) and configuration, the carry's
shapes and dtypes, steps_per_save, the substep length and the device. One
is kept: a chunk with another key frees it, with its memory pool, and
captures its own. A CFL recheck or a remargin makes a new setup and does
not go back to the old one.

Memory. A graph reads its carry from input buffers and leaves the new
carry in its own memory pool. A chunk copies its carry into the input
buffers, copies the graph's carry back into them between its replays,
and returns fresh copies of the carry and of each save, so no later replay
overwrites what a caller keeps; it never modifies its input.

Counters. The kernel wrappers' launch counters (ops/march_window) count
the launches that run when they are made: those of the one lock-step run
before a capture, to make lazily made state (the operators' device
copies, cuFFT plans) outside it, whose result is thrown away. A call
inside the capture records its launch into the graph and is not counted,
and a replay calls no wrapper; a profiler sees a replay's kernels
(chip_smoke.py's graph_path counts them). So does the window build's
route counter (ops/march_window.build_gather_windows.routes): a capture's
builds count, a replay's do not. ROUTES counts the chunk loop's steps by
route and the captures (run_lockstep_chunk.routes). The port's
spans inside the step (swr.step, swr.flow, swr.fields, swr.windows,
swr.march) run in the capture's pass only, not at a replay; each replay
runs inside the span swr.graph (utils/profiling.span).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.profiling import span

__all__ = ["ModelStep", "refusals", "run_chunk", "ROUTES"]

# Steps of the chunk loop by route, and graphs captured. Kept here, and
# read as run_lockstep_chunk.routes.
ROUTES = {"graph": 0, "eager": 0, "captures": 0}

# The flow state's host scalars, which a step advances by dt and by 1.
_T = ("flow_state", "t")
_STEP = ("flow_state", "step")

# The graph kept, {key: _Graph}: one at most.
_CACHE: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class ModelStep:
    """A model's lock-step as the chunk loop calls it, carry -> carry:
    fn(carry, s, cfg). Unlike a closure it shows the chunk loop the setup
    and configuration that decide its launches."""

    fn: object
    s: object
    cfg: object

    def __call__(self, carry):
        return self.fn(carry, self.s, self.cfg)


def _leaves(obj, path=()):
    """(path, value) of each leaf of a carry, its dataclasses walked field
    by field: its tensors and its host values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), path + (f.name,))
    else:
        yield path, obj


def _rebuild(obj, values, path=()):
    """`obj` with the leaves named in `values` {path: value} replaced."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), values, path + (f.name,))
            for f in dataclasses.fields(obj)})
    return values.get(path, obj)


def refusals(carry, step_fn, march, remat: bool, n_steps: int) -> list:
    """Why a chunk of n_steps lock-steps takes the eager loop: the name of
    each condition of the graph route that fails, empty where the route
    engages (module docstring)."""
    x = carry.packet_x
    out = []
    if not x.is_cuda:
        out.append("not_cuda")
    if x.dim() != 2:
        out.append("ensemble")
    if march is None:
        out.append("no_march")
    if remat:
        out.append("remat")
    if torch.is_grad_enabled() and any(
            isinstance(v, torch.Tensor) and v.requires_grad
            for _, v in _leaves(carry)):
        out.append("grad")
    if n_steps <= 0:
        out.append("no_steps")
    if not isinstance(step_fn, ModelStep):
        out.append("step_fn")
    elif x.dim() == 2:
        st = carry.flow_state
        if np.ndim(st.step) or st.step < 2:
            out.append("bootstrap")
        if not st.t + step_fn.s.dt > step_fn.s.packet_delay:
            out.append("unreleased")
    return out


def _advance(host: dict, n: int, dt) -> dict:
    """The host leaves after n steps: t advanced by dt n times, as each
    step adds it, and step by n."""
    out = dict(host)
    t = out[_T]
    for _ in range(n):
        t = t + dt
    out[_T], out[_STEP] = t, out[_STEP] + n
    return out


def _same(a, b) -> bool:
    return a is b or (type(a) is type(b) and bool(a == b))


def _apart(out: dict, inputs: dict) -> dict:
    """The leaves `out` {path: value} of the carry that a capture's steps
    made, each tensor that shares memory with an input buffer other than
    its own leaf's cloned (inside the capture), so that copying them into
    the input buffers reads nothing that the copy has written."""
    for p, buf in inputs.items():
        v = out.get(p)
        if not (isinstance(v, torch.Tensor) and v.shape == buf.shape
                and v.dtype == buf.dtype):
            raise RuntimeError(
                f"the graph route needs a step that keeps the carry's "
                f"tensors: {'.'.join(p)} came back as "
                f"{getattr(v, 'shape', v)}")
    mine = {b.untyped_storage().data_ptr() for b in inputs.values()}
    return {p: v.clone() if isinstance(v, torch.Tensor)
            and v is not inputs.get(p)
            and v.untyped_storage().data_ptr() in mine else v
            for p, v in out.items()}


def _shares(t, bufs) -> bool:
    return isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() in {
        b.untyped_storage().data_ptr() for b in bufs}


class _Graph:
    """One captured save interval: its input buffers, the graph, and the
    carry it leaves in its memory pool."""

    def __init__(self, step_fn: ModelStep, carry, n: int):
        self.s = step_fn.s          # held: the cache key's id(s) stays its own
        self.n, self.dt = n, step_fn.s.dt
        leaves = dict(_leaves(carry))
        self.inputs = {p: v.clone() for p, v in leaves.items()
                       if isinstance(v, torch.Tensor)}
        host = {p: v for p, v in leaves.items() if p not in self.inputs}
        c_in = _rebuild(carry, self.inputs)
        dev = carry.packet_x.device
        with torch.no_grad(), torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                step_fn(c_in)       # warm-up, thrown away
            cur.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                c = c_in
                for _ in range(n):
                    c = step_fn(c)
                out = _apart(dict(_leaves(c)), self.inputs)
        self.outputs = {p: out[p] for p in self.inputs}
        host_out = {p: v for p, v in out.items() if p not in self.inputs}
        want = _advance(host, n, self.dt)
        if set(host_out) != set(want) or not all(
                _same(host_out[p], want[p]) for p in want):
            raise RuntimeError(
                "the graph route replays a step whose host values (the flow "
                "state's t and step) advance by the setup's dt and by 1, and "
                f"leave the rest as they are: {n} steps from {host} gave "
                f"{host_out}, not {want}")
        ROUTES["captures"] += 1

    def run(self, carry, n_saves: int, diag_fn):
        """n_saves replays from `carry`: (the new carry, the saves, the
        save times), as run_lockstep_chunk's eager loop gives them."""
        leaves = dict(_leaves(carry))
        for p, buf in self.inputs.items():
            buf.copy_(leaves[p])
        host = {p: v for p, v in leaves.items() if p not in self.inputs}
        saves, ts = [], []
        for i in range(n_saves):
            if i:
                for p, buf in self.inputs.items():
                    if self.outputs[p] is not buf:
                        buf.copy_(self.outputs[p])
            with span("swr.graph"):
                self.graph.replay()
            ROUTES["graph"] += self.n
            host = _advance(host, self.n, self.dt)
            last = i == n_saves - 1
            values = {p: v.clone() if last else v
                      for p, v in self.outputs.items()}
            c = _rebuild(carry, {**values, **host})
            ts.append(c.flow_state.t)
            if diag_fn is not None:
                d = diag_fn(c)
                kept = (*self.inputs.values(), *self.outputs.values())
                saves.append((d.clone() if _shares(d, kept) else d,))
            elif last:
                saves.append((c.packet_x, c.packet_k))
            else:
                saves.append((c.packet_x.clone(), c.packet_k.clone()))
        return c, saves, ts


def run_chunk(carry, step_fn: ModelStep, steps_per_save: int, n_saves: int,
              diag_fn=None):
    """A chunk by the graph route, on a carry `refusals` passes and whose
    windows and overflow counter prepare_carry_windows has set: (the new
    carry, the saves, the save times). Captures the save interval where the
    kept graph does not fit, and frees that one."""
    leaves = _leaves(carry)
    s = step_fn.s
    key = (step_fn.fn, id(s), step_fn.cfg, steps_per_save,
           s.dt / step_fn.cfg.n_substeps, carry.packet_x.device,
           tuple((p, tuple(v.shape), v.dtype) for p, v in leaves
                 if isinstance(v, torch.Tensor)))
    g = _CACHE.get(key)
    if g is None:
        if _CACHE:
            torch.cuda.synchronize()    # its last replay may still run
            _CACHE.clear()
        g = _CACHE[key] = _Graph(step_fn, carry, steps_per_save)
    return g.run(carry, n_saves, diag_fn)
