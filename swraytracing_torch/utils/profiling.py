"""Profiling helpers: device timelines and timing that waits for the card.

Counterpart of swraytracing_tpu/utils/profiling.py. The reference's only
instrumentation is tic/toc wall-clock lines in its run logs
(qgsw_raytrace.m:114,178-179). Here:
  * `trace(log_dir)`: a torch.profiler context over the host and, where
    there is one, the CUDA device, with the port's spans on; it writes a
    Chrome trace into log_dir (chrome://tracing, Perfetto) and hands the
    profile to the caller for its key_averages();
  * `span(name)`: the port's layer spans. The lock-step and the march
    mark their layers with it (below); it does nothing while spans are
    off, which they are unless a `spans()` or `trace()` block is open;
  * `spans()`: spans on for the block, with a table of each span's calls
    and inclusive host nanoseconds, read without the profiler (a span then
    costs about a microsecond: two clock reads and the table's update);
  * `Timer`, `time_callable`: wall-clock timing that synchronises the
    CUDA device the work ran on before it reads the clock. PyTorch returns
    from a launch before the card has run it, so a clock read without the
    synchronisation times the host's enqueue.

The spans, a layer each, at its boundary in the code:

  swr.step           one lock-step (models/coupled.lockstep_step), every
                     caller: the chunk loop, an ensemble's member step and
                     the recomputation of a rematerialised step in the
                     backward
  swr.flow           the flow solver's step inside it (QG or two-layer QG)
  swr.fields         the velocity grids from the new PV
  swr.windows        one window build (ops/march_window.build_gather_windows:
                     the padded fields' copies and K2 or K3)
  swr.march          the fused march after the window builds: packet_cells,
                     K1, the overflow max
  swr.march.backward K1's backward, its kernel or autograd through the
                     plain march, on autograd's thread; under remat it starts after the
                     step's recomputation (inside swr.step again), which
                     reading the march's saved tensors sets off
  swr.frozen         one models/frozen.raytrace_frozen call, either route
  swr.frozen.march   each ops/march_rays.march_rays call of its kernel
                     route: the node-major copy, the orderings and K4
  swr.frozen.diag    the initial Omega_abs and each frame's omega and
                     Omega_abs
  swr.rays.order     each ordering by cell (cell_order_cuda) in
                     ops/march_rays.march_rays_cuda, whoever calls it
  swr.graph          each replay of a save interval's captured lock-steps
                     (models/step_graph.py, the chunk loop's graph route)

The per-stage path (no fused march) has swr.step, swr.flow and swr.fields
only. On the chunk loop's graph route a replay runs no Python of the step:
swr.step, swr.flow, swr.fields, swr.windows and swr.march run in the pass
that captures the graph only, and each replay is one swr.graph. To see the layers of a real run, profile a chunk of it:

    with profiling.trace("prof"):
        carry, rows = run_coupled2_chunk(carry, s, cfg, 4)

and open prof/trace.json (chrome://tracing, Perfetto): each span holds
the aten operations and kernels its layer launched. The profiler about
doubles the host's time a step, so for host times read the table instead:

    with profiling.spans() as table:
        carry, rows = run_coupled2_chunk(carry, s, cfg, 4)
    table["swr.flow"]     # {"calls": 100, "ns": ...}, host time inclusive
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from pathlib import Path

import torch

__all__ = ["span", "spans", "trace", "Timer", "time_callable"]

# Whether span() records, and the table it adds to (None outside spans()).
_on = False
_table: dict | None = None
_table_lock = threading.Lock()   # autograd's thread records backward spans


_OFF = contextlib.nullcontext()   # what span() returns while spans are off


def _add(table: dict, name: str, calls: int, ns: int) -> None:
    row = table.setdefault(name, {"calls": 0, "ns": 0})
    row["calls"] += calls
    row["ns"] += ns


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # a record_function costs ~10 us even with no profiler to see it
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        with _table_lock:
            if _table is not None:
                _add(_table, self.name, 1, ns)
        return False


def span(name: str):
    """A context for one layer's work. While spans are off (the default),
    the one shared context that does nothing. While they are on, it adds a
    call and its host nanoseconds to the open spans() table, and while a
    profiler runs it is a torch.profiler.record_function(name) too, on the
    profiler's clock with the device's kernels."""
    if not _on:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def _spans_on():
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


@contextlib.contextmanager
def spans():
    """Spans on for the block. Yields a fresh table {name: {"calls",
    "ns"}} of the spans that end inside it; on exit the previous state
    comes back, and an enclosing spans() table gets this block's rows."""
    global _table
    with _table_lock:
        outer, table = _table, {}
        _table = table
    try:
        with _spans_on():
            yield table
    finally:
        with _table_lock:
            _table = outer
            if outer is not None:
                for name, row in table.items():
                    _add(outer, name, row["calls"], row["ns"])


@contextlib.contextmanager
def trace(log_dir, name: str = "trace"):
    """Profile the block, with the port's spans on: host operations, and
    CUDA kernels, copies and memsets when CUDA is available. On exit the
    trace is written to log_dir/<name>.json. Yields the
    torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    with prof, _spans_on():
        yield prof
    prof.export_chrome_trace(str(log_dir / f"{name}.json"))


def _cuda_devices(out, found=None) -> set:
    """The CUDA devices of the tensors in `out` (tensors, and tuples,
    lists, dicts and dataclasses of them)."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for item in out:
            _cuda_devices(item, found)
    elif isinstance(out, dict):
        for item in out.values():
            _cuda_devices(item, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)
    return found


def _sync(out):
    """Wait until the CUDA devices of `out`'s tensors have finished their
    queued work; nothing for host tensors."""
    for device in _cuda_devices(out):
        torch.cuda.synchronize(device)
    return out


class Timer:
    """Wall-clock seconds of a block (`elapsed`). With `device` a CUDA
    device, the block's queued work on it is waited for on entry and on
    exit, so `elapsed` covers the card's time too."""

    def __init__(self, device=None):
        device = None if device is None else torch.device(device)
        self.device = device if device is not None and \
            device.type == "cuda" else None
        self.elapsed = 0.0

    def __enter__(self):
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        self.elapsed = time.perf_counter() - self._t0
        return False


def time_callable(fn, *args, warmup: int = 1, iters: int = 3):
    """Mean seconds of fn(*args) over `iters` calls after `warmup` calls,
    each call waited for on the CUDA devices of the tensors it returns;
    returns (mean_seconds, last_output)."""
    out = None
    for _ in range(warmup):
        out = _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = _sync(fn(*args))
    return (time.perf_counter() - t0) / iters, out
