"""Profiling helpers: device timelines and timing that waits for the card.

Counterpart of swraytracing_tpu/utils/profiling.py. The reference's only
instrumentation is tic/toc wall-clock lines in its run logs
(qgsw_raytrace.m:114,178-179). Here:
  * `trace(log_dir)`: a torch.profiler context over the host and, where
    there is one, the CUDA device; it writes a Chrome trace into log_dir
    (chrome://tracing, Perfetto) and hands the profile to the caller for
    its key_averages();
  * `Timer`, `time_callable`: wall-clock timing that synchronises the
    CUDA device the work ran on before it reads the clock. PyTorch returns
    from a launch before the card has run it, so a clock read without the
    synchronisation times the host's enqueue.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import torch

__all__ = ["trace", "Timer", "time_callable"]


@contextlib.contextmanager
def trace(log_dir, name: str = "trace"):
    """Profile the block: host operations, and CUDA kernels, copies and
    memsets when CUDA is available. On exit the trace is written to
    log_dir/<name>.json. Yields the torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
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
