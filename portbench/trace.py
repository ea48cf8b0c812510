"""The profiled stretch of a `--trace 1` run and what is read from it.

A few units run under torch.profiler (host and CUDA activities) after
the measured window, inside the harness's own spans (`bench.*`,
torch.profiler.record_function, around its calls into the port). For the
stretch only, each function of the port named in spans/<span>.json runs
inside a span of that name too. The Chrome trace goes to a file under
TMPDIR, is read back and deleted:

  device operations  kernels, copies and memsets, by name and in all
  busy               the union of their intervals over the stretch
  idle gaps          the stretch's time with no device operation,
                     summed by what the host was in at each gap's start:
                     the innermost harness span and host operation
  march              device time of the kernels named in
                     kernel_names.json (K1, every route)
  span device time   for each span of spans/, device time of every
                     operation launched inside it (the launch's runtime
                     call, matched by its correlation id, lies in the
                     span on the same thread)
"""

import bisect
import contextlib
import importlib
import json
import os
import re
import tempfile
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

HERE = Path(__file__).parent
NAMES = json.loads((HERE / "kernel_names.json").read_text())
SPANS = {p.name[:-len(".json")]: json.loads(p.read_text())
         for p in sorted((HERE / "spans").glob("*.json"))}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _matches(name, patterns):
    return any(re.search(p, name) for p in patterns)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans, starts, t):
    """Name of the innermost span (start, end, name) holding t: of nested
    spans sorted by start, the last to start that has not ended."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[i][1] >= t:
            return spans[i][2]
    return "none"


def _in_spans(launch, spans):
    """Whether a launch (thread, t) lies in one of spans {thread: [(start,
    end)]}."""
    return launch is not None and any(
        s <= launch[1] <= e for s, e in spans.get(launch[0], ()))


def read(events, units, steps):
    """The record of a profiled stretch from its Chrome trace events."""
    dev, spans, ops = [], [], []
    launches, dev_corr = {}, []
    named = {name: {} for name in SPANS}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s, e = float(ev["ts"]) * 1e-6, (float(ev["ts"]) + ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((s, e, ev["name"]))
            dev_corr.append(corr)
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ((ev.get("pid"), ev.get("tid")), s)
        elif cat == "user_annotation" and ev["name"].startswith("bench."):
            spans.append((s, e, ev["name"]))
            if ev["name"] in named:
                named[ev["name"]].setdefault(
                    (ev.get("pid"), ev.get("tid")), []).append((s, e))
        elif cat == "cpu_op":
            ops.append((s, e, ev["name"]))
    spans.sort()
    ops.sort()
    span_starts = [s for s, _, _ in spans]
    op_starts = [s for s, _, _ in ops]
    t0 = min(s for s, _, _ in spans)
    t1 = max(e for _, e, _ in spans)
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    busy = _merge([(max(s, t0), min(e, t1)) for s, e, _ in dev
                   if e > t0 and s < t1])
    gaps, last = {}, t0
    for s, e in busy + [[t1, t1]]:
        if s > last:
            key = (_innermost(spans, span_starts, last) + "/"
                   + _innermost(ops, op_starts, last))
            gaps[key] = gaps.get(key, 0.0) + (s - last)
        last = max(last, e)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:10]

    return {"units": units, "steps": steps, "device_ops": len(dev),
            "busy_s": sum(e - s for s, e in busy), "window_s": t1 - t0,
            "march_s": sum(v for k, v in by_name.items()
                           if _matches(k, NAMES["march"])),
            "span_device_s": {
                name: sum(e - s for (s, e, _), c in zip(dev, dev_corr)
                          if _in_spans(launches.get(c), iv))
                for name, iv in named.items()},
            "top_ops": top(by_name), "top_gaps": top(gaps)}


@contextlib.contextmanager
def port_spans():
    """Each function named in spans/ runs inside its span for the block."""
    saved = []

    def spanned(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call
    try:
        for name, where in SPANS.items():
            mod = importlib.import_module(where["module"])
            fn = getattr(mod, where["function"])
            saved.append((mod, where["function"], fn))
            setattr(mod, where["function"], spanned(name, fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def profile_units(cell, units, saves=None):
    """Run `units` units of `cell` under the profiler; their record."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    steps = 0
    with port_spans(), profile(activities=acts) as prof:
        for _ in range(units):
            with record_function("bench.unit"):
                steps += cell.unit(saves=saves)["steps"]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return read(events, units, steps)
