"""The benchmark's harness: one run of one cell of BENCHMARK.json.

Everything particular to a cell is data or a module of its own, found by
the names in BENCHMARK.json:

  configs/<config file>      the configuration as it is run
  traffic/<traffic>.json     the cell's work: sizes, chunks, warm-up,
                             the profiled stretch, which units are checked
  modes/<mode>.py            how a unit of that work drives the port, and
                             how the reference judges it (named by the
                             traffic file's "mode")
  checks/<workload>.json     the limit of each number compared
  metrics/<metric>.py        one per-layer metric, read from the run's
                             record (None where it finds nothing)
  counts/                    operations and bytes, and the chip's peaks

A run: set-up and warm-up (setup_s), a window of `seconds` of units,
with `trace` a profiled stretch after it, then, with the program's state
freed, the comparison of the sampled units with the reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "swraytracing_tpu")


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """The module in file `path` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(root: Path, workload: str):
    """(bench, workload entry, config entry, config, traffic, limits) of
    the cell named `workload` in root/BENCHMARK.json."""
    bench = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    c = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / c["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "checks" / f"{workload}.json")["limits"]
    return bench, w, c, config, traffic, limits


def cell_metrics(bench, workload: str, trace: bool):
    """The metric entries this cell reports: the end-to-end ones with
    trace off, the per-layer ones with it on."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def sample_units(seed: int, check: dict) -> list:
    """The indices of the window's units that are compared, drawn from
    the seed among the first check["within"]."""
    rng = np.random.default_rng(seed)
    return sorted(int(i) for i in rng.choice(check["within"],
                                             size=check["units"],
                                             replace=False))


def run_window(cell, seconds, keep, cuda, restart):
    """Units of `cell` until `seconds` have passed, the indices in `keep`
    kept for the comparison; then, untimed, any kept unit past the close.
    Every `restart` units the cell starts again from its state after the
    warm-up, so a window of any length repeats one fixed stretch of the
    run drawn from the seed (a faster program never runs into a part of
    the run a slower one did not reach). Returns (the window's record,
    units run, units failed)."""
    if max(keep) >= restart:
        raise ValueError("the units compared lie in the first stretch")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
        if cuda else None
    units = steps = work = failed = 0
    enqueue_s = 0.0
    if ev:
        ev[0].record()
    t0 = time.perf_counter()
    while True:
        if units and units % restart == 0:
            cell.restart()
        r = cell.unit(keep=units in keep)
        units += 1
        steps += r["steps"]
        work += r["work"]
        enqueue_s += r["enqueue_s"]
        failed += not r["ok"]
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if ev:
        ev[1].record()
        ev[1].synchronize()
    window = {"units": units, "steps": steps, "work": work,
              "seconds": elapsed, "enqueue_s": enqueue_s,
              "event_s": ev[0].elapsed_time(ev[1]) / 1e3 if ev else elapsed}
    while units <= max(keep):
        if units % restart == 0:
            cell.restart()
        r = cell.unit(keep=units in keep)
        units += 1
        failed += not r["ok"]
    return window, units, failed


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def set_up(root: Path, workload: str, seed: int, device, overrides=None):
    """(bench, traffic, limits, cell) of the cell named `workload`, set up
    from the seed and warmed up. `overrides` ({"config": {...},
    "traffic": {...}}) replace keys of the cell's files: the tests run a
    cell at a size the CPU holds."""
    bench, w, c, config, traffic, limits = find_cell(root, workload)
    config = merged(config, (overrides or {}).get("config"))
    traffic = merged(traffic, (overrides or {}).get("traffic"))
    mode = importlib.import_module(f"portbench.modes.{traffic['mode']}")
    cell = mode.Cell(config, traffic, seed, device)
    cell.warmup()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return bench, traffic, limits, cell


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, overrides=None) -> dict:
    """One run; returns the result line's fields and the checks."""
    bench, traffic, limits, cell = set_up(root, workload, seed, device,
                                          overrides)
    cuda = torch.device(device).type == "cuda"
    setup_s = time.time() - t_start

    keep = sample_units(seed, traffic["check"])
    window, units, failed = run_window(cell, seconds, keep, cuda,
                                       traffic["restart_units"])
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    rec = {"kind": cell.kind, "window": window, "setup_s": setup_s,
           "march_bound_s_per_step": cell.march_bound_s_per_step(),
           **cell.timings()}
    if trace:
        from . import trace as tr
        cell.restart()
        rec["trace"] = tr.profile_units(cell, traffic["trace_units"],
                                        traffic.get("trace_saves_per_unit"))
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = cell.check()
    numbers["failed_units"] = failed
    found = forbidden_modules()
    if found:
        raise RuntimeError("the run loaded " + ", ".join(found))

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = load_module(HERE / "metrics" / f"{m['name']}.py",
                            m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in numbers.items()}
    correct = all(math.isfinite(x["value"]) and x["value"] <= x["limit"]
                  for x in checks.values())
    result = {"correct": correct, "attempted": units, "failed": failed,
              "metrics": metrics}
    if cuda:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(0),
                            "count": 1, "memory_peak_bytes": memory_peak}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if trace:
        t = rec["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["top_ops"],
                               "idle_gaps": t["top_gaps"]}
    result["checks"] = checks
    return result

