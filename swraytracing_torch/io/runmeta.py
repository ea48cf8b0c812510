"""Run metadata: structured config/metrics + reference run.log parity.

Counterpart of swraytracing_tpu/io/runmeta.py; both write the same
params.json keys and the same run.log text. The reference's only run
metadata is its run.log, whose parameter header is parsed back by every
analysis script (parse_data in SW_zero_background_raytracing.m:147-163,
analysis/load_data.m:13-27 — the log IS the config store). Here the
structured record is params.json + metrics.jsonl per run directory;
`write_run_log` additionally emits a reference-format run.log (same
"key: value" lines, qgsw_raytrace.m:76-88) so the reference's own
analysis tooling can consume our runs, and `parse_run_log` reads either
our logs or the reference's committed ones.
"""

from __future__ import annotations

import json
import os
import re
import time
from pathlib import Path

__all__ = ["RunDir", "parse_run_log"]

_LOG_KEYS = [
    ("Resolution", "{nx}x{ny}"),
    ("Number of packets", "{n_packets}"),
    ("Initial wavenumber radius", "{k_radius:f}"),
    ("Time step", "{dt:f}"),
    ("Simulation time", "{T:f}"),
    ("Spin-up time", "{spin_up:f}"),
    ("Steps per save", "{steps_per_save}"),
    ("Steps per packet save", "{packet_steps_per_save}"),
    ("Coriolis parameter", "{f:f}"),
    ("Group velocity", "{Cg:f}"),
    ("Background velocity (parameter,computed)", "({U_g:f},{U0:f})"),
    ("Froude Number", "{Fr:f}"),
    ("Deformation wavenumber", "{Kd2:f}"),
]


class RunDir:
    """A run output directory: params.json, metrics.jsonl, run.log, and
    the frame-addressed .bin field files (via io.binio)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()

    def file(self, name: str) -> str:
        return str(self.path / name)

    # -- structured config/metrics ----------------------------------------

    def write_params(self, **params) -> None:
        with open(self.path / "params.json", "w") as fh:
            json.dump(params, fh, indent=1, default=float)

    def read_params(self) -> dict:
        with open(self.path / "params.json") as fh:
            return json.load(fh)

    def log_metrics(self, **metrics) -> None:
        """Append one JSON line (step metrics, timings, energies)."""
        with open(self.path / "metrics.jsonl", "a") as fh:
            fh.write(json.dumps(metrics, default=float) + "\n")

    def read_metrics(self) -> list:
        p = self.path / "metrics.jsonl"
        if not p.exists():
            return []
        with open(p) as fh:
            return [json.loads(line) for line in fh if line.strip()]

    # -- reference-format run.log -----------------------------------------

    def write_run_log(self, nx, n_packets, k_radius, dt, T, spin_up,
                      steps_per_save, packet_steps_per_save, f, Cg, U_g,
                      U0, Fr, Kd2, ny=None) -> None:
        vals = dict(nx=nx, ny=ny if ny is not None else nx,
                    n_packets=n_packets, k_radius=k_radius, dt=dt, T=T,
                    spin_up=spin_up, steps_per_save=steps_per_save,
                    packet_steps_per_save=packet_steps_per_save, f=f, Cg=Cg,
                    U_g=U_g, U0=U0, Fr=Fr, Kd2=Kd2)
        with open(self.path / "run.log", "w") as fh:
            for key, fmt in _LOG_KEYS:
                fh.write(f"{key}: {fmt.format(**vals)}\n")

    def finish_run_log(self) -> None:
        with open(self.path / "run.log", "a") as fh:
            fh.write("Real time elapsed: "
                     f"{time.time() - self._t0:.3f} seconds\n")


_NUM = r"([-+0-9.eE]+)"


def parse_run_log(path) -> dict:
    """Parse a run.log (ours or a reference MATLAB one) back into a
    dict — parse_data semantics (SW_zero_background_raytracing.m:147-163:
    resolution, Npackets, f, Cg, Ug; we extract every header line)."""
    text = Path(path).read_text()
    out = {}

    def grab(pattern, key, cast=float):
        m = re.search(pattern, text)
        if m:
            out[key] = cast(m.group(1))

    m = re.search(r"Resolution: (\d+)x(\d+)", text)
    if m:
        out["nx"], out["ny"] = int(m.group(1)), int(m.group(2))
    grab(r"Number of packets: (\d+)", "n_packets", int)
    grab(rf"Initial wavenumber radius: {_NUM}", "k_radius")
    grab(rf"Time step: {_NUM}", "dt")
    grab(rf"Simulation time: {_NUM}", "T")
    grab(rf"Spin-up time: {_NUM}", "spin_up")
    grab(r"Steps per save: (\d+)", "steps_per_save", int)
    grab(r"Steps per packet save: (\d+)", "packet_steps_per_save", int)
    grab(rf"Coriolis parameter: {_NUM}", "f")
    grab(rf"Group velocity: {_NUM}", "Cg")
    grab(rf"Froude Number: {_NUM}", "Fr")
    grab(rf"Deformation wavenumber: {_NUM}", "Kd2")
    m = re.search(rf"Background velocity \(parameter,computed\): "
                  rf"\({_NUM},{_NUM}\)", text)
    if m:
        out["U_g"], out["U0"] = float(m.group(1)), float(m.group(2))
    grab(rf"Real time elapsed: {_NUM} seconds", "wall_seconds")
    return out
