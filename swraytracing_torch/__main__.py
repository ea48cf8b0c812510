"""Command-line entry point — the headless-MATLAB replacement.

Counterpart of `python -m swraytracing_tpu`, with the same subcommands and
arguments, except that `--platform` becomes `--device` and `--dtype`
selects the precision:

    python -m swraytracing_torch qgsw  --nx 256 --packets 50 --w0 2 ...
    python -m swraytracing_torch qg2   --nx 512 --packets 1048576 ...
    python -m swraytracing_torch sweep --base-dir sweep --nx 256 ...
    python -m swraytracing_torch analyze RUN_DIR --out figs/

Runs go to the CUDA device and fail when there is none, unless
`--device cpu` is given. `sweep` runs the reference's 20-config (w0, U_g)
table in-process, one run after another, or with `--ensemble` (one-layer
model only) all members in one program with on-device omega histograms
instead of packet frames. `analyze` needs matplotlib.
"""

from __future__ import annotations

import argparse
import sys

_DTYPES = ("float32", "float64")


def _common(p):
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--packets", type=int, default=50)
    p.add_argument("--w0", type=float, default=2.0,
                   help="near-inertial factor (initial omega/f)")
    p.add_argument("--t-fr-days", type=float, default=6000.0)
    p.add_argument("--delay-days", type=float, default=1000.0)
    p.add_argument("--ug", type=float, default=0.4)
    p.add_argument("--f", type=float, default=3.0)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--out", default="data")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' "
                        "runs on the CPU)")
    p.add_argument("--dtype", choices=_DTYPES, default="float32",
                   help="real dtype of the state")


def _run_kwargs(args):
    import torch

    return dict(T_Fr_days=args.t_fr_days, packet_delay_days=args.delay_days,
                f=args.f, Cg=args.cg, max_steps=args.max_steps,
                device=args.device, dtype=getattr(torch, args.dtype))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="swraytracing_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    for name in ("qgsw", "qg2"):
        p = sub.add_parser(name, help=f"run the {name} coupled driver")
        _common(p)

    p = sub.add_parser("sweep", help="run the (w0, U_g) parameter sweep")
    _common(p)
    p.add_argument("--base-dir", default="sweep")
    p.add_argument("--model", choices=("qgsw", "qg2"), default="qgsw")
    p.add_argument("--ensemble", action="store_true",
                   help="all members in ONE program (on-device omega "
                        "histograms instead of frames)")
    p.add_argument("--hist-bins", type=int, default=300)

    p = sub.add_parser("analyze", help="e(omega) + trajectory figures")
    p.add_argument("run_dir")
    p.add_argument("--out", default=".")
    p.add_argument("--offset", type=int, default=500)

    args = ap.parse_args(argv)

    if args.cmd in ("qgsw", "qg2"):
        from . import drivers

        fn = (drivers.qgsw_raytrace if args.cmd == "qgsw"
              else drivers.qg2layersw_raytrace)
        fn(nx=args.nx, Npackets=args.packets, near_inertial_factor=args.w0,
           U_g=args.ug, out_dir=args.out, resume=args.resume,
           **_run_kwargs(args))
    elif args.cmd == "sweep":
        from . import drivers

        if args.ensemble:
            if args.model != "qgsw":
                ap.error("--ensemble supports only --model qgsw (the "
                         "vmapped ensemble runs the one-layer physics); "
                         "run a qg2 sweep without --ensemble")
            drivers.run_sweep(base_dir=args.base_dir, ensemble=True,
                              nx=args.nx, Npackets=args.packets,
                              omega_hist_bins=args.hist_bins,
                              resume=args.resume, **_run_kwargs(args))
        else:
            fn = (drivers.qgsw_raytrace if args.model == "qgsw"
                  else drivers.qg2layersw_raytrace)
            drivers.run_sweep(base_dir=args.base_dir, driver=fn, nx=args.nx,
                              Npackets=args.packets, **_run_kwargs(args))
    elif args.cmd == "analyze":
        import os

        import numpy as np

        from .analysis import spectra, plots

        x, k, t, params = spectra.load_packets(args.run_dir)
        f, Cg = params.get("f", 3.0), params.get("Cg", 1.0)
        om = spectra.omega_of_k(k, f, Cg)
        nf = om.shape[0]
        idx = sorted({1, nf // 3, 2 * nf // 3, nf - 1})
        os.makedirs(args.out, exist_ok=True)
        plots.plot_energy_spectra(
            om, idx, f=f, offset=min(args.offset, nf // 4 + 1),
            path=os.path.join(args.out, "energy_vs_omega.png"))
        plots.plot_trajectories(
            x, k, f, Cg, path=os.path.join(args.out, "trajectories.png"))
        print(f"mean omega/f: {np.mean(om[-1]) / f:.4f}  "
              f"spread: {np.std(om[-1]) / f:.4f}")
        print(f"figures written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
