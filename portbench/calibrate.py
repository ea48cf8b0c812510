"""Read the two sides of each compared number's limit on the chip.

    python3 portbench/calibrate.py --workload <name> --seeds <n> ... \
        [--control-seeds <n> ...] [--faults <name> ... --fault-seeds <n> ...]
        [--seconds <s>]

For every seed, in one process: the cell's set-up and warm-up, a short
window at the cell's own load, and the numbers of its sampled units
against the reference (the program's readings: the lower ends). For the
control seeds also the control's: the reference in bfloat16 storage
(float32 arithmetic), put in the program's place from the same sampled
inputs (the upper ends). For the fault seeds, a run with each fault of
faults.py planted under the timed path, on its own. One JSON line a
reading. The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload, seed, seconds, control, device, overrides=None,
             root=ROOT):
    from portbench import core
    import torch

    _, traffic, _, cell = core.set_up(root, workload, seed, device,
                                      overrides)
    keep = core.sample_units(seed, traffic["check"])
    _, units, failed = core.run_window(cell, seconds, keep,
                                       torch.device(device).type == "cuda",
                                       traffic["restart_units"])
    cell.release()
    out = {"seed": seed, "units": units}
    t0 = time.perf_counter()
    out["program"] = dict(cell.check(), failed_units=failed)
    out["reference_s"] = time.perf_counter() - t0
    if control:
        out["control"] = cell.control()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import faults
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    sound = set(args.seeds + args.control_seeds)
    for seed in dict.fromkeys(args.seeds + args.control_seeds
                              + args.fault_seeds):
        for fault in ([None] if seed in sound else []) + \
                (args.faults if seed in args.fault_seeds else []):
            try:
                with (faults.planted(fault) if fault
                      else contextlib.nullcontext()):
                    r = readings(args.workload, seed, args.seconds,
                                 fault is None
                                 and seed in args.control_seeds, "cuda")
            except Exception as err:    # a fault that crashes has failed
                if fault is None:
                    raise
                r = {"seed": seed, "error": repr(err)[:500]}
            print(json.dumps(dict(r, workload=args.workload, fault=fault)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
