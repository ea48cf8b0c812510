"""Faults planted under the x-k-a march, for the check that the comparison
of `rsw_512.xka` catches each fault that cell can have, as faults_frozen.py
does for the frozen march. Each fault patches the march that
models/frozen.raytrace_rsw_restart calls once a frame, through
`setattr(obj, name, value)` (pytest's monkeypatch.setattr, or `planted`,
which undoes it): on the kernel route ops/march_rays.march_xka, on the
plain route (CPU tensors, the tests) ops/march_rays.march_xka_reference.

    python3 portbench/faults_rsw.py --seeds <n> ... [--seconds <s>]

runs the cell at its own size on the chip with each fault planted in
turn (portbench/calibrate.readings), one JSON line a reading.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from swraytracing_torch.ops import march_rays as mr  # noqa: E402

WORKLOAD = "rsw_512.xka"


def _patch(setattr, change):
    """Both routes' march with `change(x_in, k_in, a_in, x_out, k_out,
    a_out)` applied to its answer."""
    for name in ("march_xka", "march_xka_reference"):
        march = getattr(mr, name)

        def patched(fields, x, k, a, *rest, march=march):
            return change(x, k, a, *march(fields, x, k, a, *rest))
        setattr(mr, name, patched)


def unchanged(setattr):
    """The march returns the packets it was given."""
    _patch(setattr, lambda x, k, a, xN, kN, aN: (x.clone(), k.clone(),
                                                  a.clone()))


def half(setattr):
    """The march leaves half of the packets where they were."""
    def change(x, k, a, xN, kN, aN):
        h = x.shape[-1] // 2
        return (torch.cat([xN[:, :h], x[:, h:]], 1),
                torch.cat([kN[:, :h], k[:, h:]], 1),
                torch.cat([aN[:h], a[h:]]))
    _patch(setattr, change)


def altered(setattr):
    """The march's answer for one packet's wavevector is 1% off."""
    def change(x, k, a, xN, kN, aN):
        kN = kN.clone()
        kN[:, 0] *= 1.01
        return xN, kN, aN
    _patch(setattr, change)


FAULTS = {f.__name__: f for f in (unchanged, half, altered)}


@contextlib.contextmanager
def planted(name):
    """The fault `name` in place for the block, undone after it."""
    saved = []

    def put(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    try:
        FAULTS[name](put)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def main(argv=None):
    from portbench import calibrate

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("faults_rsw: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for fault in FAULTS:
            with planted(fault):
                r = calibrate.readings(WORKLOAD, seed, args.seconds, False,
                                       "cuda")
            print(json.dumps(dict(r, workload=WORKLOAD, fault=fault)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
