"""Faults planted under the timed path, for the check that the comparison
catches each fault a cell can have: the tests plant them at a size the
CPU holds, calibrate.py --faults at a cell's own size on the chip. Each
fault patches the port through `setattr(obj, name, value)` (pytest's
monkeypatch.setattr, or `planted`, which undoes it). One chip: no
exchange between chips to leave out."""

import contextlib
import dataclasses

import torch

from swraytracing_torch.models import coupled2
from swraytracing_torch.ops import march_window as mw
from swraytracing_torch.parallel import ensemble


def unchanged(setattr):
    """Every lock-step returns its state unchanged."""
    def step(carry, *args, **kwargs):
        return dataclasses.replace(carry)
    setattr(coupled2, "lockstep_step", step)
    setattr(ensemble, "lockstep_step", step)


def half(setattr):
    """The march leaves half of its batch (packets; members of an
    ensemble) where they were."""
    single, batched = mw.fused_march_gathered, mw.march_gathered_batched

    def march(win1, win2, xk, *rest):
        out, ov = single(win1, win2, xk, *rest)
        h = xk.shape[-1] // 2
        return torch.cat([out[:, :h], xk[:, h:]], 1), ov

    def march_b(win1, win2, xk, *rest):
        out, ov = batched(win1, win2, xk, *rest)
        h = xk.shape[0] // 2
        return torch.cat([out[:h], xk[h:]]), ov
    setattr(mw, "fused_march_gathered", march)
    setattr(mw, "march_gathered_batched", march_b)


def altered(setattr):
    """The march's answer for one packet's wavevector is 1% off."""
    single, batched = mw.fused_march_gathered, mw.march_gathered_batched

    def bump(out):
        scale = torch.ones_like(out)
        scale[..., 2:, 0] = 1.01
        return out * scale

    def march(*a):
        out, ov = single(*a)
        return bump(out), ov

    def march_b(*a):
        out, ov = batched(*a)
        return bump(out), ov
    setattr(mw, "fused_march_gathered", march)
    setattr(mw, "march_gathered_batched", march_b)


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
