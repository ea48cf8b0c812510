"""Deterministic checkpoint/resume of full simulation state.

Counterpart of swraytracing_tpu/io/checkpoint.py, in the same .npz
layout, so a run checkpointed by either package resumes in the other:
`leaf_<i>` holds the i-th leaf of the state in the order the JAX package
flattens it — dataclass fields in declaration order, nested dataclasses
in place, None slots skipped (for CoupledCarry: qk, rhs_m1, rhs_m2, t,
step, packet_x, packet_k, prev_fields, then prev_win and overflow when
set) — plus `__treedef__`, a description nothing reads back. A host
scalar is stored as a 0-d array: the time as float64, the step count as
int32, the JAX package's types. An ensemble's carry (parallel/ensemble.py)
keeps its members' times and step counts in host arrays, stored the same
way as (E,) arrays: `leaf_3` is the members' `t`, as the JAX package's
ensemble checkpoints hold it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_state", "restore_state", "latest_checkpoint"]


def _leaves(state, prefix=""):
    """[(name, leaf)] in the JAX package's flattening order."""
    if dataclasses.is_dataclass(state):
        out = []
        for f in dataclasses.fields(state):
            value = getattr(state, f.name)
            if value is not None:
                out += _leaves(value, f"{prefix}{f.name}.")
        return out
    return [(prefix[:-1], state)]


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.int32(leaf)
    if isinstance(leaf, float):
        return np.float64(leaf)
    leaf = np.asarray(leaf)
    if leaf.dtype.kind in "iu":    # members' step counts
        return leaf.astype(np.int32)
    if leaf.dtype.kind == "f":     # members' times
        return leaf.astype(np.float64)
    return leaf


def _rebuild(like, leaves):
    """A copy of `like` whose leaves are taken in order from the iterator
    `leaves`, each cast to the type (and for tensors the dtype and device)
    of the leaf it replaces."""
    if dataclasses.is_dataclass(like):
        changes = {f.name: _rebuild(getattr(like, f.name), leaves)
                   for f in dataclasses.fields(like)
                   if getattr(like, f.name) is not None}
        return dataclasses.replace(like, **changes)
    value = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.tensor(value, dtype=like.dtype, device=like.device)
    if isinstance(like, (int, float)):
        return type(like)(value)
    if isinstance(like, np.ndarray):
        return np.array(value, dtype=like.dtype)
    return value


def save_state(path, state, step: int | None = None) -> str:
    """Save a dataclass state to <path>[_<step>].npz (atomic rename). One
    synchronisation: every tensor is copied to the host."""
    path = Path(path)
    if step is not None:
        path = path.with_name(f"{path.stem}_{step:012d}")
    path = path.with_suffix(".npz")
    leaves = _leaves(state)
    arrays = {f"leaf_{i}": _to_host(leaf)
              for i, (_, leaf) in enumerate(leaves)}
    names = [name for name, _ in leaves]
    tmp = path.with_suffix(".npz.tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, __treedef__=np.frombuffer(
            json.dumps(names).encode(), dtype=np.uint8), **arrays)
    tmp.rename(path)
    return str(path)


def restore_state(path, like):
    """Restore into the structure of `like`: its non-None slots take the
    saved leaves in order, each cast to the dtype and device of the
    tensor it replaces (host scalars to their Python type). Shapes come
    from the file."""
    with np.load(path) as data:
        n = len(_leaves(like))
        leaves = [np.asarray(data[f"leaf_{i}"]) for i in range(n)]
    return _rebuild(like, iter(leaves))


def latest_checkpoint(directory, prefix: str = "ckpt") -> str | None:
    cands = sorted(Path(directory).glob(f"{prefix}_*.npz"))
    return str(cands[-1]) if cands else None
