"""The numbers a run compares with the reference, each against a limit
of its own (checks/<workload>.json)."""

import numpy as np
import torch


def rel_l2(a, b):
    """Largest over the leading axis (layers or members) of
    ||a - b|| / ||b||."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    d = torch.linalg.vector_norm((a.to(b.dtype) - b), dim=1)
    return float((d / torch.linalg.vector_norm(b, dim=1)).max())


def x_max_cells(xp, xr, L, dx):
    """Widest periodic gap between two sets of positions, in cells."""
    d = xp.to(xr.dtype) - xr
    d = d - L * torch.round(d / L)
    return float(d.abs().max() / dx)


def k_max_rel(kp, kr):
    """Widest gap between two sets of wavevectors (..., 2, P), as a share
    of the reference's root-mean-square |k|."""
    d = torch.linalg.vector_norm(kp.to(kr.dtype) - kr, dim=-2)
    return float(d.max() / (kr * kr).sum(-2).mean().sqrt())


def hist_moved(rows_p, rows_r, n):
    """Share of the samples that lie in another bin: half the summed
    count gaps over rows of n samples each."""
    d = (rows_p.double() - rows_r.to(rows_p.device).double()).abs().sum()
    return float(d / (2.0 * n * rows_r[..., 0].numel()))


def hist_moved_early(rows_p, rows_r, n, early):
    """hist_moved over each member's first `early` rows of a unit, the
    largest over the members: rows (..., saves, bins), the leading axes
    members (none for a single run). The march's own error, before the
    flow's chaos has grown it, for one member at a time."""
    d = (rows_p.double() - rows_r.to(rows_p.device).double()).abs()
    d = d.reshape(-1, *d.shape[-2:])[:, :early]
    return float((d.sum((1, 2)) / (2.0 * n * d.shape[1])).max())


def hist_total(rows, n):
    """Largest gap between a row's total count and its n samples."""
    return float((rows.double().sum(-1) - n).abs().max())


def periodic_start(x0p, x0r, dx):
    return float((x0p.to(x0r.dtype) - x0r).abs().max() / dx)


def unit_numbers(start, runs, ref_start, ref_runs, L, dx, n, early=None):
    """The numbers of a forward or ensemble cell: the start (initial PV,
    packets, dt) and, largest over the sampled units, each end state and
    histogram rows against the reference's. Packets (E, 2, P) or (2, P).
    With `early`, also hist_moved_early over that many first rows."""
    qk0, x0, k0, dt = start
    rq, rx, rk, rdt = ref_start
    out = {"start_rel": max(rel_l2(qk0, rq), periodic_start(x0, rx, dx),
                            k_max_rel(k0, rk),
                            float(np.abs(np.asarray(dt) / rdt - 1.0).max()))}
    gaps = {"qk_rel": [], "x_max_cells": [], "k_max_rel": [],
            "hist_moved": [], "hist_total": []}
    for (qk, x, k, rows), (q, xr, kr, rr) in zip(runs, ref_runs):
        gaps["qk_rel"].append(rel_l2(qk, q))
        gaps["x_max_cells"].append(x_max_cells(x, xr, L, dx))
        gaps["k_max_rel"].append(max(k_max_rel(a, b) for a, b in
                                     zip(k.reshape(-1, *k.shape[-2:]),
                                         kr.reshape(-1, *kr.shape[-2:]))))
        gaps["hist_moved"].append(hist_moved(rows, rr, n))
        gaps["hist_total"].append(hist_total(rows, n))
        if early:
            gaps.setdefault("hist_moved_early", []).append(
                hist_moved_early(rows, rr, n, early))
    out.update({key: max(v) for key, v in gaps.items()})
    return out
