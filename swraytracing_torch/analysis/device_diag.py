"""On-device run diagnostics: the e(omega) statistic accumulated per save,
so long runs read O(bins) numbers per save instead of full packet frames.

Counterpart of swraytracing_tpu/analysis/device_diag.py. The reference
computes its headline energy-versus-frequency result post hoc from saved
packet_k frames (analysis/load_data.m:33-52: histogram of
omega = sqrt(f^2 + Cg^2 |k|^2) into linspace edges, energy
= binCenter * count, pooled over +-500-frame windows). Histogram counts
are additive over frames, so accumulating a per-save count vector on the
device loses nothing: any window statistic load_data.m can form from
frames is a sum of saved rows.

The counts are one index_add_ into an (n_bins+1,) tensor: no
(n_bins+1, Np) compare-and-sum mask (the JAX package's TPU form), and no
torch.bincount, which reads the input's range back to the host on CUDA.
Counts are in the packets' dtype; per-save counts are bounded by
Np << 2^24, so float32 is exact, and so is their order-free atomic sum.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["OmegaHistSpec", "omega_hist_counts", "hist_edges"]


class OmegaHistSpec(NamedTuple):
    """Histogram configuration.

    log_bins=False — load_data.m's layout: n_bins equal bins on
    [0, omega_max] (edges = linspace(0, omega_max, n_bins+1)); one extra
    OVERFLOW slot counts omega >= omega_max so truncation is observable.

    log_bins=True — n_bins log-spaced bins on [omega_min, omega_max]
    (edges = geomspace): with omega_min = f the low end is exact
    (omega >= f), and a generous omega_max (e.g. 64 * w0 * f) costs only
    log resolution.
    """

    n_bins: int
    omega_max: float
    f: float
    Cg: float
    omega_min: float = 0.0
    log_bins: bool = False


def hist_edges(spec: OmegaHistSpec) -> np.ndarray:
    """The n_bins+1 bin edges (numpy, host-side): linspace on
    [0, omega_max], or geomspace on [omega_min, omega_max] when
    log_bins."""
    if spec.log_bins:
        return np.geomspace(spec.omega_min, spec.omega_max,
                            spec.n_bins + 1)
    return np.linspace(0.0, spec.omega_max, spec.n_bins + 1)


def omega_hist_counts(pk: torch.Tensor, spec: OmegaHistSpec,
                      omega_max=None) -> torch.Tensor:
    """Histogram of intrinsic frequency omega(k) over the packet batch.

    Args:
      pk: (2, Np) coordinate-first wavenumbers (the carry layout), or an
        ensemble's (E, 2, Np), one histogram per member.
      spec: OmegaHistSpec.
      omega_max: optional override of spec.omega_max: a float, or a tensor
        on pk's device (read on the device, never on the host), 0-dim, or
        (E,) with each member's own scale.
    Returns:
      (n_bins + 1,) counts on pk's device, dtype of pk; slot n_bins is the
      overflow count (omega >= omega_max). (E, n_bins + 1) for members,
      row e equal to omega_hist_counts(pk[e], spec, omega_max[e]).

    Every division is by a tensor: on a CUDA tensor PyTorch turns a
    division by a Python scalar into a multiplication by its reciprocal,
    which can put a sample on a bin edge into the neighbouring bin. A
    member's arithmetic is the single histogram's, element for element.
    """
    om = torch.sqrt(spec.f**2 + spec.Cg**2 * (pk[..., 0, :] * pk[..., 0, :]
                                              + pk[..., 1, :] * pk[..., 1, :]))
    wmax = spec.omega_max if omega_max is None else omega_max
    # a static scale is divided on the host in float64 and a tensor on the
    # device, as the JAX package does with a static or a traced omega_max
    static = not isinstance(wmax, torch.Tensor)

    def scalar(value):
        """A host scale as a 0-dim tensor, a device scale (E,) as (E, 1)
        beside its members' samples. A host scale is filled in on the
        device: a copy from the host would wait for the stream's queued
        work first."""
        if isinstance(value, (int, float)):
            return pk.new_full((), value)
        t = torch.as_tensor(value, dtype=pk.dtype, device=pk.device)
        return t.reshape(*t.shape, 1) if t.dim() else t

    if spec.log_bins:
        # idx = floor(log(om/omega_min) / dlog); om >= f >= omega_min
        # mathematically, so only rounding can go below bin 0
        wmin = om.new_full((), spec.omega_min)
        dlog = torch.log(scalar(wmax / (spec.omega_min if static else wmin))
                         ) / om.new_full((), spec.n_bins)
        idx = torch.floor(torch.log(om / wmin) / dlog)
    else:
        nb = spec.n_bins if static else om.new_full((), spec.n_bins)
        idx = torch.floor(om / scalar(wmax / nb))
    idx = idx.clamp(0, spec.n_bins).to(torch.int64)   # top = overflow slot
    n = spec.n_bins + 1
    if om.dim() == 2:   # members: one row of counts each
        idx = idx + torch.arange(om.shape[0], device=om.device)[:, None] * n
        counts = pk.new_zeros(om.shape[0] * n)
        return counts.index_add_(0, idx.reshape(-1),
                                 torch.ones_like(om).reshape(-1)).reshape(-1, n)
    counts = pk.new_zeros(n)
    return counts.index_add_(0, idx, torch.ones_like(om))
