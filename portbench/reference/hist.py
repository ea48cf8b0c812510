"""The omega histogram, plain.

Copied from swraytracing_torch/analysis/device_diag.omega_hist_counts
(commit 701921e), log-spaced bins: n_bins bins on [f, omega_max]
(geomspace), a sample's bin floor(log(omega / f) / dlog) clamped to
[0, n_bins], slot n_bins counting omega >= omega_max.
"""

import torch


def counts(k, f, Cg, n_bins, omega_max):
    """(E, n_bins + 1) int64 counts of k (E, 2, P); omega_max (E,)."""
    om = torch.sqrt(f * f + Cg * Cg * (k * k).sum(1))
    wmax = torch.as_tensor(omega_max, dtype=om.dtype, device=om.device)
    dlog = torch.log(wmax / f)[:, None] / n_bins
    idx = torch.floor(torch.log(om / f) / dlog).clamp(0, n_bins).long()
    E = k.shape[0]
    idx = idx + torch.arange(E, device=k.device)[:, None] * (n_bins + 1)
    return torch.bincount(idx.reshape(-1),
                          minlength=E * (n_bins + 1)).reshape(E, -1)
