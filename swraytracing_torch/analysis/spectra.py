"""Wave-frequency statistics: e(omega) spectra, histograms, theory pdf.

Counterpart of swraytracing_tpu/analysis/spectra.py. Re-implements the
reference's post-hoc analysis:
  * e(omega) = binCenter * histcount over time windows of +-offset
    frames (analysis/load_data.m:33-52) — the diagnostic behind the
    omega^-2 slope result;
  * mean omega(t) time series (load_data.m:63);
  * the theoretical pdf of the absolute frequency omega_0 + U.k over
    ring angles (ideal_omega_distribution.m:1-24) against which the
    experimental histogram is checked.

All functions but kinetic_energy_spectrum are plain numpy over saved
packet arrays (host-side analysis of a run directory).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "omega_of_k",
    "energy_vs_omega",
    "omega_windows",
    "mean_omega_timeseries",
    "ideal_omega_samples",
    "load_packets",
    "load_omega_hist",
    "hist_windows",
    "energy_vs_omega_hist",
    "hist_moments",
    "kinetic_energy_spectrum",
]


def kinetic_energy_spectrum(q, grid, Kd2: float, *, device=None):
    """Isotropic kinetic-energy spectrum KE(K) of a QG PV field —
    scratch/energy_spectrum.m: psik = -qk/(K_d2+K2), KEk = K2 |psik|^2,
    ring-binned over integer |K| (the reference loops a mask per ring;
    here one index_add_ via ops.spectral.isospectrum, which also
    double-counts the conjugate half-plane the reference's full-plane sum
    sees).

    Args:
      q: (nx, ny) PV grid field (or (nx, nky) complex spectrum), numpy or
        a tensor. A tensor is used on its own device; a numpy array goes
        to `device` (None = the CUDA device, raising when there is none;
        pass device="cpu" for the CPU).
    Returns:
      (kmax,) numpy array, rings K = 1..kmax (plot loglog vs K^-3).
    """
    import torch

    from ..ops import spectral as sp
    from ..ops.grid import resolve_device

    if not isinstance(q, torch.Tensor):
        q = torch.tensor(np.asarray(q), device=resolve_device(device))
    qk = q if q.is_complex() else sp.to_spectral(q, grid)
    K2 = grid.tensors(qk.device, sp._real_dtype(qk)).K2
    psik = -qk / (Kd2 + K2)
    KEk = K2 * psik.abs() ** 2
    return sp.isospectrum(KEk, grid).cpu().numpy()


def omega_of_k(k, f: float, Cg: float):
    """Intrinsic frequency per packet: k (..., Np, 2) -> (..., Np)."""
    k = np.asarray(k)
    return np.sqrt(f**2 + Cg**2 * np.sum(k * k, axis=-1))


def energy_vs_omega(omega_samples, bins: int = 300, omega_max=None):
    """e(omega) spectrum of a sample set (load_data.m:37-52):
    histogram of omega into `bins` edges on [0, max], energy
    = binCenter * count. Returns (centers, energy)."""
    w = np.ravel(np.asarray(omega_samples))
    if omega_max is None:
        omega_max = w.max()
    edges = np.linspace(0.0, omega_max, bins)
    centers = 0.5 * (edges[1:] + edges[:-1])
    counts, _ = np.histogram(w, edges)
    return centers, centers * counts


def omega_windows(omega, times_idx, offset: int = 500):
    """Collect omega samples in frame windows [i-offset, i+offset] around
    each index (load_data.m:43-45). omega: (nframes, Np). Returns a list
    of 1-D sample arrays."""
    omega = np.asarray(omega)
    out = []
    n = omega.shape[0]
    for i in times_idx:
        lo = max(0, i - offset)
        hi = min(n, i + offset + 1)
        out.append(np.sort(omega[lo:hi].ravel()))
    return out


def mean_omega_timeseries(omega, f: float = 1.0):
    """mean_k omega / f per frame (load_data.m:63)."""
    return np.mean(np.asarray(omega), axis=-1) / f


def ideal_omega_samples(U, k0: float, f: float, Cg: float,
                        n_angles: int = 100):
    """Samples of the theoretical absolute frequency omega_0 + U.k over
    a ring of wavevectors |k| = k0 and flow samples U (Np, 2)
    (ideal_omega_distribution.m:3-10). Histogram these against the
    experimental omega distribution."""
    t = np.linspace(0.0, 2 * np.pi, n_angles)
    kv = k0 * np.stack([np.cos(t), np.sin(t)], axis=-1)     # (na, 2)
    U = np.asarray(U)
    Udotk = U @ kv.T                                        # (Np, na)
    omega0 = np.sqrt(f**2 + Cg**2 * k0**2)
    return (omega0 + Udotk).ravel()


def load_omega_hist(run_dir):
    """Load the on-device omega-histogram series written by a driver run
    in diagnostic mode (drivers omega_hist_bins > 0; rows produced by
    analysis.device_diag.omega_hist_counts).

    Returns (counts (nframes, n_bins+1), edges (n_bins+1,), t, params).
    counts[:, -1] is the overflow slot (omega >= omega_max); edges bound
    the first n_bins slots.
    """
    import os

    from ..io import binio, runmeta

    params = runmeta.RunDir(run_dir).read_params()
    nb = int(params["omega_hist_bins"])
    wmax = float(params["omega_hist_max"])
    t = binio.read_field(os.path.join(str(run_dir), "packet_time"))
    nf = len(t)
    counts = binio.read_field(os.path.join(str(run_dir), "omega_hist"),
                              nb + 1, 1, 1, list(range(1, nf + 1)))
    if params.get("omega_hist_log"):
        edges = np.geomspace(float(params["omega_hist_min"]), wmax,
                             nb + 1)
    else:
        edges = np.linspace(0.0, wmax, nb + 1)
    return counts.T, edges, t, params


def hist_windows(counts, times_idx, offset: int = 500):
    """Pooled counts over frame windows [i-offset, i+offset]
    (load_data.m:43-45 on count rows instead of samples — counts are
    additive over frames, so this equals histogramming the pooled
    samples). counts: (nframes, nbins[+1]). Returns list of row sums."""
    counts = np.asarray(counts)
    n = counts.shape[0]
    out = []
    for i in times_idx:
        lo = max(0, i - offset)
        hi = min(n, i + offset + 1)
        out.append(counts[lo:hi].sum(axis=0))
    return out


def energy_vs_omega_hist(counts, edges):
    """e(omega) from a pooled count row (load_data.m:50: energy
    = binCenter * count). Drops the overflow slot if present.
    Returns (centers, energy).

    For non-uniform (log-spaced) edges each bin's count is rescaled by
    mean_width/width so the curve is the same density estimate
    load_data.m's equal bins produce — with uniform edges the factor is
    exactly 1 and this reduces to binCenter * count."""
    counts = np.asarray(counts, dtype=np.float64)
    centers = 0.5 * (edges[1:] + edges[:-1])
    widths = np.diff(edges)
    return centers, centers * counts[:len(centers)] * (widths.mean()
                                                       / widths)


def hist_moments(counts, edges):
    """(mean, std) of omega from a count row (bin-center approximation;
    the discretization bias is O(dw^2/12) ~ 1e-4 at production bin
    widths). Drops the overflow slot."""
    counts = np.asarray(counts, dtype=np.float64)
    centers = 0.5 * (edges[1:] + edges[:-1])
    c = counts[:len(centers)]
    n = c.sum()
    mean = (centers * c).sum() / n
    var = (c * (centers - mean) ** 2).sum() / n
    return mean, np.sqrt(var)


def load_packets(run_dir, n_packets: int | None = None):
    """Load (x, k, t, params) from a run directory written by our
    drivers (or a reference run gathered by analysis/gather_data.bash) —
    the load_data.m entry path: packet_time is a 0-d series; packet_x /
    packet_k are (Np, 2) frames."""
    import os

    from ..io import binio, runmeta

    params = {}
    pj = os.path.join(str(run_dir), "params.json")
    rl = os.path.join(str(run_dir), "run.log")
    if os.path.exists(pj):
        params = runmeta.RunDir(run_dir).read_params()
    elif os.path.exists(rl):
        params = runmeta.parse_run_log(rl)
    if n_packets is None:
        n_packets = int(params["n_packets"])

    t = binio.read_field(os.path.join(str(run_dir), "packet_time"))
    nf = len(t)
    x = binio.read_field(os.path.join(str(run_dir), "packet_x"),
                         n_packets, 2, 1, list(range(1, nf + 1)))
    k = binio.read_field(os.path.join(str(run_dir), "packet_k"),
                         n_packets, 2, 1, list(range(1, nf + 1)))
    # (Np, 2, nframes) -> (nframes, Np, 2)
    return np.moveaxis(x, -1, 0), np.moveaxis(k, -1, 0), t, params
