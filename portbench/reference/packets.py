"""The packets' initial conditions, plain (qgsw_raytrace.m:54-60).

Copied from swraytracing_torch/models/coupled.ring_packet_ics (commit
701921e): |k| on the near-inertial ring sqrt((w0^2 - 1) f^2 / Cg^2) at
equally spaced angles 2 pi i / Np, i = 1..Np; positions uniform on
[0, L)^2 from numpy.random.default_rng(seed).
"""

import numpy as np
import torch


def ring(seed, n, w0, f, Cg, L, device, dtype=torch.float64):
    """x, k (2, n)."""
    rng = np.random.default_rng(int(seed))
    i = np.arange(1, n + 1)
    wf = np.sqrt((w0 ** 2 - 1.0) * f ** 2 / Cg ** 2)
    k = wf * np.stack([np.cos(2 * np.pi * i / n), np.sin(2 * np.pi * i / n)])
    x = rng.uniform(0.0, L, (2, n))
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(k, dtype=dtype, device=device))
