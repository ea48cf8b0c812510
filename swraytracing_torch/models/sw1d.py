"""One-dimensional solvers: RSW (nonlinear + forced) and the YBJ
near-inertial envelope equation.

Counterpart of swraytracing_tpu/models/sw1d.py:
  * `sw1` — nonlinear 1-D rotating shallow water (rsw/sw1.m:5-10):
        u_t = f v - Cg^2 h_x - (u^2/2)_x
        v_t = -f u - u v_x
        h_t = -u_x - (h u)_x
    pseudo-spectral on the rfft half-spectrum (identical to the
    reference's K = 0..KMAX layout), 3/2-padded dealiased products
    (sw1.m:124-141), AB3 with per-step trapezoidal hyperviscous filters
    rebuilt from the adaptive dt (sw1.m:119-126), RK4 particle
    advection with linear interpolation (rsw/advect1d.m).
  * `sw1_forced` — the nondimensional forced variant (rsw/sw1d.m:6-13):
    Ro/Bu scaling, imposed barotropic V_x(x) = -V0 sin(Kv x) forcing the v
    equation, Williamson RK3 (sw1d.m:38, :77-81).
  * `sw1rk3nu` — explicit hyperviscosity, RK3 (rsw/sw1rk3nu.m).
  * `ybj1d` — Young–Ben Jelloul NIW amplitude equation (rsw/ybj1d.m:6-8):
    A_T + (i/2)(V_x A - Bu A_xx) = 0, complex field, full-spectrum FFT,
    RK3.

The entry points take numpy arrays (or tensors) and a keyword-only
`device` (None = the CUDA device; raises when there is none) and `dtype`.
sw1's adaptive dt stays on the device: `t` is a 0-dim float64 device
tensor summed from the steps' dts, and no step reads a value back to the
host. Every constant (i*K, K^a, the forcing) is built once in the run's
dtype on its device, so a float32 run stays float32 / complex64. Returned
times are float64 tensors on the run's device.

The inverse transform zero-pads the half spectrum and calls `irfft`, as
the JAX package does. A real inverse transform is defined on Hermitian
input only (pocketfft drops the imaginary part of the K=0 entry, cuFFT's
C2R leaves it undefined); here that part is exactly 0 throughout: `rfft`
returns a real K=0 entry, and every update multiplies it by real
coefficients or by i*0. chip_smoke.py holds every 1-D solver on the card
against the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.grid import as_tensor, complex_dtype, resolve_device

__all__ = ["SW1Params", "sw1", "sw1_forced", "sw1rk3nu", "ybj1d",
           "advect1d"]

_RK3 = (1.0 / 3.0, 5.0 / 9.0, 15.0 / 16.0, 153.0 / 128.0, 8.0 / 15.0)
_AB3 = (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0)


class SW1Params(NamedTuple):
    f: float
    Cg: float
    hyper_order: int = 8      # sw1.m:31
    nutune: float = 0.01      # sw1.m:32
    dttune: float = 0.3       # sw1.m:33


def _to_k(f):
    """grid -> half-spectrum (K = 0..KMAX), sw1.m g2s; drops Nyquist by
    construction of KMAX = NX/2 - 1."""
    n = f.shape[0]
    return torch.fft.rfft(f, dim=0)[: n // 2] / n


def _to_g(fk, n):
    """half-spectrum -> grid, sw1.m s2g."""
    kmax1 = fk.shape[0]
    pad = fk.new_zeros((n // 2 + 1 - kmax1,) + tuple(fk.shape[1:]))
    return torch.fft.irfft(torch.cat([fk, pad]), n=n, dim=0) * n


def _pad_big(fk, n):
    """zero-pad half-spectrum to the 3/2 grid; returns (big grid field,
    NXBIG) — sw1.m:113-118 semantics."""
    kmax = n // 2 - 1
    kmaxbig = 3 * (kmax + 1) // 2 - 1
    nbig = 2 * (kmaxbig + 1)
    return _to_g(fk, nbig), nbig


def _unpad_big(fg_big, n):
    kmax = n // 2 - 1
    nbig = fg_big.shape[0]
    return torch.fft.rfft(fg_big, dim=0)[: kmax + 1] / nbig


def _ik(n, dtype, device):
    """i*K, K = 0..n/2-1, complex of the real `dtype`."""
    K = np.arange(n // 2)
    return torch.as_tensor(1j * K, dtype=complex_dtype(dtype), device=device)


def _rhs_products(Uk, iK, n, VXb=None):
    """The padded-grid products u*u, u*(v_x [+ V_x]), u*h of sw1.m's rhs
    (:142-148), back on the half spectrum."""
    wk = torch.stack([Uk[:, 0], iK * Uk[:, 1], Uk[:, 2]], dim=1)
    wg, _ = _pad_big(wk, n)
    u, vx, h = wg[:, 0], wg[:, 1], wg[:, 2]
    if VXb is not None:
        vx = vx + VXb
    prods = torch.stack([u * u, u * vx, u * h], dim=1)
    return _unpad_big(prods, n)


def sw1_rhs(Uk, n, p: SW1Params, iK):
    """sw1.m rhs (:142-148): products u*u, u*v_x, u*h on the padded
    grid."""
    pk = _rhs_products(Uk, iK, n)
    Ru = p.f * Uk[:, 1] - p.Cg**2 * iK * Uk[:, 2] - 0.5 * iK * pk[:, 0]
    Rv = -p.f * Uk[:, 0] - pk[:, 1]
    Rh = -iK * Uk[:, 0] - iK * pk[:, 2]
    return torch.stack([Ru, Rv, Rh], dim=1)


def _stack_frames(frames, like):
    return (torch.stack(frames) if frames
            else like.new_zeros((0,) + tuple(like.shape)))


def sw1(U0, p: SW1Params, nsteps: int, save_every: int = 1, Xp0=None, *,
        device=None, dtype: torch.dtype = torch.float32):
    """Nonlinear 1-D RSW (sw1.m). U0: (nx, 3) grids of (u, v, h).

    Returns (U_frames (nf, nx, 3), t_frames, ke, pe, Xp_frames|None).
    Adaptive dt and the per-step trapezoidal filters (which depend on dt:
    sw1.m:119-126) are computed on the device every step.
    """
    U0 = as_tensor(U0, dtype, resolve_device(device))
    dev = U0.device
    n = U0.shape[0]
    dx = 2 * np.pi / n
    Cmax = float(np.sqrt(p.Cg**2 + p.f**2))
    Ka = torch.as_tensor(np.arange(n // 2, dtype=np.float64)
                         ** p.hyper_order, dtype=dtype, device=dev)
    iK = _ik(n, dtype, dev)
    dx_t = U0.new_full((), dx)
    nudx = p.nutune * dx**p.hyper_order
    Uk = _to_k(U0)
    Rm1 = Rm2 = None
    t = torch.zeros((), dtype=torch.float64, device=dev)
    xp = None if Xp0 is None else as_tensor(Xp0, dtype, dev)
    a1, a2, a3 = _AB3
    frames = []
    step_i = 0
    for _ in range(nsteps // save_every):
        for _ in range(save_every):
            U = _to_g(Uk, n)
            Rk = sw1_rhs(Uk, n, p, iK)
            if step_i == 0:
                Rm1 = Rm2 = Rk
            vmax = torch.clamp_min(torch.max(torch.abs(U[:, :2])), Cmax)
            dt = p.dttune * dx / vmax
            nu = nudx / dt
            up = 1.0 - 0.5 * dt * nu * Ka
            dn = 1.0 / (1.0 + 0.5 * dt * nu * Ka)
            ones = torch.ones_like(up)
            fup = torch.stack([up, up, ones], dim=1)
            fdn = torch.stack([dn, dn, ones], dim=1)
            Uk, Rm1, Rm2 = (fdn * (fup * Uk
                                   + dt * (a1 * Rk + a2 * Rm1 + a3 * Rm2)),
                            Rk, Rm1)
            if xp is not None:
                xp = advect1d(xp, U[:, 0], dx_t, dt)
            t = t + dt
            step_i += 1
        U = _to_g(Uk, n)
        H = 1.0 + U[:, 2]
        ke = torch.sum(0.5 * H * (U[:, 0] ** 2 + U[:, 1] ** 2))
        pe = torch.sum(0.5 * p.Cg**2 * H**2)
        frames.append((U, t, ke, pe, xp))
    Us, ts, kes, pes = (_stack_frames([fr[i] for fr in frames], like)
                        for i, like in enumerate((U0, t, U0[0, 0],
                                                  U0[0, 0])))
    xps = None if xp is None else _stack_frames([fr[4] for fr in frames],
                                                xp)
    return Us, ts, kes, pes, xps


def _rk3(yk, dt, rhs):
    """Williamson low-storage RK3 (sw1d.m:38, :77-81)."""
    c1, c2, c3, c4, c5 = _RK3
    rk = dt * rhs(yk)
    y1 = yk + c1 * rk
    r1 = dt * rhs(y1) - c2 * rk
    y2 = y1 + c3 * r1
    return y2 + c5 * (dt * rhs(y2) - c4 * r1)


def _fixed_dt_times(dt, save_every, nframes, device):
    return (dt * save_every) * torch.arange(1, nframes + 1,
                                            dtype=torch.float64,
                                            device=device)


def _run_rk3(Uk, dt, rhs, nsteps, save_every, diag):
    frames = []
    for _ in range(nsteps // save_every):
        for _ in range(save_every):
            Uk = _rk3(Uk, dt, rhs)
        frames.append(diag(Uk))
    return frames


def _big_forcing(n, V0, Kv, dtype, device):
    """V_x = -V0 sin(Kv x) on the 3/2 grid (sw1d.m)."""
    kmax = n // 2 - 1
    nbig = 2 * (3 * (kmax + 1) // 2 - 1 + 1)
    xb = np.linspace(0.0, 2 * np.pi, nbig, endpoint=False)
    return torch.as_tensor(-V0 * np.sin(Kv * xb), dtype=dtype,
                           device=device)


def sw1_forced(U0, Ro: float, Bu: float, V0: float, Kv: int, dt: float,
               nsteps: int, save_every: int = 1, *, device=None,
               dtype: torch.dtype = torch.float32):
    """Forced nondimensional 1-D RSW (sw1d.m:6-13):
        u_t = v - Bu h_x - Ro (u^2/2)_x
        v_t = -u - Ro u v_x - Ro u V_x
        h_t = -u_x - Ro (h u)_x
    with V_x = -V0 sin(Kv x), RK3 at fixed dt. Returns (U, t, ke, pe)
    frames."""
    U0 = as_tensor(U0, dtype, resolve_device(device))
    dev = U0.device
    n = U0.shape[0]
    iK = _ik(n, dtype, dev)
    VXb = _big_forcing(n, V0, Kv, dtype, dev)

    def rhs(Uk):
        pk = _rhs_products(Uk, iK, n, VXb)
        Ru = Uk[:, 1] - Bu * iK * Uk[:, 2] - 0.5 * Ro * iK * pk[:, 0]
        Rv = -Uk[:, 0] - Ro * pk[:, 1]
        Rh = -iK * Uk[:, 0] - Ro * iK * pk[:, 2]
        return torch.stack([Ru, Rv, Rh], dim=1)

    def diag(Uk):
        U = _to_g(Uk, n)
        H = 1.0 + U[:, 2]
        ke = torch.sum(0.5 * H * (U[:, 0] ** 2 + U[:, 1] ** 2))
        pe = torch.sum(0.5 * Bu * H**2)
        return U, ke, pe

    frames = _run_rk3(_to_k(U0), dt, rhs, nsteps, save_every, diag)
    nf = len(frames)
    Us, kes, pes = (_stack_frames([fr[i] for fr in frames], like)
                    for i, like in enumerate((U0, U0[0, 0], U0[0, 0])))
    return Us, _fixed_dt_times(dt, save_every, nf, dev), kes, pes


def sw1rk3nu(U0, Ro: float, Bu: float, nu: float, nsteps: int,
             save_every: int = 1, S: int = 4, dttune: float = 0.01, *,
             device=None, dtype: torch.dtype = torch.float32):
    """Nondimensional 1-D RSW with *explicit* hyperviscosity, RK3
    (rsw/sw1rk3nu.m:1-25):
        u_t = v - Bu h_x - Ro (u^2/2)_x - nu (-1)^S d^{2S}u/dx^{2S}
        v_t = -u - Ro u v_x             - nu (-1)^S d^{2S}v/dx^{2S}
        h_t = -u_x - Ro (h u)_x
    i.e. spectral damping -nu K^{2S} on u and v only.

    Reference quirk (reproduced, as in the JAX package): sw1rk3nu.m:52-54
    computes the "adaptive" vmax from `Ui`, which is never reassigned
    inside the loop — so dt is in fact CONSTANT, fixed by the initial
    condition: dt = dttune*2*pi/KMAX / max(sqrt(Bu+1), max|u0,v0|),
    computed once on the host from U0.

    Returns (U_frames (nf, nx, 3), t_frames, ke, pe)."""
    U0h = (U0.detach().cpu().numpy() if isinstance(U0, torch.Tensor)
           else np.asarray(U0))
    U0 = as_tensor(U0, dtype, resolve_device(device))
    dev = U0.device
    n = U0.shape[0]
    kmax = n // 2 - 1
    iK = _ik(n, dtype, dev)
    Kp = torch.as_tensor(np.arange(n // 2, dtype=np.float64) ** (2 * S),
                         dtype=dtype, device=dev)

    cgw = np.sqrt(Bu + 1.0)  # gravity-wave speed at k=1 (sw1rk3nu.m:49)
    vmax0 = float(np.maximum(
        cgw, np.sqrt(np.max(np.abs(U0h[:, 0]))**2
                     + np.max(np.abs(U0h[:, 1]))**2)))
    dt = dttune * 2.0 * np.pi / kmax / vmax0

    def rhs(Uk):
        pk = _rhs_products(Uk, iK, n)
        Ru = (Uk[:, 1] - Bu * iK * Uk[:, 2] - 0.5 * Ro * iK * pk[:, 0]
              - nu * Kp * Uk[:, 0])
        Rv = -Uk[:, 0] - Ro * pk[:, 1] - nu * Kp * Uk[:, 1]
        Rh = -iK * Uk[:, 0] - Ro * iK * pk[:, 2]
        return torch.stack([Ru, Rv, Rh], dim=1)

    # sw1rk3nu.m:62 divides by Ro^2 in PE; at Ro=0 (pure linear runs)
    # report the quadratic-in-h PE instead of the reference's Inf.
    pe_fac = 0.5 / Ro**2 if Ro != 0.0 else 0.5

    def diag(Uk):
        U = _to_g(Uk, n)
        H = 1.0 + Ro * U[:, 2]
        ke = torch.sum(0.5 * H * (U[:, 0] ** 2 + U[:, 1] ** 2))
        pe = torch.sum(pe_fac * (H**2 if Ro != 0.0 else U[:, 2] ** 2))
        return U, ke, pe

    frames = _run_rk3(_to_k(U0), dt, rhs, nsteps, save_every, diag)
    nf = len(frames)
    Us, kes, pes = (_stack_frames([fr[i] for fr in frames], like)
                    for i, like in enumerate((U0, U0[0, 0], U0[0, 0])))
    return Us, _fixed_dt_times(dt, save_every, nf, dev), kes, pes


def ybj1d(A0, Bu: float, V0: float, Kv: int, dt: float, nsteps: int,
          save_every: int = 1, *, device=None, dtype: torch.dtype = None):
    """YBJ NIW envelope A_T + (i/2)(V_x A - Bu A_xx) = 0 (ybj1d.m),
    complex A on the full spectrum, dealiased V_x A product, RK3.

    dtype None keeps the JAX package's rule: complex128 for complex128
    input, complex64 otherwise; a real or complex dtype names the
    precision. Returns (A_frames, t_frames)."""
    A0h = (A0.detach().cpu().numpy() if isinstance(A0, torch.Tensor)
           else np.asarray(A0))
    if dtype is None:
        cd = torch.complex128 if A0h.dtype == np.complex128 \
            else torch.complex64
    else:
        cd = dtype if dtype.is_complex else complex_dtype(dtype)
    device = resolve_device(device)
    A0 = torch.as_tensor(A0h, device=device).to(cd)
    rd = torch.float64 if cd == torch.complex128 else torch.float32
    n = A0.shape[0]
    kmax = n // 2 - 1
    kmaxbig = 3 * (kmax + 1) // 2 - 1
    nbig = 2 * (kmaxbig + 1)
    K = torch.as_tensor(np.concatenate([np.arange(kmax + 1),
                                        np.arange(-kmax - 1, 0)]),
                        dtype=rd, device=device)
    VXb = _big_forcing(n, V0, Kv, rd, device)
    gap = A0.new_zeros(nbig - n)

    def rhs(Ak):
        big = torch.cat([Ak[: kmax + 1], gap, Ak[kmax + 1:]])
        Ab = torch.fft.ifft(big) * nbig
        AVk = torch.fft.fft(Ab * VXb) / nbig
        AV = torch.cat([AVk[: kmax + 1], AVk[nbig - kmax - 1:]])
        return -0.5j * (AV + Bu * K**2 * Ak)

    frames = _run_rk3(torch.fft.fft(A0) / n, dt, rhs, nsteps, save_every,
                      lambda Ak: torch.fft.ifft(Ak) * n)
    return (_stack_frames(frames, A0),
            _fixed_dt_times(dt, save_every, len(frames), device))


def advect1d(xp, u, dx, dt):
    """RK4 particle advection with periodic linear interpolation of the
    gridded 1-D velocity (rsw/advect1d.m:1-10). `dx` divides as a 0-dim
    tensor (on a CUDA tensor a division by a Python float is a
    multiplication by its reciprocal, which can move a particle beside a
    cell edge into the other cell)."""
    n = u.shape[0]
    if not isinstance(dx, torch.Tensor):
        dx = xp.new_full((), dx)

    def vel(x):
        xi = torch.remainder(x / dx, n)
        i0 = torch.floor(xi)
        w = xi - i0
        i0 = i0.to(torch.int64)
        return (1.0 - w) * u[i0 % n] + w * u[(i0 + 1) % n]

    k1 = dt * vel(xp)
    k2 = dt * vel(xp + 0.5 * k1)
    k3 = dt * vel(xp + 0.5 * k2)
    k4 = dt * vel(xp + k3)
    return xp + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
