"""swraytracing_torch.models.cgrid against the JAX package on the same
numpy inputs (CPU, float64): the staggered operators, swp with walls, beta
and topography and periodic, the restart clock, and swp_to_files' files.

The C-grid model is elementwise arithmetic, rolls and reductions. Applied
one operation at a time the two packages agree bit for bit: the port's
RHS equals the JAX package's with jit disabled, and so do swp_to_files'
files, byte for byte. The JAX package's compiled run fuses the elementwise
arithmetic (and contracts multiply-adds), so the port's frames agree with
it to ATOL_FRAMES."""

import filecmp

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from swraytracing_tpu.models import cgrid as jc
from swraytracing_torch.models import cgrid as tc

from torch_parity import assert_close, assert_equal

N = 32
L = 2 * np.pi
DX = L / N
ATOL_FRAMES = 1e-12


def _fields():
    x = np.arange(N) * DX
    X, Y = np.meshgrid(x, x, indexing="ij")
    h0 = 0.05 * np.exp(-((X - 3) ** 2 + (Y - 3) ** 2))
    u0 = 0.02 * np.sin(Y)
    v0 = 0.01 * np.cos(X)
    hb = 0.1 * np.cos(X) * np.cos(Y)
    return u0, v0, h0, hb


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("d", [0, 1])
def test_avg_dif_laplacian_exact(periodic, d):
    f = np.random.default_rng(0).standard_normal((N, N - 3))
    src = torch.tensor(f)
    for shift in (False, True):
        for endoff in (False, True):
            kw = dict(periodic=periodic, shift=shift, endoff=endoff)
            assert_equal(tc.avg(src, d, **kw), jc.avg(jnp.asarray(f), d, **kw))
            assert_equal(tc.dif(src, d, **kw), jc.dif(jnp.asarray(f), d, **kw))
    assert_equal(src, f)                       # nothing written in place
    assert_equal(tc.laplacian(src, 0.3, 0.4, periodic, not periodic),
                 jc.laplacian(jnp.asarray(f), 0.3, 0.4, periodic,
                              not periodic))


def test_rhs_bitwise_against_uncompiled_jax():
    u0, v0, h0, hb = _fields()
    p = tc.SWPParams(Roi=1.0, Beta=0.5, Cg=1.0, Nu=0.01, Drag=0.02,
                     periody=False)
    jp = jc.SWPParams(*p)
    fu, fv = jc._coriolis(jp, N, DX)
    with jax.disable_jit():
        want = jc.swp_rhs(*(jnp.asarray(a) for a in (u0, v0, h0, hb)), jp,
                          DX, DX, 0.01, fu, fv)
    args = [torch.tensor(a) for a in (u0, v0, h0, hb)]
    held = [a.clone() for a in args]
    got = tc.swp_rhs(*args, p, DX, DX, 0.01,
                     *tc._coriolis(p, N, DX, args[0]))
    for g, w in zip(got, want):
        assert_equal(g, w)
    for a, b in zip(args, held):
        assert torch.equal(a, b)               # nothing written in place


@pytest.mark.parametrize("case", ["walls_beta_topo", "periodic_forced",
                                  "walls_x_geovel"])
def test_swp_parity(case):
    u0, v0, h0, hb = _fields()
    kw = dict(nt=60, save_every=20)
    if case == "walls_beta_topo":
        p = tc.SWPParams(Roi=1.0, Beta=0.5, Cg=1.0, Nu=0.01, periody=False)
        kw.update(hb=hb)
    elif case == "periodic_forced":
        p = tc.SWPParams(Roi=1.0, Cg=1.0, Drag=0.01, Hdot=0.001, Nu=0.02)
    else:
        p = tc.SWPParams(Roi=2.0, Cg=1.0, periodx=False, dttune=0.1)
        kw.update(hb=hb, geovel=True, t0=3.5)
    got = tc.swp(u0, v0, h0, p, device="cpu", **kw)
    want = jc.swp(u0, v0, h0, jc.SWPParams(*p), **kw)
    for name, g, w in zip(("u", "v", "h", "t", "ke", "ape", "htot"), got,
                          want):
        assert g.dtype == torch.float64
        assert_close(g, w, atol=ATOL_FRAMES, err_msg=name)
    assert got[0].shape == (3, N, N)


def test_swp_restart_clock_and_mass():
    """Periodic, no forcing: the total depth holds to round-off; a run in
    two halves (t0 from the first) ends where the whole run ends."""
    u0, v0, h0, _ = _fields()
    p = tc.SWPParams(Roi=1.0, Cg=1.0)
    us, vs, hs, ts, _, _, htot = tc.swp(u0, v0, h0, p, nt=40, save_every=20,
                                        device="cpu")
    np.testing.assert_allclose(htot.numpy(), htot[0].item(), rtol=1e-13)
    a = tc.swp(u0, v0, h0, p, nt=20, save_every=20, device="cpu")
    b = tc.swp(a[0][-1], a[1][-1], a[2][-1], p, nt=20, save_every=20,
               t0=float(a[3][-1]), device="cpu")
    assert_close(b[2][-1], hs[-1], atol=1e-15)
    assert float(b[3][-1]) == pytest.approx(float(ts[-1]), rel=1e-15)


def test_swp_to_files_bytes(tmp_path):
    """Every file of swp_to_files (u, v, h, zeta, q, time; two frames,
    then two more appended from the restart) byte for byte as the JAX
    package's uncompiled run writes it; the returned restart and
    diagnostics as its compiled run's, to ATOL_FRAMES."""
    u0, v0, h0, hb = _fields()
    p = tc.SWPParams(Roi=1.0, Beta=0.5, Cg=1.0, periody=False)
    jp = jc.SWPParams(*p)
    kw = dict(hb=hb, nt=40, save_every=20, geovel=True, idstring="_run")
    with jax.disable_jit():
        jr, _ = jc.swp_to_files(u0, v0, h0, tmp_path / "jax", jp, **kw)
        jc.swp_to_files(jr["u"], jr["v"], jr["h"], tmp_path / "jax", jp,
                        hb=hb, nt=40, save_every=20, idstring="_run",
                        frame0=jr["frame"], t0=jr["time"])
    tr, tdiag = tc.swp_to_files(u0, v0, h0, tmp_path / "torch", p,
                                device="cpu", **kw)
    assert tr["frame"] == 2 and isinstance(tr["u"], np.ndarray)
    tc.swp_to_files(tr["u"], tr["v"], tr["h"], tmp_path / "torch", p,
                    hb=hb, nt=40, save_every=20, idstring="_run",
                    frame0=tr["frame"], t0=tr["time"], device="cpu")
    names = sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "torch").iterdir())
    assert len(names) == 6
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "torch" / name,
                           shallow=False), name
    assert (tmp_path / "torch" / "h_run.bin").stat().st_size == 4 * N * N * 8
    want_r, want_d = jc.swp_to_files(u0, v0, h0, tmp_path / "jit", jp, **kw)
    for key in ("u", "v", "h"):
        assert_close(tr[key], want_r[key], atol=ATOL_FRAMES)
    assert tr["time"] == want_r["time"]
    for key in ("t", "ke", "ape", "htot"):
        assert_close(tdiag[key], want_d[key], atol=ATOL_FRAMES)


def test_diagnostic_operators_parity():
    u0, v0, h0, hb = _fields()
    p = tc.SWPParams(Roi=1.0, Beta=0.3, Cg=1.0, periodx=False)
    jp = jc.SWPParams(*p)
    tu, tv, tH = (torch.tensor(a) for a in (u0, v0, h0 + 1.0))
    ju, jv, jH = (jnp.asarray(a) for a in (u0, v0, h0 + 1.0))
    assert_close(tc.cgrid_pv(tu, tv, tH, p, DX, DX),
                 jc.cgrid_pv(ju, jv, jH, jp, DX, DX), atol=1e-13)
    for g, w in zip(tc.geostrophic_velocities(tH, p, DX, DX),
                    jc.geostrophic_velocities(jH, jp, DX, DX)):
        assert_close(g, w, atol=1e-14)
    assert_close(tc.cgrid_divergence(tu, tv, p, DX, DX),
                 jc.cgrid_divergence(ju, jv, jp, DX, DX), atol=1e-14)


def test_swp_float32():
    u0, v0, h0, hb = _fields()
    out = tc.swp(u0, v0, h0, tc.SWPParams(Roi=1.0, Cg=1.0), hb=hb, nt=4,
                 save_every=2, device="cpu", dtype=torch.float32)
    assert all(a.dtype == torch.float32 for i, a in enumerate(out) if i != 3)
    assert out[3].dtype == torch.float64
