"""Shared helpers of the tests/test_torch_*.py files: the same numpy
inputs go to the JAX package (CPU, x64; tests/conftest.py sets both) and
to swraytracing_torch (CPU, float64), and the outputs are compared as
numpy arrays."""

import numpy as np
import jax.numpy as jnp
import torch

# tier-1 runs several xdist workers on few cores: one thread per worker
torch.set_num_threads(1)

NX = 32
L = 2.0 * np.pi


def to_jax(a):
    return jnp.asarray(np.asarray(a))


def to_torch(a):
    """numpy -> CPU tensor of the same precision (float64/complex128
    inputs stay so)."""
    return torch.from_numpy(np.array(a))  # a writable copy


def to_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close(got_torch, want_jax, rtol=0.0, atol=0.0, err_msg=""):
    got, want = to_numpy(got_torch), to_numpy(want_jax)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


def assert_equal(got_torch, want_jax, err_msg=""):
    got, want = to_numpy(got_torch), to_numpy(want_jax)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_array_equal(got, want, err_msg=err_msg)


def smooth_fields(rng, n, nx=NX):
    """n smooth random (nx, nx) fields, so interpolation is
    well-conditioned."""
    def smooth():
        f = rng.standard_normal((nx, nx))
        fk = np.fft.rfft2(f)
        kx = np.fft.fftfreq(nx)[:, None]
        ky = np.fft.rfftfreq(nx)[None, :]
        fk *= np.exp(-((kx * nx / 6) ** 2 + (ky * nx / 6) ** 2))
        return np.fft.irfft2(fk, s=(nx, nx))

    return np.stack([smooth() for _ in range(n)])


def random_spectrum(rng, grid, batch=()):
    """Spectrum of a random real field (Hermitian by construction,
    Nyquist modes masked), as numpy complex128 in the rfft2 layout."""
    f = rng.standard_normal(tuple(batch) + (grid.nx, grid.ny))
    return np.fft.rfft2(f) / (grid.nx * grid.ny) * grid.nyquist_mask


def jax_carry_tree(c):
    """A JAX CoupledCarry as the plain dict of numpy arrays that
    swraytracing_torch.convert.carry_from_numpy takes."""
    fs = c.flow_state
    return {
        "flow_state": {"qk": np.asarray(fs.qk), "rhs_m1": np.asarray(fs.rhs_m1),
                       "rhs_m2": np.asarray(fs.rhs_m2), "t": np.asarray(fs.t),
                       "step": np.asarray(fs.step)},
        "packet_x": np.asarray(c.packet_x),
        "packet_k": np.asarray(c.packet_k),
        "prev_fields": np.asarray(c.prev_fields),
        "prev_win": None if c.prev_win is None else np.asarray(c.prev_win),
        "overflow": None if c.overflow is None else np.asarray(c.overflow),
    }


# The gradient tests' chunk: 4 flow steps of 64 packets at nx=32, released
# after the first, on each packet path.
GRAD_CFG = dict(nx=32, n_packets=64, T_Fr_days=30.0, packet_delay_days=0.05,
                packet_steps_per_save=2)
GRAD_PATHS = {
    "march": dict(window_min_np=1),
    "windowed": dict(window_min_np=1, fused_march=False),
    "stencil": dict(window_min_np=10 ** 6, fused_march=False),
}
GRAD_N_SAVES = 2
# float64 through FFTs and thousands of multiply-adds, gradients O(1..100)
GRAD_RTOL_JAX = 1e-9


def assert_grads_close(got, want):
    """The port's (g_qk, g_k) against JAX's: g_qk == conj(g_qk_jax)
    (PyTorch's gradient w.r.t. a complex input is the conjugate of
    jax.grad's), rtol GRAD_RTOL_JAX over the whole spectrum; and neither
    gradient is zero."""
    g_qk, g_k = got
    j_qk, j_k = want
    np.testing.assert_allclose(g_qk, np.conj(j_qk), rtol=GRAD_RTOL_JAX,
                               atol=GRAD_RTOL_JAX * np.abs(j_qk).max())
    np.testing.assert_allclose(g_k, j_k, rtol=GRAD_RTOL_JAX,
                               atol=GRAD_RTOL_JAX * np.abs(j_k).max())
    assert np.abs(g_qk).max() > 0 and np.abs(g_k).max() > 0


def chunk_loss(c2):
    """The packet functional the gradient tests differentiate: it sees
    every packet's final wavevector and position."""
    lib = torch if isinstance(c2.packet_k, torch.Tensor) else jnp
    return (lib.sum(c2.packet_k ** 2) + lib.sum(lib.sin(c2.packet_x)))


def jax_chunk_grads(run, s, cfg, carry, n_saves, remat=False):
    """jax.grad of chunk_loss after run(carry, s, cfg, n_saves) w.r.t. the
    initial PV spectrum and packet wavevectors: (g_qk, g_k) as numpy."""
    import jax

    def loss(qk, pk):
        c = carry.replace(flow_state=carry.flow_state.replace(qk=qk),
                          packet_k=pk)
        c2, _ = run(c, s, cfg, n_saves, remat=remat)
        return chunk_loss(c2)

    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(carry.flow_state.qk,
                                                carry.packet_k)
    return tuple(np.asarray(a) for a in g)


def torch_chunk_loss(run, s, cfg, carry, n_saves, qk, pk, remat=False):
    import dataclasses
    c = dataclasses.replace(
        carry, flow_state=dataclasses.replace(carry.flow_state, qk=qk),
        packet_k=pk)
    c2, _ = run(c, s, cfg, n_saves, remat=remat)
    return chunk_loss(c2)


def torch_chunk_grads(run, s, cfg, carry, n_saves, remat=False):
    """The port's gradients of the same loss by autograd: (g_qk, g_k) as
    numpy. For the complex qk PyTorch's gradient is the complex conjugate
    of jax.grad's."""
    qk = carry.flow_state.qk.detach().clone().requires_grad_(True)
    pk = carry.packet_k.detach().clone().requires_grad_(True)
    loss = torch_chunk_loss(run, s, cfg, carry, n_saves, qk, pk, remat)
    return tuple(to_numpy(g) for g in torch.autograd.grad(loss, (qk, pk)))


def check_chunk_gradients(jmod, tmod, model, path_kw, remat=True):
    """Set up `model` ("coupled" or "coupled2") from GRAD_CFG with path_kw
    in both packages (the port on the CPU in float64), and hold the port's
    chunk gradients against jax.grad's (assert_grads_close) and, with
    remat, the rematerialised chunk's against the plain one's (rtol 1e-10,
    atol 1e-12 of the largest). Returns the port's setup and gradients."""
    one = model == "coupled"
    cfg = dict(GRAD_CFG, **path_kw)
    JCfg = jmod.CoupledConfig if one else jmod.Coupled2Config
    TCfg = tmod.CoupledConfig if one else tmod.Coupled2Config
    jsetup = jmod.setup_coupled if one else jmod.setup_coupled2
    tsetup = tmod.setup_coupled if one else tmod.setup_coupled2
    jrun = jmod.run_coupled_chunk if one else jmod.run_coupled2_chunk
    trun = tmod.run_coupled_chunk if one else tmod.run_coupled2_chunk
    js, jc = jsetup(JCfg(**cfg))
    ts, tc = tsetup(TCfg(**cfg), device="cpu", dtype=torch.float64)
    want = jax_chunk_grads(jrun, js, JCfg(**cfg), jc, GRAD_N_SAVES)
    got = torch_chunk_grads(trun, ts, TCfg(**cfg), tc, GRAD_N_SAVES)
    assert_grads_close(got, want)
    if remat:
        again = torch_chunk_grads(trun, ts, TCfg(**cfg), tc, GRAD_N_SAVES,
                                  remat=True)
        for r, g in zip(again, got):
            np.testing.assert_allclose(r, g, rtol=1e-10,
                                       atol=1e-12 * np.abs(g).max())
    return ts, got
