"""swraytracing_torch.models.analytic, fields.AnalyticFlow, the FlowEval
diagnostics and rays.RayState against the JAX package on the same numpy
inputs (CPU, float64), and the frozen-flow configurations of the JAX
package's tests/test_frozen.py through the analytic flows."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swraytracing_tpu.models import analytic as jan
from swraytracing_tpu.models import frozen as jfz
from swraytracing_tpu.models import rays as jrays
from swraytracing_tpu.models.dispersion import Dispersion as JDispersion
from swraytracing_torch.models import analytic as tan
from swraytracing_torch.models import fields as tfl
from swraytracing_torch.models import frozen as tfz
from swraytracing_torch.models import rays as trays
from swraytracing_torch.models.dispersion import Dispersion as TDispersion

from torch_parity import to_jax, to_torch, to_numpy, assert_close

JD, TD = JDispersion(f=3.0, Cg=1.0), TDispersion(f=3.0, Cg=1.0)
F64 = dict(device="cpu", dtype=torch.float64)

# closed-form derivatives of O(0.1..1) streamfunctions, evaluated the same
# way on both sides: a few ulp apart
RTOL = 1e-12
ATOL = 1e-14

FACTORIES = [
    ("childress_soward", dict(U0=0.2, km=1.5, a=0.3, c=0.4, t=0.7)),
    ("cellular", dict(A=0.8, t=0.2)),
    ("vorticity_well", dict(A=0.3, sigma=1.2, x0=2.5, y0=3.5)),
]


def _points(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 2 * np.pi + 1.0, (2, n))


@pytest.mark.parametrize("name,kw", FACTORIES)
def test_flow_eval_matches_jax(name, kw):
    p = _points()
    jflow = getattr(jan, name)(**kw)
    tflow = getattr(tan, name)(**kw, **F64)
    assert isinstance(tflow, tfl.AnalyticFlow)
    assert set(tflow.params) == set(jflow.params)
    for v in tflow.params.values():
        assert v.dim() == 0 and v.dtype == torch.float64
    je = jflow.at(to_jax(p[0]), to_jax(p[1]))
    te = tflow.at(to_torch(p[0]), to_torch(p[1]))
    assert te._fields == je._fields
    for got, want in zip(te, je):
        assert_close(got, want, rtol=RTOL, atol=ATOL)
    ju, jv = jflow.velocity_at(to_jax(p[0]), to_jax(p[1]))
    tu, tv = tflow.velocity_at(to_torch(p[0]), to_torch(p[1]))
    assert_close(tu, ju, rtol=RTOL, atol=ATOL)
    assert_close(tv, jv, rtol=RTOL, atol=ATOL)
    assert_close(tflow.streamfunction(to_torch(p[0]), to_torch(p[1])),
                 jflow.streamfunction(to_jax(p[0]), to_jax(p[1])),
                 rtol=RTOL, atol=ATOL)
    # a forward evaluation builds no graph
    assert not te.u.requires_grad and not tu.requires_grad


@pytest.mark.parametrize("name,kw", FACTORIES)
def test_flow_eval_diagnostics_match_jax(name, kw):
    p = _points(seed=1)
    je = getattr(jan, name)(**kw).at(to_jax(p[0]), to_jax(p[1]))
    te = getattr(tan, name)(**kw, **F64).at(to_torch(p[0]), to_torch(p[1]))
    for prop in ("vorticity", "strain", "okubo_weiss", "uv"):
        assert_close(getattr(te, prop), getattr(je, prop), rtol=RTOL,
                     atol=ATOL, err_msg=prop)
    k = np.random.default_rng(2).standard_normal((2, p.shape[1]))
    assert_close(te.refraction(to_torch(k)), je.refraction(to_jax(k)),
                 rtol=RTOL, atol=ATOL)


def test_cs_params_and_defaults():
    assert tan.CS_PARAMS == jan.CS_PARAMS
    flow = tan.childress_soward(device="cpu")
    assert flow.params["U0"].dtype == torch.float32
    assert {k: float(v) for k, v in flow.params.items()} == pytest.approx(
        tan.CS_PARAMS)
    assert flow.t == 0.0


def test_ray_state_is_the_named_tuple():
    assert trays.RayState._fields == jrays.RayState._fields == ("x", "k", "a")
    st = trays.RayState(torch.zeros(2, 3), torch.ones(2, 3))
    assert st.a is None and st._replace(a=torch.ones(3)).a.shape == (3,)
    assert "RayState" in trays.__all__


def _ics(n=6, seed=3):
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    return (rng.uniform(0, 2 * np.pi, (2, n)),
            8.0 * np.stack([np.cos(ang), np.sin(ang)], 0))


def test_packet_functional_gradient_wrt_U0_matches_jax():
    """d/dU0 (and d/dk0) of a packet functional after 40 symplectic steps
    through the Childress–Soward flow: the port's autograd through the
    autograd-derived velocities against jax.grad, rtol 1e-10."""
    x0, k0 = _ics()
    dt, n = 0.01, 40

    def jloss(U0, k):
        fl = jan.childress_soward(U0=U0, a=0.3)
        step = lambda x, kk, t: jrays.symplectic_step(x, kk, dt, JD, fl)
        xs, ks, _ = jrays.integrate_rays(to_jax(x0), k, dt, n, step,
                                         save_every=n)
        return jnp.mean(ks[-1] ** 2) + jnp.mean(jnp.sin(xs[-1]) ** 2)

    jgU, jgk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(0.15),
                                                to_jax(k0))
    U0 = torch.tensor(0.15, dtype=torch.float64, requires_grad=True)
    k = to_torch(k0).requires_grad_(True)
    fl = tan.childress_soward(U0=U0, a=0.3, **F64)
    step = lambda x, kk, t: trays.symplectic_step(x, kk, dt, TD, fl)
    xs, ks, _ = trays.integrate_rays(to_torch(x0), k, dt, n, step,
                                     save_every=n)
    loss = (ks[-1] ** 2).mean() + (torch.sin(xs[-1]) ** 2).mean()
    gU, gk = torch.autograd.grad(loss, (U0, k))
    assert_close(gU, jgU, rtol=1e-10)
    assert_close(gk, jgk, rtol=1e-10, atol=1e-14)
    assert float(gU) != 0.0


def test_config1_zero_background():
    """Config 1 (tests/test_frozen.py): U=0 — Omega_abs conserved exactly;
    omega == omega_abs; the same frames as JAX."""
    flow = tan.childress_soward(U0=0.0, **F64)
    x0, k0 = tfz.ring_ics(4, 2.0, TD, **F64)
    res = tfz.raytrace_frozen(flow, x0, k0, TD, 0.01, 200, 100)
    assert float(res.conservation_error.max()) < 1e-12
    np.testing.assert_allclose(to_numpy(res.omega), to_numpy(res.omega_abs),
                               rtol=1e-12)
    jx0, jk0 = jfz.ring_ics(4, 2.0, JD)
    want = jfz.raytrace_frozen(jan.childress_soward(U0=0.0), jx0, jk0, JD,
                               0.01, 200, 100)
    assert_close(res.x, want.x, atol=1e-12)
    assert_close(res.k, want.k, atol=1e-12)


def test_config2_vorticity_well_histogram():
    """Config 2 (tests/test_frozen.py): steady vorticity-well flow, omega
    spreads but Omega_abs is conserved (symplectic); rk4 ranks better on
    the invariant. The port's frames equal JAX's to 1e-9 after 2000
    steps."""
    flow = tan.vorticity_well(A=0.3, sigma=1.2, **F64)
    x0, k0 = tfz.ring_ics(64, 2.0, TD, seed=7, **F64)
    res = tfz.raytrace_frozen(flow, x0, k0, TD, 0.005, 2000, 500)
    err = float(res.conservation_error[-1])
    assert err < 5e-3, err
    assert float(res.omega[-1].std()) > 1e-3
    res_rk = tfz.raytrace_frozen(flow, x0, k0, TD, 0.005, 2000, 500,
                                 stepper="rk4")
    assert float(res_rk.conservation_error[-1]) < 1e-5
    jx0, jk0 = jfz.ring_ics(64, 2.0, JD, seed=7)
    want = jfz.raytrace_frozen(jan.vorticity_well(A=0.3, sigma=1.2), jx0,
                               jk0, JD, 0.005, 2000, 500)
    assert_close(res.x, want.x, atol=1e-9)
    assert_close(res.k, want.k, atol=1e-9)
    assert_close(res.conservation_error, want.conservation_error, atol=1e-11)
