"""The I/O and on-device diagnostics of swraytracing_torch (io/binio,
io/runmeta, io/asyncwriter, io/checkpoint, analysis/device_diag) against
swraytracing_tpu on the same numpy inputs: files byte for byte,
checkpoints loaded across the packages, histogram counts exactly."""

import dataclasses
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swraytracing_tpu.analysis import device_diag as jdd
from swraytracing_tpu.io import binio as jbin
from swraytracing_tpu.io import checkpoint as jck
from swraytracing_tpu.io import runmeta as jrm
from swraytracing_tpu.models import coupled as jcp
from swraytracing_tpu.models import coupled2 as jc2
from swraytracing_torch.analysis import device_diag as tdd
from swraytracing_torch.io import binio as tbin
from swraytracing_torch.io import checkpoint as tck
from swraytracing_torch.io import runmeta as trm
from swraytracing_torch.io.asyncwriter import AsyncWriter
from swraytracing_torch.models import coupled as tcp
from swraytracing_torch.models import coupled2 as tc2

from torch_parity import to_torch, assert_equal, jax_carry_tree


def _frames(rng):
    """(name, [(frame, array)]) write sequences covering real grids,
    complex spectra, 0-d series, records, a frame past the end (gap) and
    an overwrite in place."""
    real = [(1, rng.standard_normal((6, 4))), (2, rng.standard_normal((6, 4))),
            (1, rng.standard_normal((6, 4))), (5, rng.standard_normal((6, 4)))]
    cplx = [(1, rng.standard_normal((7, 4)) + 1j * rng.standard_normal((7, 4))),
            (3, rng.standard_normal((7, 4)) + 1j * rng.standard_normal((7, 4)))]
    series = [(i + 1, np.asarray(0.25 * i)) for i in range(4)] + [(2, 9.5)]
    stack = [(1, rng.standard_normal((5, 3, 2)).astype(np.float32)),
             (2, np.arange(30).reshape(5, 3, 2))]
    records = [(1, np.asfortranarray(rng.standard_normal((8, 2)))),
               (2, rng.standard_normal((2, 8)).T)]
    return {"real": real, "cplx": cplx, "series": series, "stack": stack,
            "records": records}


def test_binio_files_byte_identical_and_cross_read(tmp_path):
    seqs = _frames(np.random.default_rng(0))
    for pkg, mod in (("jax", jbin), ("torch", tbin)):
        for name, seq in seqs.items():
            for frame, arr in seq:
                mod.write_field(arr, tmp_path / pkg / name, frame)
    for name in seqs:
        tb = (tmp_path / "torch" / f"{name}.bin").read_bytes()
        jb = (tmp_path / "jax" / f"{name}.bin").read_bytes()
        assert tb == jb, name
    shapes = {"real": (6, 4, 1, True), "cplx": (7, 4, 1, False),
              "stack": (5, 3, 2, True), "records": (8, 2, 1, True)}
    for name, (nx, ny, nz, real) in shapes.items():
        for reader, writer in ((tbin, "jax"), (jbin, "torch")):
            path = str(tmp_path / writer / name)
            n = tbin.frame_count(path, nx, ny, nz, is_real=real)
            assert n == jbin.frame_count(path, nx, ny, nz, is_real=real)
            frames = list(range(1, n + 1))
            got = reader.read_field(path, nx, ny, nz, frames, real)
            other = (jbin if reader is tbin else tbin).read_field(
                path, nx, ny, nz, frames, real)
            assert_equal(got, other)
    # the last write of each frame is what stands; the gap reads as zeros
    path = str(tmp_path / "torch" / "real")
    got = tbin.read_field(path, 6, 4, frames=[1, 3, 4, 5])
    assert_equal(got[..., 0], seqs["real"][2][1])
    assert not got[..., 1:3].any()
    assert_equal(got[..., 3], seqs["real"][3][1])
    cp = tbin.read_field(str(tmp_path / "jax" / "cplx"), 7, 4, frames=3)
    assert_equal(cp, seqs["cplx"][1][1])
    series = tbin.read_field(str(tmp_path / "jax" / "series"))
    assert_equal(series, [0.0, 9.5, 0.5, 0.75])
    assert tbin.frame_count(str(tmp_path / "none"), 4) == 0
    with pytest.raises(OSError, match="past the end"):
        tbin.read_field(path, 6, 4, frames=6)


def test_runmeta_text_equal(tmp_path):
    vals = dict(nx=512, n_packets=1048576, k_radius=6.0, dt=0.0061359,
                T=2083.3333333, spin_up=0.0033333, steps_per_save=10,
                packet_steps_per_save=25, f=3.0, Cg=1.0, U_g=0.4,
                U0=0.4000000001, Fr=0.4, Kd2=3.0)
    params = dict(nx=32, stepper="rk23", dt=0.1953125, omega_hist_log=True,
                  omega_hist_max=np.float64(384.0))
    for pkg, mod in (("jax", jrm), ("torch", trm)):
        rd = mod.RunDir(tmp_path / pkg)
        rd.write_run_log(**vals)
        rd.finish_run_log()
        rd.write_params(**params)
        rd.log_metrics(chunk=0, t=0.5, blow_up=False)
        rd.log_metrics(chunk=1, march_overflow=3, chunk_discarded=True)

    def text(pkg, name):
        return (tmp_path / pkg / name).read_text()

    def head(pkg):
        return [ln for ln in text(pkg, "run.log").splitlines()
                if not ln.startswith("Real time elapsed")]

    assert head("torch") == head("jax") and len(head("jax")) == 13
    assert "Real time elapsed" in text("torch", "run.log")
    for name in ("params.json", "metrics.jsonl"):
        assert text("torch", name) == text("jax", name)
    parsed = trm.parse_run_log(tmp_path / "torch" / "run.log")
    assert parsed == {k: v for k, v in jrm.parse_run_log(
        tmp_path / "jax" / "run.log").items() if k != "wall_seconds"} | {
            "wall_seconds": parsed["wall_seconds"]}
    assert parsed["n_packets"] == 1048576 and parsed["U0"] == 0.4
    rd = trm.RunDir(tmp_path / "torch")
    assert rd.read_params()["dt"] == 0.1953125
    assert [m["chunk"] for m in rd.read_metrics()] == [0, 1]


def test_async_writer_order_and_errors(tmp_path):
    path = str(tmp_path / "series")
    with AsyncWriter(maxsize=4) as w:
        for i in range(50):
            w.submit(tbin.write_field, float(i), path, i + 1)
        w.submit(tbin.write_field, -1.0, path, 7)      # after frame 7's write
        w.flush()
        assert_equal(tbin.read_field(path)[:8],
                     [0, 1, 2, 3, 4, 5, -1, 7])
    ran = []
    w = AsyncWriter()
    w.submit(ran.append, 1)
    w.submit(lambda: (_ for _ in ()).throw(ValueError("disk full")))
    w.submit(ran.append, 2)                            # skipped after a fault
    with pytest.raises(ValueError, match="disk full"):
        w.flush()
    with pytest.raises(ValueError, match="disk full"):  # sticky
        w.submit(ran.append, 3)
    with pytest.raises(ValueError, match="disk full"):
        w.close()
    assert ran == [1]
    assert not any(t.name == w._thread.name and t.is_alive()
                   for t in threading.enumerate())


def _carries(model, with_slots):
    """A JAX carry and the port's carry of the same configuration (nx=32,
    float64); with_slots: both window and overflow slots set (a march
    carry after prepare_carry_windows), else the drivers' checkpoint form
    with neither."""
    cfg = dict(nx=32, n_packets=32, window_min_np=1, T_Fr_days=20.0,
               packet_delay_days=0.05)
    if model == "qg2":
        js, jc = jc2.setup_coupled2(jc2.Coupled2Config(**cfg))
        ts, tc = tc2.setup_coupled2(tc2.Coupled2Config(**cfg), device="cpu",
                                    dtype=torch.float64)
    else:
        js, jc = jcp.setup_coupled(jcp.CoupledConfig(**cfg))
        ts, tc = tcp.setup_coupled(tcp.CoupledConfig(**cfg), device="cpu",
                                   dtype=torch.float64)
    if with_slots:
        jc = jcp.prepare_carry_windows(jc, False, js.march, 1)
        tc = tcp.prepare_carry_windows(tc, False, ts.march, 1)
        jc = jc.replace(overflow=jnp.asarray(3, jnp.int32))
    # make every leaf distinct from the setup's (t, step, the AB history)
    fs = jc.flow_state
    jc = jc.replace(flow_state=fs.replace(
        t=fs.t + 1.25, step=fs.step + 7, rhs_m1=fs.qk * (0.5 + 0.25j),
        rhs_m2=fs.qk * 2.0))
    return jc, tc


def _assert_carry_equal(tc, jc):
    tree = jax_carry_tree(jc)
    fs = tc.flow_state
    for name in ("qk", "rhs_m1", "rhs_m2"):
        assert_equal(getattr(fs, name), tree["flow_state"][name])
    assert fs.t == float(tree["flow_state"]["t"])
    assert fs.step == int(tree["flow_state"]["step"])
    assert type(fs.t) is float and type(fs.step) is int
    for name in ("packet_x", "packet_k", "prev_fields", "prev_win",
                 "overflow"):
        got = getattr(tc, name)
        if tree[name] is None:
            assert got is None, name
        else:
            assert_equal(got, tree[name], err_msg=name)


@pytest.mark.parametrize("with_slots", [False, True])
@pytest.mark.parametrize("model", ["qg1", "qg2"])
def test_checkpoint_cross_loads_exactly(tmp_path, model, with_slots):
    jc, tc = _carries(model, with_slots)
    # JAX -> port
    jpath = jck.save_state(tmp_path / "jax", jc, step=3)
    got = tck.restore_state(jpath, tc)
    _assert_carry_equal(got, jc)
    # port -> JAX: the port saves what it restored; JAX reads it back
    tpath = tck.save_state(tmp_path / "torch", got, step=3)
    assert tpath.endswith("torch_000000000003.npz")
    back = jck.restore_state(tpath, jc)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jc)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert_equal(np.asarray(a), np.asarray(b))
    # the two files hold the same leaves, same dtypes, same order
    with np.load(jpath) as j, np.load(tpath) as t:
        names = sorted(k for k in j.files if k.startswith("leaf_"))
        assert names == sorted(k for k in t.files if k.startswith("leaf_"))
        assert len(names) == (10 if with_slots else 8)
        for k in names:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
            assert_equal(t[k], j[k], err_msg=k)
        assert "__treedef__" in t.files
    assert tck.latest_checkpoint(tmp_path, "torch") == tpath


def test_restore_casts_to_the_like_and_keeps_file_shapes(tmp_path):
    jc, tc = _carries("qg2", False)
    path = jck.save_state(tmp_path / "ck", jc)
    like = dataclasses.replace(
        tc, packet_x=tc.packet_x.float(), packet_k=tc.packet_k.float(),
        prev_fields=torch.zeros(6, 32, 32))    # another nf: file shape wins
    got = tck.restore_state(path, like)
    assert got.packet_x.dtype == torch.float32
    assert got.flow_state.qk.dtype == torch.complex128
    assert got.prev_fields.shape == (2, 32, 32)
    assert_equal(got.packet_k, np.asarray(jc.packet_k).astype(np.float32))
    assert tck.latest_checkpoint(tmp_path / "nothing") is None


def _pk_samples():
    rng = np.random.default_rng(4)
    ring = np.sqrt(3.0) * 3.0 * np.stack(
        [np.cos(np.linspace(0, 2 * np.pi, 1000)),
         np.sin(np.linspace(0, 2 * np.pi, 1000))])   # omega = 2f exactly-ish
    wide = rng.standard_normal((2, 4000)) * 20.0
    return np.concatenate([ring, wide], axis=1)


@pytest.mark.parametrize("override", [None, "float", "tensor"])
@pytest.mark.parametrize("log_bins", [False, True])
def test_omega_hist_counts_equal_jax(log_bins, override):
    pk = _pk_samples()
    kw = dict(n_bins=300, omega_max=12.0, f=3.0, Cg=1.0,
              omega_min=3.0 if log_bins else 0.0, log_bins=log_bins)
    jspec, tspec = jdd.OmegaHistSpec(**kw), tdd.OmegaHistSpec(**kw)
    assert tuple(jspec) == tuple(tspec)
    np.testing.assert_array_equal(tdd.hist_edges(tspec), jdd.hist_edges(jspec))
    wmax = {None: None, "float": 40.0, "tensor": 40.0}[override]
    tw = torch.tensor(40.0, dtype=torch.float64) if override == "tensor" \
        else wmax
    jw = jnp.asarray(40.0) if override == "tensor" else wmax
    got = tdd.omega_hist_counts(to_torch(pk), tspec, omega_max=tw)
    want = jdd.omega_hist_counts(jnp.asarray(pk), jspec, omega_max=jw)
    assert got.shape == (301,) and got.dtype == torch.float64
    assert_equal(got, want)
    assert float(got.sum()) == pk.shape[1]
    # numpy's histogram on the same edges agrees, away from the ring (whose
    # omega = 2f lies on an edge, which numpy's edges round otherwise)
    wide = pk[:, 1000:]
    edges = tdd.hist_edges(tspec._replace(omega_max=wmax or 12.0))
    om = np.sqrt(9.0 + (wide ** 2).sum(0))
    ref = np.histogram(om, np.append(edges, np.inf))[0]
    got = tdd.omega_hist_counts(to_torch(wide), tspec, omega_max=tw)
    assert np.abs(got.numpy() - ref).sum() <= 2


def test_omega_hist_counts_float32():
    pk = _pk_samples().astype(np.float32)
    spec = tdd.OmegaHistSpec(n_bins=64, omega_max=384.0, f=3.0, Cg=1.0,
                             omega_min=3.0, log_bins=True)
    got = tdd.omega_hist_counts(to_torch(pk), spec)
    assert got.dtype == torch.float32 and float(got.sum()) == pk.shape[1]
    jspec = jdd.OmegaHistSpec(**spec._asdict())
    assert_equal(got, jdd.omega_hist_counts(jnp.asarray(pk), jspec))


def test_isospectrum_and_kinetic_energy_spectrum_match_jax():
    from swraytracing_tpu.analysis import spectra as jsp
    from swraytracing_tpu.models.qg import initial_q_ring
    from swraytracing_tpu.ops import spectral as jsp_ops
    from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
    from swraytracing_torch.analysis import spectra as tsp
    from swraytracing_torch.ops import spectral as tsp_ops
    from swraytracing_torch.ops.grid import SpectralGrid as TGrid

    for nx, ny in ((64, 64), (32, 48)):
        jg, tg = JGrid(nx, ny, 2 * np.pi, 2 * np.pi), TGrid(nx, ny, 2 * np.pi,
                                                            2 * np.pi)
        dens = np.random.default_rng(nx).random((nx, ny // 2 + 1))
        want = np.asarray(jax.jit(lambda a: jsp_ops.isospectrum(a, jg))(dens))
        got = tsp_ops.isospectrum(to_torch(dens), tg)
        assert got.shape == (tg.kmax,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    grid, tgrid = JGrid.square(64), TGrid.square(64)
    q = np.asarray(jsp_ops.to_grid(initial_q_ring(7, grid, 0.4, 3.0), grid))
    want = jsp.kinetic_energy_spectrum(q, grid, 3.0)
    got = tsp.kinetic_energy_spectrum(q, tgrid, 3.0, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-20)
    assert got[4:8].sum() > 0.98 * got.sum()          # the seeded ring
    qk = tsp_ops.to_spectral(to_torch(q), tgrid)
    np.testing.assert_allclose(tsp.kinetic_energy_spectrum(qk, tgrid, 3.0),
                               got, rtol=1e-12, atol=1e-20)
