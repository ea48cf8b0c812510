"""The production drivers of swraytracing_torch against those of
swraytracing_tpu: the same arguments go to both packages (the port on the
CPU in float64, JAX in x64), in the configurations of tests/test_drivers.py,
and the run directories they write are compared file by file."""

import json
import shutil

import numpy as np
import pytest
import torch

from swraytracing_tpu import drivers as jdr
from swraytracing_torch import drivers as tdr
from swraytracing_torch.analysis import spectra
from swraytracing_torch.io import binio, runmeta

import torch_parity  # noqa: F401  (one torch thread per worker)

ATOL_FRAMES = 1e-10
RTOL_PARAMS = 1e-12
PORT = dict(device="cpu", dtype=torch.float64)

QGSW = dict(nx=32, Npackets=8, T_Fr_days=30.0, packet_delay_days=0.1,
            verbose=False)
HIST = dict(nx=32, Npackets=16, T_Fr_days=30.0, packet_delay_days=0.1,
            verbose=False, max_steps=100)
MARGIN = dict(nx=32, Npackets=8, near_inertial_factor=2.0, T_Fr_days=30.0,
              packet_delay_days=0.0, Cg=30.0, max_steps=20,
              checkpoint_every=0, verbose=False, window_min_np=1,
              fused_march=True)
NF = dict(nx=32, Npackets=8, T_Fr_days=30.0, packet_delay_days=0.1,
          verbose=False, window_min_np=1, fused_march=True)
# the JAX configuration at 20 steps instead of 300 (each recheck costs
# the JAX driver a compile): two chunks, each followed by a recheck that
# rebuilds dt, the operators and the march; the second chunk runs on the
# first rebuild
RECHECK = dict(nx=32, Npackets=8, T_Fr_days=10.0, packet_delay_days=0.01,
               U_g=0.4, shear=0.0, r=3.0, max_steps=20, checkpoint_every=0,
               verbose=True, window_min_np=1, steps_per_save=10,
               packet_steps_per_save=5)


def _bins(run_dir):
    return sorted(p.name for p in run_dir.glob("*.bin"))


def assert_same_run(tdir, jdir, exact=("omega_hist",)):
    """Every .bin file (frames at ATOL_FRAMES; histogram counts exactly),
    params.json (same keys, numbers at RTOL_PARAMS), run.log (equal text
    apart from the wall time) and the chunk/flag record of metrics.jsonl."""
    assert _bins(tdir) == _bins(jdir)
    for name in _bins(jdir):
        got = np.fromfile(tdir / name)
        want = np.fromfile(jdir / name)
        assert got.shape == want.shape, name
        if name[:-4] in exact:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FRAMES,
                                       err_msg=name)
    tp, jp = (json.loads((d / "params.json").read_text())
              for d in (tdir, jdir))
    assert tp.keys() == jp.keys()
    for key, want in jp.items():
        if isinstance(want, (int, float)) and not isinstance(want, bool):
            assert tp[key] == pytest.approx(want, rel=RTOL_PARAMS), key
        else:
            assert tp[key] == want, key

    # run.log prints six decimals: a value a rounding error from a tie
    # (dt = 0.1953125 at nx=32 two-layer) may print one unit apart. An
    # ensemble sweep's base directory has none, in both packages.
    assert (tdir / "run.log").exists() == (jdir / "run.log").exists()
    if (jdir / "run.log").exists():
        tl, jl = (runmeta.parse_run_log(d / "run.log") for d in (tdir, jdir))
        assert tl.keys() == jl.keys()
        for key, want in jl.items():
            if key != "wall_seconds":
                assert tl[key] == pytest.approx(want, rel=0,
                                                abs=1.0001e-6), key

    def record(d):
        keep = ("chunk", "steps", "blow_up", "march_overflow",
                "chunk_discarded")
        return [{k: m[k] for k in keep if k in m}
                for m in runmeta.RunDir(d).read_metrics()]

    assert record(tdir) == record(jdir)


def _both(tmp, name, jfn, tfn, **kw):
    jdir, tdir = tmp / f"jax-{name}", tmp / f"torch-{name}"
    jres = jfn(out_dir=jdir, **kw)
    tres = tfn(out_dir=tdir, **kw, **PORT)
    return jdir, tdir, jres, tres


@pytest.fixture(scope="module")
def qgsw_runs(tmp_path_factory):
    """The one-layer reference configuration at nx=32: 100 steps with a
    checkpoint every chunk by both packages, and an uninterrupted 150-step
    JAX run."""
    tmp = tmp_path_factory.mktemp("qgsw")
    jdir, tdir, jres, tres = _both(tmp, "100", jdr.qgsw_raytrace,
                                   tdr.qgsw_raytrace, max_steps=100,
                                   checkpoint_every=1, **QGSW)
    j150 = tmp / "jax-150"
    jdr.qgsw_raytrace(out_dir=j150, max_steps=150, checkpoint_every=1,
                      **QGSW)
    return tmp, jdir, tdir, tres, j150


def test_qgsw_raytrace_matches_jax(qgsw_runs):
    tmp, jdir, tdir, (carry, rd), _ = qgsw_runs
    assert carry.prev_win is None and carry.overflow is None  # per stage
    assert_same_run(tdir, jdir)
    # the port's analysis loads what its driver wrote
    x, k, t, params = spectra.load_packets(tdir)
    assert params["nx"] == 32 and params["n_packets"] == 8
    assert x.shape[1:] == (8, 2) and x.shape[0] == len(t) == 21
    om = spectra.omega_of_k(k, params["f"], params["Cg"])
    assert spectra.energy_vs_omega(om[-1])[1].sum() > 0
    q = binio.read_field(str(tdir / "pv"), 32, 32, frames=[1, 2, 3])
    assert q.shape == (32, 32, 3) and np.isfinite(q).all()
    log = runmeta.parse_run_log(tdir / "run.log")
    assert log["nx"] == 32 and "wall_seconds" in log
    m = rd.read_metrics()
    assert len(m) == 2 and m[-1]["packet_steps_per_sec"] > 0
    assert len(list(tdir.glob("ckpt_*.npz"))) == 2


def test_jax_checkpoint_resumes_in_the_port(qgsw_runs):
    """A run the JAX driver checkpointed at 100 steps, resumed by the port
    to 150, writes the frames of an uninterrupted JAX 150-step run."""
    tmp, jdir, _, _, j150 = qgsw_runs
    mixed = tmp / "jax-then-torch"
    shutil.copytree(jdir, mixed)
    carry, _ = tdr.qgsw_raytrace(out_dir=mixed, max_steps=150,
                                 checkpoint_every=1, resume=True, **QGSW,
                                 **PORT)
    assert carry.flow_state.step == 150
    for name in ("packet_x", "packet_k", "packet_time", "pv", "pv_time"):
        got = np.fromfile(mixed / f"{name}.bin")
        want = np.fromfile(j150 / f"{name}.bin")
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FRAMES,
                                   err_msg=name)


def test_port_resume_continues_its_own_run(qgsw_runs):
    tmp, _, tdir, _, j150 = qgsw_runs
    own = tmp / "torch-resumed"
    shutil.copytree(tdir, own)
    n1 = binio.frame_count(str(own / "packet_x"), 8, 2)
    tdr.qgsw_raytrace(out_dir=own, max_steps=150, checkpoint_every=1,
                      resume=True, **QGSW, **PORT)
    assert binio.frame_count(str(own / "packet_x"), 8, 2) == n1 + 10 == 31
    np.testing.assert_allclose(np.fromfile(own / "packet_k.bin"),
                               np.fromfile(j150 / "packet_k.bin"), rtol=0,
                               atol=ATOL_FRAMES)


@pytest.mark.parametrize("mode", [
    dict(omega_hist_bins=64, omega_hist_max=12.0, snapshot_every=1),
    dict(omega_hist_bins=64, omega_hist_log=True)], ids=["linear", "log"])
def test_omega_hist_mode_matches_jax(tmp_path, mode):
    jdir, tdir, _, _ = _both(tmp_path, "hist", jdr.qgsw_raytrace,
                             tdr.qgsw_raytrace, **HIST, **mode)
    assert_same_run(tdir, jdir)
    counts, edges, t, params = spectra.load_omega_hist(tdir)
    assert counts.shape == (len(t), 65)
    assert (counts.sum(axis=1) == 16).all()
    if mode.get("omega_hist_log"):
        assert counts[:, -1].sum() == 0          # nothing truncated
        np.testing.assert_allclose(edges[[0, -1]], [3.0, 384.0])


def test_qg2layersw_raytrace_matches_jax(tmp_path):
    jdir, tdir, _, (carry, _) = _both(
        tmp_path, "qg2", jdr.qg2layersw_raytrace, tdr.qg2layersw_raytrace,
        nx=32, Npackets=4, T_Fr_days=10.0, packet_delay_days=0.05,
        max_steps=60, verbose=False)
    assert_same_run(tdir, jdir)
    q = binio.read_field(str(tdir / "pv"), 32, 32, 2, frames=1)
    assert q.shape == (32, 32, 2)  # two layers
    assert torch.isfinite(carry.packet_x).all()


def test_margin_overflow_self_corrects(tmp_path):
    """An under-margined fused-march run discards the overflowing chunk,
    widens the margin and re-runs it, as the JAX driver does; the frames
    equal a run with a generous margin from the start."""
    jdir, tdir, _, (carry, rd) = _both(tmp_path, "bad", jdr.qgsw_raytrace,
                                       tdr.qgsw_raytrace, march_margin=1,
                                       **MARGIN)
    assert_same_run(tdir, jdir)
    ovs = [m for m in rd.read_metrics() if m.get("march_overflow")]
    assert ovs and all(m.get("chunk_discarded") for m in ovs)
    ok, _ = tdr.qgsw_raytrace(out_dir=tmp_path / "ok", march_margin=8,
                              **MARGIN, **PORT)
    np.testing.assert_allclose(carry.packet_x.numpy(), ok.packet_x.numpy(),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.fromfile(tdir / "packet_x.bin"),
                               np.fromfile(tmp_path / "ok" / "packet_x.bin"),
                               rtol=1e-10, atol=1e-10)


def test_margin_overflow_halts_without_retries(tmp_path):
    jdir, tdir, _, (_, rd) = _both(tmp_path, "halt", jdr.qgsw_raytrace,
                                   tdr.qgsw_raytrace, march_margin=1,
                                   max_margin_retries=0, **MARGIN)
    assert_same_run(tdir, jdir)
    assert any(m.get("march_overflow") for m in rd.read_metrics())
    # only the initial frame was written
    assert binio.frame_count(str(tdir / "packet_x"), 8, 2) == 1


def test_checkpoint_nf_reconciles_on_resume(tmp_path):
    """A checkpoint of a uv-window run (prev_fields nf=2) resumes under a
    6-field configuration, in both packages alike."""
    runs = {}
    for name, fn, extra in (("jax", jdr.qgsw_raytrace, {}),
                            ("torch", tdr.qgsw_raytrace, PORT)):
        out = tmp_path / name
        fn(out_dir=out, max_steps=20, checkpoint_every=1,
           march_uv_windows=True, **NF, **extra)
        carry, _ = fn(out_dir=out, max_steps=40, checkpoint_every=1,
                      resume=True, march_uv_windows=False, **NF, **extra)
        runs[name] = (out, carry)
    assert runs["torch"][1].prev_fields.shape[0] == 6
    assert_same_run(runs["torch"][0], runs["jax"][0])


def test_qg2_cfl_recheck_rebuilds_march(tmp_path, capsys):
    """The two-layer CFL recheck rebuilds dt, the operators and the march
    (its margin from the running maximum speed) exactly as the JAX driver
    does: same messages, same frames."""
    jdir, tdir, _, (carry, rd) = _both(
        tmp_path, "recheck", jdr.qg2layersw_raytrace,
        tdr.qg2layersw_raytrace, **RECHECK)
    text = capsys.readouterr().out
    jl = [ln for ln in text.splitlines() if ln.startswith("CFL recheck")]
    assert len(jl) == 4
    assert jl[:2] == jl[2:]   # JAX's, then the port's
    assert_same_run(tdir, jdir)
    assert torch.isfinite(carry.packet_x).all()
    assert not any(m.get("blow_up") for m in rd.read_metrics())


def test_run_sweep_sequential_and_ensemble(tmp_path):
    res = tdr.run_sweep([(2.0, 0.3), (4.0, 0.6)], base_dir=str(tmp_path),
                        nx=16, Npackets=4, T_Fr_days=30.0,
                        packet_delay_days=0.1, max_steps=10, verbose=False,
                        **PORT)
    assert [(w0, ug) for _, w0, ug in res] == [(2.0, 0.3), (4.0, 0.6)]
    for i, (w0, ug) in enumerate([(2.0, 0.3), (4.0, 0.6)]):
        p = runmeta.RunDir(tmp_path / f"run-{i}").read_params()
        assert (p["near_inertial_factor"], p["U_g"]) == (w0, ug)
    assert tdr.DEFAULT_SWEEP == jdr.DEFAULT_SWEEP
    # the same table as one program: (batched carry, a RunDir per member)
    ens = tmp_path / "ensemble"
    carry, rds = tdr.run_sweep([(2.0, 0.3), (4.0, 0.6)], base_dir=str(ens),
                               ensemble=True, nx=16, Npackets=4,
                               T_Fr_days=30.0, packet_delay_days=0.1,
                               max_steps=10, verbose=False, **PORT)
    assert carry.packet_x.shape == (2, 2, 4)
    assert [str(rd.path) for rd in rds] == [str(ens / f"run-{i}")
                                            for i in range(2)]
    for i, (w0, ug) in enumerate([(2.0, 0.3), (4.0, 0.6)]):
        p = runmeta.RunDir(ens / f"run-{i}").read_params()
        assert (p["near_inertial_factor"], p["U_g"]) == (w0, ug)
        assert (ens / f"run-{i}" / "omega_hist.bin").exists()


def test_monitor_every_renders_live_frames(tmp_path):
    tdr.qgsw_raytrace(nx=16, Npackets=4, T_Fr_days=30.0,
                      packet_delay_days=0.1, max_steps=100, verbose=False,
                      monitor_every=1, out_dir=tmp_path, **PORT)
    frames = sorted(p.name for p in (tmp_path / "figs" / "live").iterdir())
    assert frames == ["frame_000002.png", "frame_000003.png"]


def test_drivers_need_a_device_named_or_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    for fn in (tdr.qgsw_raytrace, tdr.qg2layersw_raytrace):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(nx=16, Npackets=4, out_dir=tmp_path / "x", verbose=False)
    assert not (tmp_path / "x").exists()
