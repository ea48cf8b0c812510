"""Package-level contracts of swraytracing_torch: what importing it pulls
in, and that nothing runs on the CPU unless the caller asks for it."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swraytracing_torch import kernels
from swraytracing_torch.models.coupled import CoupledConfig, setup_coupled
from swraytracing_torch.models.coupled2 import Coupled2Config, setup_coupled2
from swraytracing_torch.models.dispersion import Dispersion
from swraytracing_torch.models.analytic import childress_soward
from swraytracing_torch.models.frozen import ring_ics, raytrace_rsw_restart
from swraytracing_torch.models import cgrid, rsw, sw1d
from swraytracing_torch.models.qg2 import initial_q2_ring
from swraytracing_torch.ops.grid import SpectralGrid, resolve_device
from swraytracing_torch.ops import march_rays as mr
from swraytracing_torch.ops import march_window as mw
from swraytracing_torch import convert

import torch_parity  # noqa: F401  (one torch thread per worker)

ROOT = Path(__file__).resolve().parent.parent


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("module", [
    "swraytracing_torch", "swraytracing_torch.convert",
    "swraytracing_torch.kernels", "swraytracing_torch.models.coupled2",
    "swraytracing_torch.ops.march_window", "chip_smoke",
    "swraytracing_torch.models.coupled", "swraytracing_torch.models.qg",
    "swraytracing_torch.ops.interp", "swraytracing_torch.models.fields",
    "swraytracing_torch.models.rays", "swraytracing_torch.ops.march_rays",
    "swraytracing_torch.models.frozen", "swraytracing_torch.drivers",
    "swraytracing_torch.__main__", "swraytracing_torch.io",
    "swraytracing_torch.io.binio", "swraytracing_torch.io.runmeta",
    "swraytracing_torch.io.asyncwriter", "swraytracing_torch.io.checkpoint",
    "swraytracing_torch.analysis", "swraytracing_torch.analysis.device_diag",
    "swraytracing_torch.analysis.spectra",
    "swraytracing_torch.analysis.plots", "swraytracing_torch.parallel",
    "swraytracing_torch.parallel.ensemble",
    "swraytracing_torch.parallel.sharding",
    "swraytracing_torch.parallel.multihost",
    "swraytracing_torch.parallel.scaling", "swraytracing_torch.utils",
    "swraytracing_torch.utils.logging", "swraytracing_torch.utils.profiling",
    "swraytracing_torch.models.analytic",
    "swraytracing_torch.models.reversible", "swraytracing_torch.ops.nufft",
    "swraytracing_torch.analysis.wavefield", "swraytracing_torch.models.rsw",
    "swraytracing_torch.models.sw1d", "swraytracing_torch.models.cgrid",
    "swraytracing_torch.models.exact_linear",
    "swraytracing_torch.models.examples",
    "swraytracing_torch.models.examples_1d",
    "swraytracing_torch.ops.spectral", "swraytracing_torch.models"])
def test_import_pulls_in_no_jax(module):
    """Importing the port (and chip_smoke, import only) loads neither jax,
    flax, the JAX package nor matplotlib (which the card's machine does not
    have), and builds or loads no kernel."""
    r = _run(
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'swraytracing_tpu', 'triton', "
        "'matplotlib', 'PIL')]\n"
        "assert not bad, bad\n"
        "from swraytracing_torch import kernels\n"
        "assert kernels._lib is None\n"
        "print('clean')\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_sources_name_no_jax_import():
    for path in [*ROOT.glob("swraytracing_torch/**/*.py"),
                 ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(
                ("import jax", "from jax", "import flax", "from flax",
                 "import swraytracing_tpu", "from swraytracing_tpu")), \
                (path, line)


def test_kernel_sources_ship_with_the_package():
    names = [s.name for s in kernels.sources()]
    assert names == ["build_windows.cu", "march_f32.cu", "march_f64.cu",
                     "march_rays.cu", "march_ring_f32.cu",
                     "march_ring_f64.cu", "march_staged_f32.cu",
                     "march_staged_f64.cu", "transpose.cu"]
    csrc = kernels.sources()[0].parent
    for s in kernels.sources():
        assert 'extern "C"' in s.read_text()
    for name in ("march.cuh", "march_ring.cuh", "transpose.cu",
                 "build_windows.cu", "march_rays.cu"):
        assert "__global__" in (csrc / name).read_text(), name
    # every header a source includes ships too (and enters the build's hash)
    headers = {h.name for h in csrc.glob("*.cuh")}
    assert headers == {"march.cuh", "march_ring.cuh", "scalar.cuh"}
    for src in csrc.iterdir():
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                assert line.split('"')[1] in headers, (src.name, line)
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_no_device_argument_means_cuda_or_raise():
    """This machine has no CUDA device: entry points that are not told
    device='cpu' raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    cfg = Coupled2Config(nx=16, n_packets=8, window_min_np=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        setup_coupled2(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        initial_q2_ring(5, SpectralGrid.square(16, 20.0), 0.4, 3.0, k_min=2,
                        k_max=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.carry_from_numpy({})
    with pytest.raises(RuntimeError, match="CUDA"):
        setup_coupled(CoupledConfig(nx=16, n_packets=8, window_min_np=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        ring_ics(8, 2.0, Dispersion(f=3.0, Cg=1.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        childress_soward()
    assert resolve_device("cpu") == torch.device("cpu")


def test_solver_entry_points_want_cuda_or_raise():
    """The solvers' entry points that take numpy arrays raise on a machine
    without a CUDA device unless told device='cpu'; nothing carries on on
    the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    grid = SpectralGrid.square(16)
    z2 = np.zeros((16, 16))
    z1 = np.zeros((16, 3))
    x0 = np.zeros((2, 4))
    calls = [
        lambda: rsw.rsw_init(z2, z2, z2, grid, rsw.RSWParams(f=3.0, Cg=1.0)),
        lambda: rsw.swknd(z2, z2, z2, 0.1, 0.7, 2),
        lambda: sw1d.sw1(z1, sw1d.SW1Params(f=1.0, Cg=1.0), 2),
        lambda: sw1d.sw1_forced(z1, 0.1, 1.0, 0.2, 1, 1e-3, 2),
        lambda: sw1d.sw1rk3nu(z1, 0.1, 1.0, 1e-6, 2),
        lambda: sw1d.ybj1d(np.ones(16, complex), 0.5, 0.4, 2, 1e-3, 2),
        lambda: cgrid.swp(z2, z2, z2, nt=2, save_every=1),
        lambda: cgrid.swp_to_files(z2, z2, z2, "never-written", nt=2,
                                   save_every=1),
        lambda: raytrace_rsw_restart(z2, z2, z2, Dispersion(f=3.0, Cg=1.0),
                                     grid, x0, x0, nsteps=2, save_every=1),
        lambda: convert.rsw_state_from_numpy({}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not Path("never-written").exists()


def test_cuda_kernels_unreachable_from_cpu_tensors():
    """On CPU tensors the entry points run the plain versions; the kernel
    wrappers themselves refuse, and nothing is built or counted."""
    spec = mw.MarchSpec(nx=16, ny=16, dx=1.0, dy=1.0, f=3.0, Cg=1.0,
                        n_substeps=1)
    g = torch.Generator().manual_seed(0)
    F = torch.randn(6, 16, 16, dtype=torch.float64, generator=g)
    x = 16 * torch.rand(2, 10, dtype=torch.float64, generator=g)
    k = torch.randn(2, 10, dtype=torch.float64, generator=g)
    W = mw.build_gather_windows(F, spec)
    oi, oj = mw.packet_cells(x[0], x[1], spec)
    pw = mw.gather_packet_windows(W, oi, oj, spec)
    xk = torch.cat([x, k])
    out, ov = mw.fused_march(pw, pw, xk, oi, oj, 0.01, spec)
    ref, _ = mw.march_reference(pw, pw, xk, oi, oj, 0.01, spec)
    assert torch.equal(out, ref)
    assert torch.equal(mw.window_transpose(W), W.t().contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        mw.march_cuda(pw, pw, xk, oi, oj, 0.01, spec)
    with pytest.raises(ValueError, match="CUDA"):
        mw.transpose_cuda(W)
    fused = spec._replace(tiles_transposed=True, fused_build=True)
    assert torch.equal(mw.build_gather_windows(F, fused), W.t())
    with pytest.raises(ValueError, match="CUDA"):
        mw.build_windows_cuda(F, fused)
    grid = SpectralGrid(nx=16, ny=16, Lx=16.0, Ly=16.0)
    disp = Dispersion(f=3.0, Cg=1.0)
    xN, kN = mr.march_rays(F, x, k, grid, disp, 0.01, 3)
    ref = mr.march_rays_reference(F, x, k, grid, disp, 0.01, 3)
    assert torch.equal(xN, ref[0]) and torch.equal(kN, ref[1])
    with pytest.raises(ValueError, match="CUDA"):
        mr.march_rays_cuda(F, x, k, grid, disp, 0.01, 3)
    assert mw.march_cuda.launches == 0 and mw.transpose_cuda.launches == 0
    assert mw.march_gathered_cuda.launches == 0
    assert mw.build_windows_cuda.launches == 0
    assert mr.march_rays_cuda.launches == 0
    assert kernels._lib is None


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""          # no result line of any kind
    assert "no CUDA device" in r.stderr
