"""swraytracing_torch — shallow-water wave-packet raytracing on PyTorch/CUDA.

The PyTorch port of the swraytracing_tpu package, module for module:
pseudo-spectral one- and two-layer QG flow solvers on ``torch.fft``, the
lock-step coupled flow + wave-packet models, the ray integrators and the
frozen-flow raytracer. Its four device kernels (the fused packet march,
the window-array transpose, the one-pass window build and the frozen-flow
ray march) are hand-written CUDA C++ under ``kernels/csrc`` built at first
use.

Everything runs eagerly on the device of the tensors it is given. Entry
points that create tensors take an explicit ``device`` and ``dtype``;
nothing falls back to the CPU on its own.
"""

from .ops.grid import SpectralGrid
from .models.dispersion import Dispersion

__version__ = "0.1.0"
__all__ = ["SpectralGrid", "Dispersion"]
