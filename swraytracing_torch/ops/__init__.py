from . import grid, spectral, interp, nufft, march_window, march_rays
from .grid import SpectralGrid

__all__ = ["grid", "spectral", "interp", "nufft", "march_window",
           "march_rays", "SpectralGrid"]
