from . import grid, spectral, interp, march_window, march_rays
from .grid import SpectralGrid

__all__ = ["grid", "spectral", "interp", "march_window", "march_rays",
           "SpectralGrid"]
