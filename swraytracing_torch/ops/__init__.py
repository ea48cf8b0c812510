from . import grid, spectral, march_window
from .grid import SpectralGrid

__all__ = ["grid", "spectral", "march_window", "SpectralGrid"]
