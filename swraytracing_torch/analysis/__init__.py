from . import device_diag, spectra, plots, wavefield
from .spectra import (omega_of_k, energy_vs_omega, omega_windows,
                      mean_omega_timeseries, ideal_omega_samples,
                      load_packets)

__all__ = ["device_diag", "spectra", "plots", "wavefield", "omega_of_k",
           "energy_vs_omega", "omega_windows", "mean_omega_timeseries",
           "ideal_omega_samples", "load_packets"]
