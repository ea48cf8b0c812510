from . import device_diag, spectra, plots
from .spectra import (omega_of_k, energy_vs_omega, omega_windows,
                      mean_omega_timeseries, ideal_omega_samples,
                      load_packets)

__all__ = ["device_diag", "spectra", "plots", "omega_of_k",
           "energy_vs_omega", "omega_windows", "mean_omega_timeseries",
           "ideal_omega_samples", "load_packets"]
