"""Ensembles of runs on one card (parallel/ensemble.py).

Counterpart of swraytracing_tpu/parallel. Sharding over several devices
(`sharding`, `multihost`, `scaling`) is not ported yet: ROADMAP item A14.
"""

from . import ensemble
from .ensemble import (EnsembleSetup, run_ensemble_chunk, setup_ensemble,
                       sweep_configs)

__all__ = ["ensemble", "EnsembleSetup", "setup_ensemble",
           "run_ensemble_chunk", "sweep_configs"]
