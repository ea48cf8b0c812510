"""Ensembles of runs on one card (parallel/ensemble.py), and packets and
ensemble members sharded over the ranks of a torch.distributed process
group (sharding, multihost, scaling).

Counterpart of swraytracing_tpu/parallel.
"""

from . import ensemble, multihost, sharding
from .ensemble import (EnsembleSetup, run_ensemble_chunk, setup_ensemble,
                       sweep_configs)
from .sharding import (ensemble_sharding, make_mesh, packet_sharding,
                       replicated)

__all__ = ["sharding", "ensemble", "multihost", "make_mesh",
           "packet_sharding", "ensemble_sharding", "replicated",
           "EnsembleSetup", "setup_ensemble", "run_ensemble_chunk",
           "sweep_configs"]
