"""Several processes, one per device, on one host or many.

Counterpart of swraytracing_tpu/parallel/multihost.py. The reference's
only multi-node mechanism is SLURM launching independent MATLAB processes.
The JAX package joins its hosts with jax.distributed.initialize and builds
global arrays from each host's packets; here every process is a rank of a
torch.distributed process group (NCCL between CUDA devices, gloo on the
CPU), the mesh is a DeviceMesh over the ranks (sharding.make_mesh), and a
global packet array is a DTensor assembled from each rank's local block.

Launch one process per device, e.g. `torchrun --nproc-per-node=N
script.py` (which sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
LOCAL_RANK); the script calls initialize() before it creates a tensor.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..ops.grid import resolve_device
from .sharding import packet_sharding

__all__ = ["initialize", "global_packet_array", "host_local_slice"]


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None,
               timeout_s: float = 600.0,
               backend: str | None = None) -> torch.device:
    """Join the process group; returns this rank's device.

    coordinator: "host:port" of rank 0 (TCP rendezvous), or an
      init_method URL ("tcp://...", "file://..."). None reads the
      torchrun variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE).
    num_processes, process_id: the world size and this rank (with a
      coordinator).
    device: "cuda" (None: the CUDA device, raising when there is none)
      gives NCCL, and the rank's card is cuda:LOCAL_RANK (or the rank
      modulo the cards of the host); "cpu" gives gloo.
    backend: names the backend instead, e.g. "gloo" for ranks that share
      one card (NCCL refuses two ranks on one device).
    timeout_s: how long a collective, the rendezvous included, may wait.
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda":
        resolve_device(None)   # raises when there is no CUDA device
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            rank = process_id if process_id is not None else \
                int(os.environ.get("RANK", 0))
            index = int(local) if local is not None else \
                rank % torch.cuda.device_count()
            device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = dict(backend=backend,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator is not None:
        init = coordinator if "://" in coordinator else \
            f"tcp://{coordinator}"
        kwargs.update(init_method=init, world_size=num_processes,
                      rank=process_id)
    dist.init_process_group(**kwargs)
    return device


def global_packet_array(local: torch.Tensor, mesh: DeviceMesh,
                        placements=None) -> DTensor:
    """One global packet array from every rank's local block (the
    counterpart of jax.make_array_from_process_local_data). Packet arrays
    are coordinate-first (2, Np_local): by default the last axis is split
    over both mesh axes (sharding.packet_sharding)."""
    if placements is None:
        placements = packet_sharding(mesh, ndim=local.dim())
    return DTensor.from_local(local, mesh, placements, run_check=False)


def host_local_slice(g: DTensor) -> torch.Tensor:
    """This rank's block of a global array, for its own I/O."""
    return g.to_local()
