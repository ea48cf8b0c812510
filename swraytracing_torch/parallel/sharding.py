"""Packets and ensemble members sharded over the ranks of a process group.

Counterpart of swraytracing_tpu/parallel/sharding.py. The reference's only
parallelism is a SLURM job array over 20 parameter configs
(runqgsw_raytrace.sbatch:10). The JAX package lays its devices out on a
2-D (ensemble, packets) mesh and lets GSPMD insert the collectives; here
each device is one rank of a torch.distributed process group, the mesh a
DeviceMesh over the group's ranks, and the few collectives are written
out:

  * axis "ensemble" (mesh dim 0): the members of a sweep, split over its
    ranks; each member's flow lives on the ranks that hold it;
  * axis "packets" (mesh dim 1): wave packets, split over its ranks; the
    flow, its fields and windows are computed on every rank of the axis
    (replicated, as GSPMD replicates them) and each rank marches its own
    packets through its own kernel launches.

A packet's arithmetic does not depend on the other packets, so a rank's
packets follow the bits of the same packets in a one-rank run. What
crosses ranks: the march's overflow count (MAX), the omega histogram
counts (SUM over the packet axis), the finite flags (AND), the gradient of
a loss over all packets (SUM over the packet axis), and the gathers that
put the whole state on every rank for a checkpoint or a snapshot.

Collectives run on the tensors' own device with NCCL. gloo, which also
serves two ranks that share one card, runs them on host copies (the
helpers say where); the choice follows dist.get_backend(group).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

__all__ = ["make_mesh", "packet_sharding", "ensemble_sharding",
           "replicated", "shard_packets", "shard_carry", "gather_packets",
           "run_sharded_chunk", "packet_sum", "all_reduce", "all_gather",
           "MeshPart"]

MAX, MIN, SUM = dist.ReduceOp.MAX, dist.ReduceOp.MIN, dist.ReduceOp.SUM


def make_mesh(ensemble: int = 1, device_type: str | None = None,
              axis_names: tuple = ("ensemble", "packets")) -> DeviceMesh:
    """A 2-D (ensemble, packets) DeviceMesh over the ranks of the
    initialised process group: `ensemble` rows of world // ensemble ranks.
    ensemble=1 gives pure packet sharding (single-config runs).

    device_type: the tensors' device type; None means "cuda" under NCCL
    and "cpu" under gloo (name "cuda" for gloo ranks on CUDA tensors).
    Every rank of the group calls it (it creates the axes' groups)."""
    world = dist.get_world_size()
    if world % ensemble:
        raise ValueError(f"ensemble={ensemble} must divide the world size "
                         f"{world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(world).reshape(ensemble, world // ensemble)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def packet_sharding(mesh: DeviceMesh, batched: bool = False,
                    ndim: int = 2) -> tuple:
    """DTensor placements of packet arrays. The packet axis is LAST
    (coordinate-first (2, Np) layout): (..., Np) split over both mesh axes,
    ensemble-major, or an ensemble's (E, ..., Np) with E over the ensemble
    axis and Np over the packet axis."""
    if batched:
        return (Shard(0), Shard(ndim - 1))
    return (Shard(ndim - 1),) * mesh.ndim


def ensemble_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of a per-member flow state (E, nx, nky): the members
    split over the ensemble axis, each replicated over the packet axis."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(),) * mesh.ndim


def _part(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{n} {what} do not split evenly over {parts} "
                         "ranks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of its own (the kernels take contiguous input,
    and the whole array it was cut from can be freed)."""
    return t.clone(memory_format=torch.contiguous_format)


def shard_packets(mesh: DeviceMesh, *tensors, batched: bool = False):
    """This rank's slice of each packet array (last axis = packets; (2, Np),
    (Np,), or batched (E, ..., Np)), as packet_sharding places them."""
    e, p = mesh.get_coordinate()
    ne, npk = mesh.size(0), mesh.size(1)
    out = []
    for t in tensors:
        if batched:
            t = t[_part(t.shape[0], ne, e, "members")]
            t = t[..., _part(t.shape[-1], npk, p, "packets")]
        else:
            t = t[..., _part(t.shape[-1], ne * npk, e * npk + p, "packets")]
        out.append(_own(t))
    return tuple(out) if len(out) > 1 else out[0]


def shard_carry(carry, mesh: DeviceMesh):
    """A single run's carry with this rank's packets and the flow whole
    (what run_sharded_chunk takes)."""
    x, k = shard_packets(mesh, carry.packet_x, carry.packet_k)
    return dataclasses.replace(carry, packet_x=x, packet_k=k, prev_win=None,
                               overflow=None)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _comm_device(t: torch.Tensor, group) -> torch.device:
    """Where `group`'s backend runs a collective on `t`: NCCL on the CUDA
    device, gloo on the host."""
    if dist.get_backend(group) == "nccl":
        return t.device if t.is_cuda else \
            torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _as_real(t: torch.Tensor) -> torch.Tensor:
    if t.is_complex():
        return torch.view_as_real(t)
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    return t


def _from_real(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(r.contiguous())
    return r.to(like.dtype)


def all_reduce(t: torch.Tensor, op=SUM, group=None) -> torch.Tensor:
    """op over the ranks of `group`, returned as a new tensor on t's
    device (t is not modified). Complex tensors are reduced as their real
    pairs (SUM only), booleans as int32 (MIN is AND, MAX is OR)."""
    if group is None:
        return t.detach().clone()
    r = _as_real(t.detach())
    # under gloo a CUDA tensor is copied to the host for the collective;
    # under NCCL a host tensor (the sweep's times) to the card
    buf = r.to(_comm_device(t, group), copy=True)
    dist.all_reduce(buf, op=op, group=group)
    return _from_real(buf.to(t.device), t)


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors of `group` (equal shapes), concatenated along
    `dim` in rank order, on t's device."""
    if group is None:
        return t
    r = _as_real(t.detach())
    # host copy under gloo, card copy under NCCL, as in all_reduce
    buf = r.to(_comm_device(t, group)).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    d = dim % t.dim()
    return _from_real(torch.cat(parts, dim=d).to(t.device), t)


def _groups(mesh, batched: bool):
    """The mesh groups a packet array is split over: the packet axis, and
    for a single run's packets the ensemble axis after it."""
    if mesh is None:
        return []
    groups = [mesh.get_group(1)]
    return groups if batched else groups + [mesh.get_group(0)]


def packet_sum(t: torch.Tensor, mesh: DeviceMesh | None,
               batched: bool = False, op=SUM) -> torch.Tensor:
    """op (SUM by default) over the ranks that hold the other packets of
    the same run (members): a histogram's counts, a loss's or a flow
    gradient's parts, the overflow count (op=MAX)."""
    for group in _groups(mesh, batched):
        t = all_reduce(t, op, group)
    return t


def gather_packets(t: torch.Tensor, mesh: DeviceMesh | None,
                   batched: bool = False) -> torch.Tensor:
    """The whole packet array (last axis) from every rank's slice of it:
    the inverse of shard_packets. Batched arrays are gathered over the
    packet axis only (see MeshPart.gather_carry for the members)."""
    for group in _groups(mesh, batched):
        t = all_gather(t, group, dim=-1)
    return t


def run_sharded_chunk(run_chunk, carry, s, cfg, n_saves: int,
                      mesh: DeviceMesh, **kw):
    """One chunk of a single run on a mesh: run_chunk (run_coupled_chunk,
    run_coupled2_chunk; any path) on this rank's packets (shard_carry)
    with the flow computed here in full, then the march's overflow count
    reduced with MAX over the ranks that hold the run's packets, so every
    rank reads the same count. The saves (packets, or a diagnostic) stay
    this rank's: gather_packets collects packet arrays, packet_sum sums a
    histogram. Inside the chunk nothing crosses ranks."""
    carry, saves = run_chunk(carry, s, cfg, n_saves, **kw)
    if carry.overflow is not None:
        carry = dataclasses.replace(
            carry, overflow=packet_sum(carry.overflow, mesh, op=MAX))
    return carry, saves


# ---------------------------------------------------------------------------
# an ensemble's members and packets on a mesh (drivers.run_sweep)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshPart:
    """This rank's part of an ensemble of E members of Np packets each on
    a (ensemble, packets) mesh: its members [members] and, of each, its
    packets [packets]. `mesh=None` is the whole ensemble on one rank,
    where every method below is the identity.

    writes: this rank writes its members' run directories (it holds them
    at packet rank 0); root: global rank 0 (the sweep's own files and the
    checkpoints)."""

    mesh: DeviceMesh | None
    members: slice
    packets: slice
    writes: bool
    root: bool

    @classmethod
    def of(cls, mesh: DeviceMesh | None, n_members: int, n_packets: int):
        if mesh is None:
            return cls(None, slice(0, n_members), slice(0, n_packets), True,
                       True)
        e, p = mesh.get_coordinate()
        return cls(mesh, _part(n_members, mesh.size(0), e, "members"),
                   _part(n_packets, mesh.size(1), p, "packets"), p == 0,
                   dist.get_rank() == 0)

    def member_range(self) -> range:
        return range(self.members.start, self.members.stop)

    def local_carry(self, carry):
        """This rank's carry cut from an ensemble's whole carry: its
        members' flow and their packets' slice; no windows, no overflow."""
        if self.mesh is None:
            return carry
        m, p = self.members, self.packets
        st = carry.flow_state
        state = dataclasses.replace(st, **{
            f.name: (_own(v[m]) if isinstance(v, torch.Tensor) else
                     np.array(v[m]))
            for f in dataclasses.fields(st)
            for v in [getattr(st, f.name)]})
        return dataclasses.replace(
            carry, flow_state=state,
            packet_x=_own(carry.packet_x[m][..., p]),
            packet_k=_own(carry.packet_k[m][..., p]),
            prev_fields=_own(carry.prev_fields[m]), prev_win=None,
            overflow=None)

    def member_values(self, values):
        """This rank's members' entries of a per-member host array."""
        return np.asarray(values)[self.members]

    def member_vector(self, t: torch.Tensor, op=MAX) -> torch.Tensor:
        """A per-member quantity (E_local, ...) reduced with op over the
        packet axis and gathered over the ensemble axis: the whole (E, ...)
        on every rank, so every rank takes the same branch on it."""
        if self.mesh is None:
            return t
        t = all_reduce(t, op, self.mesh.get_group(1))
        return all_gather(t, self.mesh.get_group(0), dim=0)

    def packet_sum(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the packet axis of this rank's members' counts."""
        return packet_sum(t, self.mesh, batched=True)

    def gather_carry(self, carry):
        """The ensemble's whole carry on every rank, from each rank's part
        (without the windows, which stay with their ranks); the overflow
        counts by MAX over the packet axis."""
        if self.mesh is None:
            return carry
        ens = self.mesh.get_group(0)
        st = carry.flow_state

        def members(v):
            if isinstance(v, torch.Tensor):
                return all_gather(v, ens, dim=0)
            return all_gather(torch.as_tensor(np.asarray(v)), ens,
                              dim=0).numpy()

        state = dataclasses.replace(st, **{
            f.name: members(getattr(st, f.name))
            for f in dataclasses.fields(st)})
        overflow = carry.overflow
        if overflow is not None:
            overflow = self.member_vector(overflow, MAX)
        return dataclasses.replace(
            carry, flow_state=state,
            packet_x=members(gather_packets(carry.packet_x, self.mesh, True)),
            packet_k=members(gather_packets(carry.packet_k, self.mesh, True)),
            prev_fields=members(carry.prev_fields), prev_win=None,
            overflow=overflow)

    def agree(self, value: int) -> int:
        """`value` checked to be the same on every rank (a host decision,
        such as the checkpoint a resume starts from); raises if not."""
        if self.mesh is None:
            return value
        t = torch.tensor([value, -value], dtype=torch.int64)
        lo_hi = all_reduce(t, MAX, dist.group.WORLD)
        if int(lo_hi[0]) != value or int(-lo_hi[1]) != value:
            raise RuntimeError(
                f"the ranks disagree ({-int(lo_hi[1])} to {int(lo_hi[0])}) "
                "on a value that must be common: the run directory must be "
                "one directory that every rank sees")
        return value

    def barrier(self) -> None:
        if self.mesh is not None:
            all_reduce(torch.zeros(1), SUM, dist.group.WORLD)
