"""Packet-steps/s over growing numbers of ranks.

Counterpart of swraytracing_tpu/parallel/scaling.py, which times the
coupled step over meshes built from prefixes of the device list. Here a
point at n ranks runs on a process group of the first n ranks of the
world (dist.new_group): each of them marches its slice of the packets
with the flow computed on every one, and the ranks outside it wait. Every
rank of the world calls measure_packet_scaling and gets the same points
back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from .sharding import MAX, _part, _own, all_reduce

__all__ = ["ScalingPoint", "measure_packet_scaling"]


class ScalingPoint(NamedTuple):
    n_ranks: int
    packets: int
    seconds_per_step: float
    packet_steps_per_sec: float
    efficiency: float  # against the first point (weak or strong scaling)


def _wait(carry, group) -> None:
    """The device's queued work done, then the group's ranks together."""
    x = carry.packet_x
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    all_reduce(x.new_zeros(1), MAX, group)


def _time_calls(run, carry, iters: int, group) -> float:
    # two warm-up calls: the first prepares the carry's windows and
    # overflow slot (and loads the kernels), the second is the steady
    # state every later call repeats
    for _ in range(2):
        carry, _ = run(carry)
        _wait(carry, group)
    t0 = time.perf_counter()
    for _ in range(iters):
        carry, _ = run(carry)
        _wait(carry, group)
    return (time.perf_counter() - t0) / iters


def measure_packet_scaling(setup_fn, run_fn, base_packets: int,
                           world_sizes: Sequence[int] | None = None,
                           weak: bool = True, iters: int = 2,
                           steps_per_call: int = 1) -> list[ScalingPoint]:
    """Measure packet-steps/s at growing numbers of ranks.

    Args:
      setup_fn: n_packets -> (setup, carry) on this rank's device, e.g.
        `lambda n: setup_coupled(cfg._replace(n_packets=n))`.
      run_fn: setup -> (carry -> (carry, saves)), one chunk.
      base_packets: packets per rank (weak scaling) or in all (strong).
      world_sizes: the numbers of ranks, each a prefix of the world;
        default the powers of two up to the world size.
      weak: True = fixed packets PER RANK; False = fixed TOTAL packets.
      steps_per_call: flow steps one run_fn call advances; rates are per
        flow step.

    A point's time is the slowest rank's, each rank's clock read after its
    device and then the group have finished the call.
    """
    world, rank = dist.get_world_size(), dist.get_rank()
    if world_sizes is None:
        world_sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= world]
    points = []
    base_rate = None
    for n in world_sizes:
        if not 1 <= n <= world:
            raise ValueError(f"{n} ranks: the world has {world}")
        # every rank of the world takes part in making the group
        group = dist.new_group(ranks=list(range(n)))
        total = base_packets * n if weak else base_packets
        sec = 0.0
        if rank < n:
            s, carry = setup_fn(total)
            own = _part(total, n, rank, "packets")
            carry = dataclasses.replace(
                carry, packet_x=_own(carry.packet_x[..., own]),
                packet_k=_own(carry.packet_k[..., own]))
            sec = _time_calls(run_fn(s), carry, iters, group) / steps_per_call
        # the slowest rank's time, on every rank of the world
        sec = float(all_reduce(torch.tensor([sec], dtype=torch.float64), MAX,
                               dist.group.WORLD)[0])
        rate = total / sec
        if base_rate is None:
            # per-rank rate at the first point; the ideal total rate at n
            # ranks is base_rate * n for weak and strong scaling alike
            base_rate = rate / n
        points.append(ScalingPoint(n_ranks=n, packets=total,
                                   seconds_per_step=sec,
                                   packet_steps_per_sec=rate,
                                   efficiency=rate / (base_rate * n)))
    return points
