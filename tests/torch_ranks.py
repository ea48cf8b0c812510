"""Rank processes of the sharded tests of swraytracing_torch
(tests/test_torch_parallel.py, tests/test_torch_multihost.py):

    python tests/torch_ranks.py <suite> <rank> <world> <rendezvous> <out>

joins a gloo process group of `world` CPU ranks through the file
`rendezvous`, runs the suite's checks on the port (float64), and writes
what the tests compare into the directory `out` (rank 0; the sweeps'
run directories from every rank that writes them). spawn() starts the
ranks and collect() waits for them. Imports no JAX: each rank is a user's
process of the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from swraytracing_torch import drivers
from swraytracing_torch.models.coupled import (CoupledConfig,
                                               run_coupled_chunk,
                                               setup_coupled)
from swraytracing_torch.parallel import multihost
from swraytracing_torch.parallel import sharding as shd
from swraytracing_torch.parallel.scaling import measure_packet_scaling

CPU = dict(device="cpu", dtype=torch.float64)
TIMEOUT_S = 120

# tests/test_parallel.py's configurations: the stencil path, the windowed
# per-stage path (the march off, windows from one packet on) and the
# production fused march (uv windows, combined gather), with their saves
STENCIL = dict(nx=32, n_packets=64, T_Fr_days=10.0, packet_delay_days=0.1)
WINDOWED = dict(STENCIL, fused_march=False, window_min_np=1)
PRODUCTION = dict(STENCIL, fused_march=True, march_uv_windows=True,
                  march_combined_gather=True, window_min_np=1)
CHUNKS = {"stencil": (STENCIL, 4), "windowed": (WINDOWED, 3),
          "production": (PRODUCTION, 4)}
# the flow-gradient checks (test_parallel.py:44-64, :282-306)
GRAD_SHAPE = dict(n_packets=32, T_Fr_days=5.0, packet_delay_days=0.05)
GRADS = {"stencil": dict(STENCIL, **GRAD_SHAPE),
         "production": dict(PRODUCTION, **GRAD_SHAPE)}
# tests/test_multiprocess.py: two saves of the stencil path
MULTIPROCESS = (STENCIL, 2)
# tests/test_drivers.py:186-207's sharded sweep, with a checkpoint a chunk
# and 47 bins where it has 48 (tests/test_torch_ensemble_drivers.py: the
# ring start puts every packet on a bin edge of an even linear binning,
# where XLA's fused multiply-add and PyTorch's two roundings part)
SWEEP = [(2.0, 0.3), (4.0, 0.6)]
ENS = dict(ensemble=True, nx=32, Npackets=16, T_Fr_days=30.0,
           packet_delay_days=0.1, omega_hist_bins=47, window_min_np=1,
           max_steps=60, verbose=False, checkpoint_every=1)
# a margin of one cell where member 0 (on rank 0 of a (2, 1) mesh)
# overflows and member 1 does not
MARGIN = dict(ENS, march_margin=1, Cg=10.0, max_steps=50)
SCALING = dict(base_packets=64, world_sizes=(1, 2), iters=1)


def arrays(**named):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in named.items()}


def chunk_on_mesh(cfg_kw, n_saves, mesh):
    """A single run's chunk with this rank's packets; the packets and
    saves gathered back to the whole arrays."""
    cfg = CoupledConfig(**cfg_kw)
    s, carry = setup_coupled(cfg, **CPU)
    c, (px, pk, _) = shd.run_sharded_chunk(
        run_coupled_chunk, shd.shard_carry(carry, mesh), s, cfg, n_saves,
        mesh)
    overflow = -1 if c.overflow is None else int(c.overflow)
    return arrays(x=shd.gather_packets(c.packet_x, mesh),
                  k=shd.gather_packets(c.packet_k, mesh),
                  px=shd.gather_packets(px, mesh),
                  pk=shd.gather_packets(pk, mesh), qk=c.flow_state.qk,
                  overflow=overflow)


def flow_gradient_on_mesh(cfg_kw, mesh):
    """d/dqk of tests/test_parallel.py's loss mean_c(sum_packets
    pk[-1]^2) through 2 saves: each rank differentiates the part of its
    own packets, and the parts are summed over the ranks."""
    cfg = CoupledConfig(**cfg_kw)
    s, carry = setup_coupled(cfg, **CPU)
    qk = carry.flow_state.qk.clone().requires_grad_(True)
    c = shd.shard_carry(carry, mesh)
    c = dataclasses.replace(c, flow_state=dataclasses.replace(
        c.flow_state, qk=qk))
    _, (_, pk, _) = run_coupled_chunk(c, s, cfg, 2)
    (pk[-1] ** 2).sum(-1).mean().backward()
    return shd.packet_sum(qk.grad, mesh)


def sweep_on_mesh(out: Path, name: str, mesh, **kw):
    carry, _ = drivers.run_sweep(SWEEP, base_dir=str(out / name), mesh=mesh,
                                 **kw, **CPU)
    return arrays(x=carry.packet_x, k=carry.packet_k, qk=carry.flow_state.qk,
                  t=carry.flow_state.t, step=carry.flow_state.step,
                  overflow=carry.overflow)


def suite_parallel(rank, world, out: Path):
    """Two ranks: the chunk on each path, the sweep on a (2, 1) mesh, the
    margin retry with the overflow on one rank, the scaling harness,
    make_mesh's check."""
    mesh = shd.make_mesh(ensemble=1)
    saved = {}
    for name, (cfg_kw, n_saves) in CHUNKS.items():
        for key, a in chunk_on_mesh(cfg_kw, n_saves, mesh).items():
            saved[f"{name}_{key}"] = a
    members = shd.make_mesh(ensemble=2)
    for key, a in sweep_on_mesh(out, "sweep", members, **ENS).items():
        saved[f"sweep_{key}"] = a
    for key, a in sweep_on_mesh(out, "margin", members, **MARGIN).items():
        saved[f"margin_{key}"] = a
    base = CoupledConfig(nx=32, T_Fr_days=10.0, packet_delay_days=0.1)
    points = measure_packet_scaling(
        lambda n: setup_coupled(base._replace(n_packets=n), **CPU),
        lambda s: lambda c: run_coupled_chunk(c, s, base, 1), **SCALING)
    try:
        shd.make_mesh(ensemble=3)
        mesh_error = None
    except ValueError as e:
        mesh_error = str(e)
    if rank == 0:
        np.savez(out / "parallel.npz", **saved)
        (out / "parallel.json").write_text(json.dumps(dict(
            scaling=[p._asdict() for p in points], mesh_error=mesh_error)))


def suite_multihost(rank, world, out: Path):
    """Four ranks: global arrays from local blocks on a (1, 4) and a
    (2, 2) mesh, the chunk of tests/test_multiprocess.py, the flow
    gradients, the sweep on a (2, 2) mesh."""
    saved, roundtrip = {}, {}
    for shape in ((1, world), (2, world // 2)):
        mesh = shd.make_mesh(ensemble=shape[0])
        x = torch.arange(2 * 64, dtype=torch.float64).reshape(2, 64)
        local = shd.shard_packets(mesh, x)
        g = multihost.global_packet_array(local, mesh)
        roundtrip[str(shape)] = dict(
            shape=list(g.shape),
            local_back=bool(torch.equal(multihost.host_local_slice(g),
                                        local)),
            whole=bool(torch.equal(g.full_tensor(), x)),
            gathered=bool(torch.equal(shd.gather_packets(local, mesh), x)))
    packets = shd.make_mesh(ensemble=1)
    for key, a in chunk_on_mesh(*MULTIPROCESS, packets).items():
        saved[f"multiprocess_{key}"] = a
    for name, cfg_kw in GRADS.items():
        saved[f"grad_{name}"] = arrays(
            g=flow_gradient_on_mesh(cfg_kw, packets))["g"]
    for key, a in sweep_on_mesh(out, "sweep", shd.make_mesh(ensemble=2),
                                **ENS).items():
        saved[f"sweep_{key}"] = a
    if rank == 0:
        np.savez(out / "multihost.npz", **saved)
        (out / "multihost.json").write_text(json.dumps(roundtrip))


SUITES = {"parallel": suite_parallel, "multihost": suite_multihost}


def main(suite, rank, world, rendezvous, out):
    torch.set_num_threads(1)
    multihost.initialize(coordinator=f"file://{rendezvous}",
                         num_processes=world, process_id=rank, device="cpu",
                         timeout_s=TIMEOUT_S)
    try:
        SUITES[suite](rank, world, Path(out))
    finally:
        torch.distributed.destroy_process_group()


def spawn(suite: str, world: int, tmp: Path):
    """Start the suite's ranks; returns the processes (collect() waits)."""
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=f"{repo}{os.pathsep}{repo / 'tests'}",
               OMP_NUM_THREADS="1")
    out = tmp / "out"
    out.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(world),
         str(tmp / "rendezvous"), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)], out


def collect(procs, timeout=2 * TIMEOUT_S):
    """Wait for every rank (a timeout each); raises with a failed rank's
    output."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{log[-4000:]}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
