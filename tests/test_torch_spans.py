"""The port's layer spans (utils/profiling.span, spans, trace): what each
span counts on every path of the lock-step, that spans change no result,
that nothing is entered while they are off, and how the blocks nest."""

import contextlib
import dataclasses
import json
import sys
import threading

import pytest
import torch

from swraytracing_torch.analysis.device_diag import (OmegaHistSpec,
                                                     omega_hist_counts)
from swraytracing_torch.models import coupled as tcp
from swraytracing_torch.models import coupled2 as tc2
from swraytracing_torch.parallel import ensemble as tens
from swraytracing_torch.utils import profiling

PORT = dict(device="cpu", dtype=torch.float64)
N_SAVES, PER_SAVE = 2, 2
N = N_SAVES * PER_SAVE                  # lock-steps a chunk
SMALL = dict(nx=32, n_packets=64, T_Fr_days=10.0, packet_delay_days=0.01,
             packet_steps_per_save=PER_SAVE, window_min_np=1)
MARCH = ("swr.step", "swr.flow", "swr.fields", "swr.windows", "swr.march")
PER_STAGE = ("swr.step", "swr.flow", "swr.fields")


def _hist(carry):
    spec = OmegaHistSpec(n_bins=47, omega_max=12.0, f=3.0, Cg=1.0)
    return omega_hist_counts(carry.packet_k, spec)


def _two_layer(**over):
    cfg = tc2.Coupled2Config(**dict(SMALL, **over))
    s, c = tc2.setup_coupled2(cfg, **PORT)
    return c, lambda c: tc2.run_coupled2_chunk(c, s, cfg, N_SAVES,
                                               diag_fn=_hist)


def _one_layer(**over):
    cfg = tcp.CoupledConfig(**dict(SMALL, **over))
    s, c = tcp.setup_coupled(cfg, **PORT)
    return c, lambda c: tcp.run_coupled_chunk(c, s, cfg, N_SAVES)


def _ensemble():
    base = tcp.CoupledConfig(**SMALL)
    s, es, c = tens.setup_ensemble(
        tens.sweep_configs(base, (2.0, 8.0), (0.3, 0.9)), **PORT)
    return c, lambda c: tens.run_ensemble_chunk(c, es, s, base, N_SAVES)


PATHS = {
    "two_layer": (_two_layer, MARCH),
    "one_layer": (_one_layer, MARCH),
    "ensemble": (_ensemble, MARCH),
    "per_stage": (lambda: _two_layer(fused_march=False), PER_STAGE),
}


def _outputs(carry, saved):
    """The chunk's answers: PV, packets, overflow and the saved rows."""
    return [carry.flow_state.qk, carry.packet_x, carry.packet_k,
            carry.overflow, *saved]


@pytest.mark.parametrize("on", [False, True])
def test_no_record_function_without_a_profiler(monkeypatch, on):
    """Spans off: a chunk enters no record_function and fills no table.
    On with no profiler running: still none, and the table counts."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    c, run = _two_layer()
    c = run(c)[0]
    with profiling.spans() if on else contextlib.nullcontext() as table:
        run(c)
    if on:
        assert table["swr.step"]["calls"] == N
    else:
        assert profiling.span("swr.step") is profiling.span("swr.flow")
    assert profiling._on is False and profiling._table is None


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_count_the_layers_and_change_nothing(path):
    """A chunk of N lock-steps records N calls of each of its path's spans
    and nothing else, and gives the same bits with spans on as off. The
    first chunk builds the carry's windows, so the second is counted."""
    setup, names = PATHS[path]
    c0, run = setup()
    c1, _ = run(c0)
    c_off, saved_off = run(c1)
    with profiling.spans() as table:
        c_on, saved_on = run(c1)
    assert {n: row["calls"] for n, row in table.items()} == \
        dict.fromkeys(names, N)
    assert all(row["ns"] > 0 for row in table.values())
    for off, on in zip(_outputs(c_off, saved_off), _outputs(c_on, saved_on)):
        assert (off is None and on is None) or torch.equal(off, on)


def test_remat_backward_records_the_march_backward():
    """A remat chunk's backward() records swr.march.backward once a step;
    the recomputed steps record swr.step again."""
    cfg = tc2.Coupled2Config(**SMALL)
    s, c = tc2.setup_coupled2(cfg, **PORT)
    qk = c.flow_state.qk.detach().clone().requires_grad_(True)
    c = dataclasses.replace(
        c, flow_state=dataclasses.replace(c.flow_state, qk=qk))
    with profiling.spans() as table:
        c2, _ = tc2.run_coupled2_chunk(c, s, cfg, N_SAVES, remat=True)
        forward = {n: row["calls"] for n, row in table.items()}
        (c2.packet_k ** 2).sum().backward()
    assert forward == {"swr.step": N, "swr.flow": N, "swr.fields": N,
                       "swr.windows": 2 * N, "swr.march": N}
    assert table["swr.march.backward"]["calls"] == N
    assert table["swr.step"]["calls"] == 2 * N
    assert torch.isfinite(qk.grad).all()


def test_spans_and_trace_nest_and_restore(tmp_path):
    assert profiling._on is False and profiling._table is None
    with profiling.spans() as outer:
        with profiling.span("a"):
            pass
        with profiling.trace(tmp_path):
            with profiling.span("b"):
                pass
            with profiling.spans() as inner:
                with profiling.span("a"):
                    pass
            assert profiling._on and profiling._table is outer
            assert {n: r["calls"] for n, r in inner.items()} == {"a": 1}
        assert profiling._on and profiling._table is outer
    assert {n: r["calls"] for n, r in outer.items()} == {"a": 2, "b": 1}
    assert profiling._on is False and profiling._table is None
    with profiling.trace(tmp_path, "alone"):
        assert profiling._on and profiling._table is None
        with profiling.span("c"):
            pass
    assert profiling._on is False and profiling._table is None


def test_trace_shows_the_layers(tmp_path):
    """trace() around a chunk: its Chrome trace holds a swr.step event a
    lock-step, with the aten operations of the flow inside swr.flow."""
    c0, run = _two_layer()
    c1, _ = run(c0)
    with profiling.trace(tmp_path):
        run(c1)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events
             if e.get("ph") == "X" and e["name"].startswith("swr.")]
    count = {n: sum(e["name"] == n for e in spans) for n in MARCH}
    assert count == dict.fromkeys(MARCH, N)
    flow = [(e["ts"], e["ts"] + e["dur"]) for e in spans
            if e["name"] == "swr.flow"]
    assert any(s <= e["ts"] <= t for e in events
               if e.get("cat") == "cpu_op" for s, t in flow)


def test_span_table_counts_every_thread():
    """Spans ending on many threads at once (autograd's thread records the
    march's backward) lose no call."""
    threads, each = 8, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with profiling.span("x"):
                    pass
        with profiling.spans() as table:
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert table["x"]["calls"] == threads * each
