"""The layer spans of the profiled stretch (spans/bench.step, bench.flow,
bench.fields, bench.march, bench.march.backward beside bench.windows):
the device time each is given, the metrics read from them, and that the
port's calls are spanned where the cells run them."""

import math

import pytest

from conftest import ROOT, TINY

from portbench import core, trace

LAYERS = ("bench.step", "bench.flow", "bench.fields", "bench.windows",
          "bench.march")


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(t, corr, tid=1):
    return ev("cuda_runtime", "cudaLaunchKernel", t, 1, tid=tid, corr=corr)


def kernel(name, t, dur, corr):
    return ev("kernel", name, t, dur, tid=7, corr=corr)


# A forward step: the flow (two kernels), the fields, the window build
# inside the march, the march; an idle gap while the host is in the flow.
FORWARD = [
    ev("user_annotation", "bench.unit", 0, 200),
    ev("user_annotation", "bench.chunk", 0, 200),
    ev("user_annotation", "bench.step", 10, 150),
    ev("user_annotation", "bench.flow", 11, 39),
    launch(12, 1), kernel("fft", 14, 6, 1),
    launch(40, 2), kernel("mul", 42, 4, 2),
    ev("user_annotation", "bench.fields", 55, 20),
    launch(60, 3), kernel("c2r", 61, 3, 3),
    ev("user_annotation", "bench.march", 80, 75),
    ev("user_annotation", "bench.windows", 82, 30),
    launch(85, 4), kernel("transpose_kernel", 86, 10, 4),
    launch(120, 5), kernel("march_ring_kernel", 121, 30, 5),
]

# A differentiated step: the march's backward on autograd's thread (2),
# with a launch on the main thread inside its interval that is not its.
BACKWARD = [
    ev("user_annotation", "bench.unit", 0, 300),
    ev("user_annotation", "bench.backward", 100, 200),
    ev("user_annotation", "bench.march.backward", 110, 150, tid=2),
    launch(120, 11, tid=2), kernel("reduce_kernel", 121, 50, 11),
    launch(180, 12, tid=2), kernel("mul", 181, 40, 12),
    launch(200, 13), kernel("add", 230, 5, 13),
]


def test_layer_spans_get_the_device_time_they_launched():
    r = trace.read(FORWARD, 1, 1)
    s = r["span_device_s"]
    assert set(LAYERS) <= set(s)
    expect = {"bench.step": 53e-6, "bench.flow": 10e-6,
              "bench.fields": 3e-6, "bench.windows": 10e-6,
              "bench.march": 40e-6}
    for name, want in expect.items():
        assert math.isclose(s[name], want, abs_tol=1e-12), name
    # the gaps 20-42 and 46-61 start with the host in the flow
    gaps = dict(r["top_gaps"])
    assert math.isclose(gaps["bench.flow/none"], 37e-6, abs_tol=1e-12)

    b = trace.read(BACKWARD, 1, 5)
    assert math.isclose(b["span_device_s"]["bench.march.backward"], 90e-6,
                        abs_tol=1e-12)


def _metric(name):
    return core.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                            name).read


@pytest.mark.parametrize("name, kind, events, steps, want", [
    ("flow.device_ms_per_step", "forward", FORWARD, 1, 13e-3),
    ("march.backward_device_ms_per_step", "grad", BACKWARD, 5, 18e-3),
])
def test_layer_metrics_read_their_kind_only(name, kind, events, steps, want):
    read = _metric(name)
    t = trace.read(events, 1, steps)
    assert math.isclose(read({"kind": kind, "trace": t}), want,
                        rel_tol=1e-9)
    for other in ("forward", "grad", "ensemble"):
        if other != kind:
            assert read({"kind": other, "trace": t}) is None
    # nothing launched inside the span: no reading
    empty = dict(t, span_device_s=dict.fromkeys(t["span_device_s"], 0.0))
    assert read({"kind": kind, "trace": empty}) is None


def test_every_span_file_names_a_function_of_the_port():
    import importlib
    for name, where in trace.SPANS.items():
        mod = importlib.import_module(where["module"])
        assert callable(getattr(mod, where["function"])), name
    before = {n: getattr(importlib.import_module(w["module"]), w["function"])
              for n, w in trace.SPANS.items()}
    with trace.port_spans():
        pass
    for n, w in trace.SPANS.items():
        mod = importlib.import_module(w["module"])
        assert getattr(mod, w["function"]) is before[n]


@pytest.mark.parametrize("cell, counts", [
    ("qg2_512.p1m", dict.fromkeys(LAYERS, 1)),
    # remat: each step again in the backward, two window builds a step
    # each time, the march's backward once a step
    ("qg2_512.grad5", {"bench.step": 2, "bench.flow": 2, "bench.fields": 2,
                       "bench.windows": 4, "bench.march": 2,
                       "bench.march.backward": 1}),
])
def test_the_cells_run_their_calls_inside_the_spans(cell, counts,
                                                    monkeypatch):
    """The profiled stretch of a cell at a size the CPU holds: each layer
    span is entered so many times a lock-step, so the port's calls go
    through the module attributes spans/ wraps."""
    seen = {}
    read = trace.read

    def keep(events, units, steps):
        seen["events"], seen["steps"] = events, steps
        return read(events, units, steps)

    monkeypatch.setattr(trace, "read", keep)
    _, traffic, _, c = core.set_up(ROOT, cell, 2 ** 40 + 3, "cpu",
                                   TINY[cell])
    c.restart()
    trace.profile_units(c, 1, traffic.get("trace_saves_per_unit"))
    names = [e["name"] for e in seen["events"]
             if e.get("cat") == "user_annotation"]
    got = {n: names.count(n) for n in counts}
    assert got == {n: k * seen["steps"] for n, k in counts.items()}
