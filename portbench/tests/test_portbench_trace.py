"""The profiled stretch's reading: device time is given to a span of
spans/ by where its launch lies, and the port's functions are spanned for
the stretch only."""

from portbench import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_span_device_time_follows_the_launch():
    events = [
        ev("user_annotation", "bench.unit", 0, 100),
        ev("user_annotation", "bench.windows", 10, 20),
        # launched inside the span: a copy and a kernel, both counted
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_driver", "cuLaunchKernel", 20, 1, corr=2),
        ev("kernel", "direct_copy_kernel", 40, 5, tid=7, corr=1),
        ev("kernel", "transpose_kernel", 45, 3, tid=7, corr=2),
        # launched after the span (the march) and inside its interval on
        # another thread: neither counted
        ev("cuda_runtime", "cudaLaunchKernel", 35, 1, corr=3),
        ev("kernel", "march_ring_kernel", 50, 30, tid=7, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 15, 1, tid=2, corr=4),
        ev("kernel", "direct_copy_kernel", 81, 2, tid=7, corr=4),
    ]
    r = trace.read(events, 1, 1)
    assert abs(r["span_device_s"]["bench.windows"] - 8e-6) < 1e-12
    assert abs(r["march_s"] - 30e-6) < 1e-12
    assert r["device_ops"] == 4


def test_port_spans_wrap_for_the_stretch_only():
    from swraytracing_torch.ops import march_window as mw
    before = mw.build_gather_windows
    with trace.port_spans():
        assert mw.build_gather_windows is not before
    assert mw.build_gather_windows is before
