"""Device milliseconds a differentiated lock-step of K1's backward:
every device operation launched inside ops/march_window._march_backward
(span bench.march.backward, spans/), autograd through the plain march on
autograd's thread, over the lock-steps differentiated in the profiled
stretch. Under remat the first read of the function's saved tensors
recomputes the step, so that recomputation (~1% of the reading at the
main shape) counts too; the port's swr.march.backward starts after it.
None where none ran."""


def read(rec):
    t = rec["trace"]
    s = t["span_device_s"].get("bench.march.backward")
    if rec["kind"] != "grad" or not s:
        return None
    return 1e3 * s / t["steps"]
