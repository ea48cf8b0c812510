"""Device milliseconds a step of the RSW restart raytracer: every device
operation launched inside models/frozen.raytrace_rsw_restart (span
bench.xka, spans/): the decomposition of the frame into seven grids, and
each frame's march (the node-major copy, the orderings by cell and the
x-k-a kernel), in the profiled stretch. None where none ran."""


def read(rec):
    t = rec["trace"]
    s = t["span_device_s"].get("bench.xka")
    if rec["kind"] != "forward" or not s:
        return None
    return 1e3 * s / t["steps"]
