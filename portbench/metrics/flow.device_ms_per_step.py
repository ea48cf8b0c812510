"""Device milliseconds a flow step of the flow layer: every device
operation launched inside the two-layer solver's step and the velocity
grids from its PV (spans bench.flow and bench.fields around
models/coupled2's qg2_step and top_layer_flow, spans/; the port's
swr.flow and swr.fields mark the same calls), in the profiled stretch.
None where none ran."""


def read(rec):
    if rec["kind"] != "forward":
        return None
    t = rec["trace"]
    s = t["span_device_s"]
    total = s.get("bench.flow", 0.0) + s.get("bench.fields", 0.0)
    return 1e3 * total / t["steps"] if total else None
