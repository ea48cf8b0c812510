"""Device milliseconds a flow step of the window build: every device
operation launched inside the port's build_gather_windows (span
bench.windows, spans/bench.windows.json): the padded fields'
concatenations, the strided copy of the shifted views and K2 or K3 and
their batched forms, in the profiled stretch. None where none ran."""


def read(rec):
    t = rec["trace"]
    s = t["span_device_s"].get("bench.windows")
    if rec["kind"] != "forward" or not s:
        return None
    return 1e3 * s / t["steps"]
