"""Device milliseconds a step of the frozen march: every device operation
launched inside ops/march_rays.march_rays (span bench.rays, spans/): the
node-major copy of the six grids, the orderings by cell (key, histogram,
cumulative sum, scatter) and K4, in the profiled stretch. None where none
ran."""


def read(rec):
    t = rec["trace"]
    s = t["span_device_s"].get("bench.rays")
    if rec["kind"] != "forward" or not s:
        return None
    return 1e3 * s / t["steps"]
