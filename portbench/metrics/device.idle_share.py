"""Share of a flow step's wall time in which the device runs nothing:
1 - device-busy seconds a step (union of device intervals, profiled
stretch) / wall seconds a step (CUDA events around the measured window's
units, untraced: the profiler's own host cost stays out of the wall)."""


def read(rec):
    if rec["kind"] != "forward":
        return None
    t, w = rec["trace"], rec["window"]
    return 1.0 - (t["busy_s"] / t["steps"]) / (w["event_s"] / w["steps"])
