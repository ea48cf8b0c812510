"""Device operations (kernels, copies, memsets) a flow step, in the
profiled stretch."""


def read(rec):
    if rec["kind"] != "forward":
        return None
    t = rec["trace"]
    return t["device_ops"] / t["steps"]
