"""Host milliseconds a flow step spends in the chunk call, from its entry
to its return, before any synchronisation: what the host takes to queue a
step's work. Host clock, over the measured window's units."""


def read(rec):
    if rec["kind"] != "forward":
        return None
    w = rec["window"]
    return 1e3 * w["enqueue_s"] / w["steps"]
