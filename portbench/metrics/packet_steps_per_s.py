"""Packets times flow steps completed in the window (every member's
packets in an ensemble), over the window's seconds: all the work over all
the time, host reads included."""


def read(rec):
    if rec["kind"] != "forward":
        return None
    return rec["window"]["work"] / rec["window"]["seconds"]
