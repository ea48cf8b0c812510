"""Packet-steps differentiated (forward and backward) in the window, over
the window's seconds."""


def read(rec):
    if rec["kind"] != "grad":
        return None
    return rec["window"]["work"] / rec["window"]["seconds"]
