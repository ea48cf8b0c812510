"""Share of a gradient's device time in the backward: CUDA events around
the forward (under remat) and around backward() of every unit after the
warm-up."""


def read(rec):
    g = rec.get("grad")
    if rec["kind"] != "grad" or not g:
        return None
    return g["backward_s"] / (g["forward_s"] + g["backward_s"])
