"""As device.idle_share, a gradient (one unit) in place of a flow step."""


def read(rec):
    if rec["kind"] != "grad":
        return None
    t, w = rec["trace"], rec["window"]
    return 1.0 - (t["busy_s"] / t["units"]) / (w["event_s"] / w["units"])
