"""K1's share of its roofline, in percent: the least time the chip could
take for a flow step's march (counts/march.py: the algorithm's operations
and bytes against the published float32 and HBM peaks) over K1's device
time a flow step in the profiled stretch, every route summed. None where
no march kernel ran."""


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "forward" or not t["march_s"]:
        return None
    return 100.0 * rec["march_bound_s_per_step"] / (t["march_s"] / t["steps"])
