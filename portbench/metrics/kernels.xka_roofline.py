"""The x-k-a march kernel's share of its roofline, in percent: the least
time the chip could take for a step of the march (counts/xka.py: the
algorithm's operations and bytes against the published float32 and HBM
peaks) over the kernel's own device time a step in the profiled stretch,
read by its name (march_xka_kernel, every scalar type and order) from
the stretch's ten largest device operations, where it ranks first
whenever it runs. None where the span bench.xka
(models/frozen.raytrace_rsw_restart) did not run; an error where it ran
and no such kernel is among those operations, so that the share cannot
drop out of sight when the kernel is renamed or outranked."""

import re

XKA = re.compile(r"\bmarch_xka_kernel\b")


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "forward" or not t["span_device_s"].get("bench.xka"):
        return None
    kernel = sum(s for name, s in t["top_ops"] if XKA.search(name))
    if not kernel:
        raise ValueError("bench.xka ran, but no march_xka_kernel is among "
                         "the profiled stretch's largest device operations")
    return 100.0 * rec["march_bound_s_per_step"] / (kernel / t["steps"])
