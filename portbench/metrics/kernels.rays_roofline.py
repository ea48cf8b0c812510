"""K4's share of its roofline, in percent: the least time the chip could
take for a step of the frozen march (counts/rays.py: the algorithm's
operations and bytes against the published float32 and HBM peaks) over
K4's own device time a step in the profiled stretch, read by the kernel's
name (march_rays_kernel, every scalar type and order) from the stretch's
ten largest device operations, where K4 ranks first whenever it runs.
None where the span bench.rays (ops/march_rays.march_rays) did not run;
an error where it ran and no K4 is among those operations, so that the
share cannot drop out of sight when the kernel is renamed or outranked."""

import re

K4 = re.compile(r"\bmarch_rays_kernel\b")


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "forward" or not t["span_device_s"].get("bench.rays"):
        return None
    k4 = sum(s for name, s in t["top_ops"] if K4.search(name))
    if not k4:
        raise ValueError("bench.rays ran, but no march_rays_kernel is among "
                         "the profiled stretch's largest device operations")
    return 100.0 * rec["march_bound_s_per_step"] / (k4 / t["steps"])
