"""scan_roofline: the least time one H100 needs for the exact scan of the
profiled calls' windows (``harness.roofline.scan_least_ms``: each genome
code read once at 3.35 TB/s, or each profile's O(1) recurrence a window at
67 T int32 op/s, whichever is longer), over the union of the kernel
intervals of those calls in the device trace, in %.  Nothing to read
without kernels."""

from benchmark.harness import trace
from benchmark.harness.roofline import scan_least_ms


def read(run: dict) -> "float | None":
    tr = run.get("trace")
    if tr is None:
        return None
    kernel_us = trace.busy_us(tr, "kernels")
    if kernel_us <= 0:
        return None
    least_ms = sum(scan_least_ms(run["files"][c["file"]], run["windowsizes"]) for c in run["profiled_calls"])
    return 100.0 * least_ms * 1e3 / kernel_us
