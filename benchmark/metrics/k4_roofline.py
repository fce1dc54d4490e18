"""k4_roofline: the least time one H100 needs for K4's work in the
profiled calls (``harness.k4_bound.k4_least_ms``: 9 bytes a transition of
each record at 3.35 TB/s), over the device time of K4's own kernels in
the trace (``pair_roll_hist_kernel``, its sliding-histogram route, and
``pair_depth_codes_kernel``, its register-blocked one, both of
csrc/pair_depth.cu), in %.  Nothing to read where no K4 kernel ran."""

from benchmark.harness.k4_bound import k4_least_ms

#: the names of K4's kernels, as the device trace shows them
KERNELS = ("pair_roll_hist_kernel", "pair_depth_codes_kernel")


def read(run: dict) -> "float | None":
    tr = run.get("trace")
    if tr is None:
        return None
    k4_us = sum(us for name, us in tr["ops"].items() if any(k in name for k in KERNELS))
    if k4_us <= 0:
        return None
    least_ms = sum(k4_least_ms(run["files"][c["file"]], run["windowsizes"][0]) for c in run["profiled_calls"])
    return 100.0 * least_ms * 1e3 / k4_us
