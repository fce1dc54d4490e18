"""device_idle_pct: 100 less the share of the profiled calls' wall (their
``call`` ranges in the trace) in which any device interval ran: kernels,
copies and fills."""

from benchmark.harness import trace


def read(run: dict) -> "float | None":
    tr = run.get("trace")
    if tr is None:
        return None
    window = trace.stretch(tr)
    if window is None or window[1] <= window[0]:
        return None
    return 100.0 * (1.0 - trace.busy_us(tr) / (window[1] - window[0]))
