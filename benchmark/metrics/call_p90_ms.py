"""call_p90_ms: the 90th percentile of the wall of every call of the
window, one caller in a closed loop (host clock), by Python's
``statistics.quantiles`` (exclusive method)."""

import statistics


def read(run: dict) -> "float | None":
    walls = [c["end"] - c["start"] for c in run["calls"]]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10)[-1] * 1e3
