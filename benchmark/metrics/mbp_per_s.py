"""mbp_per_s: genome bp of every call of the window over the wall from the
first call's start to the last call's end (host clock): all the work over
all the time, never a median of calls."""


def read(run: dict) -> "float | None":
    calls = run["calls"]
    if not calls:
        return None
    wall = max(c["end"] for c in calls) - min(c["start"] for c in calls)
    return sum(c["bp"] for c in calls) / 1e6 / wall
