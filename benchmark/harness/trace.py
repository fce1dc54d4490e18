"""The device trace of the traced run's profiled stretch, reduced to
intervals, and the breakdown of the result line.

``union`` and the split of device events from ``prof.events()`` follow
chip_smoke.py's ``device_share`` at commit 643846b (the union of the
device intervals of one profiled call, and device totals by name); here
kernels are kept apart from copies and fills, for the roofline.
"""

from __future__ import annotations


def union(intervals) -> list[tuple[float, float]]:
    """The disjoint union of (start, end) intervals, in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def is_copy_or_fill(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def from_profiler(prof) -> dict:
    """A trace record of the profiled stretch, in microseconds of the
    profiler's clock: every device interval, the kernels' alone, device
    totals by name, and the benchmark's ``bench.*`` host ranges."""
    from torch.autograd import DeviceType

    device, kernels, ranges = [], [], []
    ops: dict[str, float] = {}
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        on_device = ev.device_type != DeviceType.CPU
        if on_device and (getattr(ev, "is_user_annotation", False) or ev.name.startswith("bench.")):
            # a host range as the device timeline shows it: no device work
            continue
        if on_device:
            device.append((s, e))
            ops[ev.name] = ops.get(ev.name, 0.0) + (e - s)
            if not is_copy_or_fill(ev.name):
                kernels.append((s, e))
        elif ev.name.startswith("bench."):
            ranges.append((ev.name[len("bench."):], s, e))
    return {"device": device, "kernels": kernels, "ops": ops, "ranges": ranges}


def stretch(trace: dict) -> "tuple[float, float] | None":
    """(start, end) of the profiled calls: their ``call`` ranges."""
    calls = [(s, e) for name, s, e in trace["ranges"] if name == "call"]
    if not calls:
        return None
    return min(s for s, _ in calls), max(e for _, e in calls)


def busy_us(trace: dict, key: str = "device") -> float:
    window = stretch(trace)
    if window is None:
        return 0.0
    return length(union(clip(trace[key], *window)))


def breakdown(trace: dict, top: int = 10) -> dict:
    """The ``top`` device operations by total seconds, and the ``top``
    longest idle gaps of the device inside the stretch, each named by the
    benchmark span that the host spent most of the gap in (each moment
    going to the innermost span open then)."""
    window = stretch(trace)
    ops = sorted(trace["ops"].items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    if window is not None:
        busy = union(clip(trace["device"], *window))
        edges = [window[0]] + [x for s, e in busy for x in (s, e)] + [window[1]]
        for gs, ge in zip(edges[0::2], edges[1::2]):
            if ge > gs:
                gaps.append((ge - gs, _host_span(trace["ranges"], gs, ge)))
    gaps.sort(key=lambda g: -g[0])
    return {
        "device_ops": [[name, us / 1e6] for name, us in ops],
        "idle_gaps": [[label, us / 1e6] for us, label in gaps[:top]],
    }


def _host_span(ranges, lo: float, hi: float) -> str:
    """The span that covers most of [lo, hi), each moment given to the
    innermost (shortest) span open then; "none" outside every span."""
    inside = [(s, e, name) for name, s, e in ranges if e > lo and s < hi]
    cuts = sorted({lo, hi} | {x for s, e, _ in inside for x in (s, e) if lo < x < hi})
    share: dict[str, float] = {}
    for a, b in zip(cuts, cuts[1:]):
        open_ = [(e - s, name) for s, e, name in inside if s <= a and e >= b]
        name = min(open_)[1] if open_ else "none"
        share[name] = share.get(name, 0.0) + (b - a)
    return max(share.items(), key=lambda kv: kv[1])[0]
