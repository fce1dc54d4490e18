"""recompute_pct: the windows the engine's K2 pass recomputes exactly (the
program's ``plan`` spans: K2 rows, each ``rspan`` windows, the unused
slots of a region bucket included) over the windows the calls scan
(``ScanStats.windows_scanned`` on the ``call`` spans, a window a profile),
in %, over the window's calls: where the bitmap pass leaves the K2 pass
work (``harness.program_spans``)."""

from benchmark.harness import program_spans

__getattr__ = program_spans.module_getattr


def read(run: dict) -> "float | None":
    spans = program_spans.collect(run)
    windows = program_spans.counter_sum(spans, "call", "windows_scanned")
    if not windows:
        return None
    recomputed = sum(s["counters"].get("k2_rows", 0) * s["counters"].get("rspan", 0)
                     for s in spans if s["name"] == "plan")
    return 100.0 * recomputed / windows
