"""The program's own spans (``kmergma_tpu_torch/utils/trace.py``) in a
traced run, for the readers that read them, and the profiled stretch's
idle gaps named by them.

The runner reads each per-layer reader's ``SPANS`` when it wraps the
window's spans around the program, and again for the profiled stretch:
only with ``--trace 1``.  A reader of program spans takes
``module_getattr`` as its module's ``__getattr__``, so that this first
read turns the program's tracer on, emptied; it stays on through the
profiled stretch, and its ``record_function`` ranges show there as
``kmergma.<name>``.  The first ``collect`` after the run turns it off
again (where it was off before) and keeps its log in the run:

- ``run["program_spans"]``: the spans of the window's calls, each of the
  program's calls kept whole where its ``call`` span lies inside one of
  the runner's window calls (host clock), re-indexed; ``self_ms_per_call``
  reads them with the window's ``traced_calls``;
- ``run["program_profiled"]``: the same for the profiled calls.

With ``--trace 0`` nothing reads ``SPANS``, and the tracer stays off.  A
program without the tracer gives empty logs, and its readers read
nothing.  ``collect`` also writes ``build/benchmark/gaps-<cell>-<seed>.json``:
the profiled stretch's idle gaps of the device, each named by the
innermost program span open during most of it, and the window's
``summary``.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import statistics
import sys

from . import trace as tracemod
from .spans import self_ms_per_call
from .spec import ROOT

_TRACER = "kmergma_tpu_torch.utils.trace"
#: whether this module turned the tracer on, and so turns it off again
_switched_on = False


def _tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        return importlib.import_module(_TRACER)
    except ModuleNotFoundError as exc:
        if exc.name not in (_TRACER, _TRACER.rsplit(".", 1)[0]):
            raise
        return None


def module_getattr(name: str):
    """A reader module's ``__getattr__``: ``SPANS`` is read as the runner
    installs a traced run's spans, which turns the program's tracer on
    (emptied) unless it is on already; it names no function to wrap."""
    global _switched_on
    if name != "SPANS":
        raise AttributeError(name)
    tr = _tracer()
    if tr is not None and not tr.enabled():
        tr.reset()
        tr.enable()
        _switched_on = True
    return {}


def _within(spans: list, calls: list) -> list:
    """The spans of the program calls whose ``call`` span lies inside one
    of ``calls`` (the runner's, host clock), with ``parent`` re-indexed."""
    bounds = [(c["start"], c["end"]) for c in calls]
    ids = {
        s["call"] for s in spans
        if s["name"] == "call" and s["end"] is not None and any(a <= s["start"] and s["end"] <= b for a, b in bounds)
    }
    kept = [i for i, s in enumerate(spans) if s["call"] in ids and s["end"] is not None]
    index = {old: new for new, old in enumerate(kept)}
    return [dict(spans[i], parent=index.get(spans[i]["parent"])) for i in kept]


def collect(run: dict) -> list:
    """The window's program spans (``run["program_spans"]``), taken from the
    tracer on the first call after a run, which also writes the gaps file."""
    global _switched_on
    if "program_spans" in run:
        return run["program_spans"]
    tr = _tracer()
    spans = list(tr.log()) if tr is not None else []
    if tr is not None and _switched_on:
        tr.disable()
        tr.reset()
        _switched_on = False
    run["program_spans"] = _within(spans, run.get("calls") or [])
    run["program_profiled"] = _within(spans, run.get("profiled_calls") or [])
    if run["program_profiled"] and run.get("trace"):
        _write_gaps(run)
    return run["program_spans"]


def self_ms(run: dict, name: str) -> "float | None":
    """The mean over the window's calls of the summed self time of the
    program's spans called ``name``, in ms; None without them."""
    return self_ms_per_call({"spans": collect(run), "traced_calls": run.get("traced_calls") or []}, name)


def counter_sum(spans: list, name: str, key: str) -> int:
    """``key`` summed over the counters of the spans called ``name``."""
    return sum(s["counters"].get(key, 0) for s in spans if s["name"] == name)


def profiler_ranges(run: dict) -> list:
    """The profiled calls' program spans as (name, start, end) in
    microseconds of the profiler's clock: shifted by the median offset
    between each profiled call's start (host clock) and the start of its
    benchmark ``call`` range in the trace."""
    calls = sorted(c["start"] for c in run["profiled_calls"])
    ranges = sorted(s for name, s, _e in run["trace"]["ranges"] if name == "call")
    if not calls or len(calls) != len(ranges):
        return []
    shift_us = statistics.median(r - c * 1e6 for c, r in zip(calls, ranges))
    return [(s["name"], s["start"] * 1e6 + shift_us, s["end"] * 1e6 + shift_us) for s in run["program_profiled"]]


def idle_gaps(run: dict) -> dict:
    """Every idle gap of the device inside the profiled calls, named by the
    program span that the host spent most of it in (``trace.breakdown``
    over the program's ranges), and their seconds summed by name."""
    ranges = profiler_ranges(run)
    if not ranges:
        return {"idle_gaps": [], "by_span": {}}
    gaps = tracemod.breakdown(dict(run["trace"], ranges=ranges), top=len(ranges) + len(run["trace"]["device"]) + 1)
    by_span: dict[str, float] = {}
    for name, seconds in gaps["idle_gaps"]:
        by_span[name] = by_span.get(name, 0.0) + seconds
    return {"idle_gaps": gaps["idle_gaps"], "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


#: the engine's spans, inside the benchmark's ``scan`` spans
ENGINE = ("stage", "bitmap", "plan", "fetch")


def summary(run: dict) -> dict:
    """The window's program spans a traced call: each name's self time
    (ms); the engine's spans that lie inside the benchmark's ``scan`` spans
    (``record_stream(s)``, host clock) against ``scan_ms``; and the share of
    the program's ``call`` spans that no child span covers."""
    spans = collect(run)
    n = len(run.get("traced_calls") or []) or 1
    names = sorted({s["name"] for s in spans})
    child = [0.0] * len(spans)
    for s in spans:
        if s["parent"] is not None:
            child[s["parent"]] += s["end"] - s["start"]
    scans = sorted((b["start"], b["end"]) for b in run.get("spans") or [] if b["name"] == "scan")
    starts = [a for a, _ in scans]

    def inside_scan(s: dict) -> bool:
        j = bisect.bisect_right(starts, s["start"]) - 1
        return j >= 0 and s["end"] <= scans[j][1]

    in_scan = sum(s["end"] - s["start"] - child[i] for i, s in enumerate(spans) if s["name"] in ENGINE and inside_scan(s))
    calls = [i for i, s in enumerate(spans) if s["name"] == "call"]
    call_s = sum(spans[i]["end"] - spans[i]["start"] for i in calls)
    return {
        "self_ms": {name: self_ms(run, name) for name in names},
        "engine_in_scan_ms": 1e3 * in_scan / n,
        "scan_ms": self_ms_per_call(run, "scan"),
        "call_self_pct": 100.0 * sum(spans[i]["end"] - spans[i]["start"] - child[i] for i in calls) / call_s if call_s else None,
        "counters": {key: counter_sum(spans, "call", key) for key in ("windows_scanned", "candidate_windows", "replay_hits", "hits")},
        "calls": len(calls),
        "spans": len(spans),
    }


def _run_name() -> str:
    """``<cell>-<seed>`` from the command line of ``benchmark/run.py``,
    else the process id."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed")
    args, _ = ap.parse_known_args(sys.argv[1:])
    return f"{args.workload}-{args.seed}" if args.workload and args.seed else str(os.getpid())


def _write_gaps(run: dict) -> None:
    gaps = idle_gaps(run)
    out = ROOT / "build" / "benchmark"
    out.mkdir(parents=True, exist_ok=True)
    gaps["idle_gaps"] = gaps["idle_gaps"][:40]
    gaps["summary"] = summary(run)
    (out / f"gaps-{_run_name()}.json").write_text(json.dumps(gaps, indent=1))
