"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

Set-up makes the cell's inputs from the seed, loads the program and warms
its kernels with one call on the first input, which builds every kernel
the cell's shapes use.  The window then starts calls back to back, one
caller, cycling through the inputs, while less than ``seconds`` have
passed since it opened; the last call runs to its end.  With ``trace``,
spans wrap the program's layer boundaries for the whole window, each
synchronising the device at its end; after it they are taken off, and
``profile_calls`` more calls run under ``torch.profiler`` with ranges
alone around the same functions, so that the device runs as in an
untraced window.  Once the window has closed and the peak memory has
been read, the reference works out each input's hit records again, and
every call's records are held against them.  Every input has to be
within the configuration's ``genome_bp_max``, the scale it was cut to.

Beside each call's wall the run logs the main thread's CPU time, the
process's, and the host's steal time (``/proc/stat``), to tell a slower
host from a waiting one.

The readers of ``benchmark/metrics`` get one ``run`` dict:

- ``setup_s``: process start to the first timed call;
- ``calls``: the window's calls, each {"id", "file", "start", "end",
  "bp", "ok"}, host seconds of ``time.perf_counter``;
- ``spans``, ``traced_calls``: the span log (``spans.Spans``) of the
  window and the ids of its calls, in the traced run;
- ``trace``: the profiled stretch (``trace.from_profiler``), or None;
- ``profiled_calls``: the calls of that stretch, as ``calls``;
- ``files``: each input's record lengths; ``windowsizes``: the profiles'
  windowsizes, from the reference's preparation.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import sys
import time
from pathlib import Path

import torch

from ..reference.fasta import read_fasta
from . import genome, trace as tracemod
from .spec import ROOT, Cell
from .spans import Spans

#: each compared number's limit: exact comparisons, so 0
LIMITS = {"hits_differing": 0, "calls_raised": 0}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _records(out) -> list[tuple[str, bytes]]:
    return [(h.description, bytes(h.seq)) for h in out[0]]


def _differing(got: "list | None", want: list) -> int:
    """Records at which two hit lists differ, position by position, plus
    the difference of their lengths."""
    if got is None:
        return len(want)
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def _steal_s() -> float:
    """Seconds the host's CPUs spent stolen by other guests, summed over
    CPUs (``/proc/stat``); 0 where there is no such file."""
    try:
        with open("/proc/stat") as fh:
            fields = fh.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK") if len(fields) > 8 else 0.0
    except (OSError, ValueError):
        return 0.0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, work_dir: Path, log=None) -> dict:
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    import kmergma_tpu_torch as kt

    config = cell.config
    ref_path = str(ROOT / config["ref_set"])
    genes = [seq for _, seq in read_fasta(ref_path)]
    t_gen = time.perf_counter()
    paths, layouts = genome.make(cell.traffic, seed, genes, work_dir, device)
    files = [[r.length for r in recs] for recs in layouts]
    bp = [sum(f) for f in files]
    if max(bp) > int(config["genome_bp_max"]):
        raise ValueError(f"{cell.name}: an input of {max(bp)} bp passes {config['name']}'s genome_bp_max "
                         f"of {config['genome_bp_max']}")
    log(f"inputs: {len(paths)} file(s), {sum(bp)} bp, {sum(len(r.plants) for recs in layouts for r in recs)} genes "
        f"planted, made in {time.perf_counter() - t_gen:.2f} s, {t_gen - t_start:.2f} s after the process started")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    entry = getattr(kt, config["entry"])
    kwargs = dict(config["kwargs"])

    def call(i: int, calls: list, spans: "Spans | None") -> None:
        f = i % len(paths)
        rec = {"id": i, "file": f, "bp": bp[f], "hits": None, "error": None}
        if spans is not None:
            spans.call_id = i
        cpu0, proc0, steal0 = time.thread_time(), time.process_time(), _steal_s()
        rec["start"] = time.perf_counter()
        try:
            with spans.span("call") if spans is not None else contextlib.nullcontext():
                out = entry(str(paths[f]), ref_path, device=device, **kwargs)
            _sync(device)
            rec["hits"] = _records(out)
        except Exception as exc:  # a call that raises is a failed call; the window goes on
            rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["end"] = time.perf_counter()
        rec["host"] = (time.thread_time() - cpu0, time.process_time() - proc0, _steal_s() - steal0)
        rec["ok"] = rec["error"] is None
        calls.append(rec)

    warm: list = []
    call(0, warm, None)
    if warm[0]["error"]:
        log(f"warm-up call failed: {warm[0]['error']}")
    setup_s = time.perf_counter() - t_start
    log(f"warm-up call {warm[0]['end'] - warm[0]['start']:.2f} s; setup {setup_s:.2f} s")

    spans = None
    if trace:
        spans = Spans(device)
        for m in cell.per_layer:
            spans.install(getattr(m.reader, "SPANS", {}))
    calls: list = []
    profiled: list = []
    trace_rec = None
    try:
        t_open = time.perf_counter()
        i = 0
        while time.perf_counter() - t_open < seconds:
            call(i, calls, spans)
            i += 1
    finally:
        if spans is not None:
            spans.remove()
    if trace:
        ranges = Spans(device, sync=False)
        for m in cell.per_layer:
            ranges.install(getattr(m.reader, "SPANS", {}))
        try:
            trace_rec = _profile(lambda j: call(j, profiled, ranges), i, int(cell.traffic.get("profile_calls", 1)), device)
        finally:
            ranges.remove()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    for what, part in (("call walls", None), ("main thread cpu", 0), ("process cpu", 1), ("host steal", 2)):
        log(f"{what}, ms: " + " ".join(
            f"{1e3 * (c['end'] - c['start'] if part is None else c['host'][part]):.0f}" for c in calls))

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = importlib.import_module(config["reference"])
    t_ref = time.perf_counter()
    all_calls = calls + profiled
    used = sorted({c["file"] for c in all_calls})
    want = dict(zip(used, reference.find_hits_many(config["entry"], kwargs, [paths[f] for f in used], ref_path, device=device)))
    log(f"reference: {len(want)} input(s) in {time.perf_counter() - t_ref:.1f} s, "
        f"{sum(len(v) for v in want.values())} hit records")
    differing = [_differing(c["hits"], want[c["file"]]) for c in all_calls]
    checks = {"hits_differing": sum(differing), "calls_raised": sum(c["error"] is not None for c in all_calls)}
    for c, d in zip(all_calls, differing):
        c["ok"] = c["error"] is None and d == 0
    errors = sorted({c["error"] for c in all_calls if c["error"]})
    for e in errors[:3]:
        log(f"a call raised: {e}")

    run = {
        "setup_s": setup_s,
        "calls": calls,
        "profiled_calls": profiled,
        "spans": spans.log if spans else [],
        "traced_calls": [c["id"] for c in calls] if trace else [],
        "trace": trace_rec,
        "files": files,
        "windowsizes": reference.windowsizes(config["entry"], kwargs, ref_path),
    }
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = m.reader.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "count": cell.chips,
        "memory_peak_bytes": int(memory_peak),
    }
    result = {
        "correct": bool(all_calls) and all(checks[k] <= LIMITS[k] for k in LIMITS),
        "attempted": len(all_calls),
        "failed": sum(not c["ok"] for c in all_calls),
        "metrics": metrics,
        "device": dev,
    }
    if trace_rec is not None:
        window = tracemod.stretch(trace_rec)
        dev["busy_s"] = tracemod.busy_us(trace_rec) / 1e6
        dev["window_s"] = (window[1] - window[0]) / 1e6 if window else 0.0
        result["breakdown"] = tracemod.breakdown(trace_rec)
        _write_spans(cell.name, seed, run)
    result["checks"] = {k: {"value": v, "limit": LIMITS[k]} for k, v in checks.items()}
    return result


def _profile(call, first: int, n: int, device: torch.device) -> dict:
    """``n`` calls under ``torch.profiler``, after a profiled no-op that
    starts the tracer."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities):
        torch.zeros(1, device=device).add_(1)
        _sync(device)
    with profile(activities=activities) as prof:
        for j in range(first, first + n):
            call(j)
        _sync(device)
    return tracemod.from_profiler(prof)


def _write_spans(cell: str, seed: int, run: dict) -> None:
    out = ROOT / "build" / "benchmark"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"spans-{cell}-{seed}.json").write_text(json.dumps({"spans": run["spans"], "calls": [
        {k: c[k] for k in ("id", "file", "start", "end", "bp", "ok")} for c in run["calls"] + run["profiled_calls"]]}))
