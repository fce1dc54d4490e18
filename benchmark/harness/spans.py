"""Spans that the benchmark records around the program's functions at each
layer boundary, in the traced run only.

A metric reader names the spans it reads and the functions they wrap:
``SPANS = {"parse": ["kmergma_tpu_torch.models.miner:as_records", ...]}``,
each target ``module:attribute`` or ``module:Class.method``.  ``Spans``
replaces each target with a wrapper for the duration of the traced run.
The wrapper opens a span (name, start, end, parent, call id) and a
``torch.profiler.record_function`` range ``bench.<name>``, and with
``sync`` synchronises the device at the span's end, so that the span
holds the device work it queued.  Spans are kept in memory; the run
writes them out.  The profiled stretch takes ``sync=False``: its ranges
only name what the host is doing, and the device runs as in the window.
"""

from __future__ import annotations

import functools
import importlib
import time

import torch


class Spans:
    def __init__(self, device: torch.device, sync: bool = True):
        self.device = torch.device(device)
        self.sync = sync
        self.log: list[dict] = []
        self._stack: list[int] = []
        self._patches: list[tuple[object, str, object]] = []
        self.call_id: int | None = None

    def _sync(self) -> None:
        if self.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        """A context manager recording one span."""
        return _Span(self, name)

    def wrap(self, name: str, target: str) -> None:
        module_name, attr = target.split(":")
        owner = importlib.import_module(module_name)
        *path, leaf = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        original = owner.__dict__[leaf] if isinstance(owner, type) else getattr(owner, leaf)

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            with self.span(name):
                return original(*args, **kwargs)

        setattr(owner, leaf, wrapper)
        self._patches.append((owner, leaf, original))

    def install(self, spans: dict[str, list[str]]) -> None:
        for name, targets in spans.items():
            for target in targets:
                self.wrap(name, target)

    def remove(self) -> None:
        while self._patches:
            owner, leaf, original = self._patches.pop()
            setattr(owner, leaf, original)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        s = self.spans
        self.rf = torch.profiler.record_function(f"bench.{self.name}")
        self.rf.__enter__()
        self.index = len(s.log)
        s.log.append({"name": self.name, "start": time.perf_counter(), "end": None,
                      "parent": s._stack[-1] if s._stack else None, "call": s.call_id})
        s._stack.append(self.index)
        return self

    def __exit__(self, *exc):
        s = self.spans
        try:
            s._sync()
        finally:
            s.log[self.index]["end"] = time.perf_counter()
            s._stack.pop()
            self.rf.__exit__(*exc)
        return False


def self_ms_per_call(run: dict, name: str) -> "float | None":
    """Mean over the traced calls of the summed self time (a span less its
    children) of the spans called ``name``, in ms; None without spans."""
    spans = run.get("spans") or []
    calls = run.get("traced_calls") or []
    if not calls or not any(s["name"] == name for s in spans):
        return None
    child = [0.0] * len(spans)
    for s in spans:
        if s["parent"] is not None:
            child[s["parent"]] += s["end"] - s["start"]
    total = sum(s["end"] - s["start"] - child[i] for i, s in enumerate(spans) if s["name"] == name)
    return total / len(calls) * 1e3
