"""The program's own spans and per-call counters, off unless asked for.

Off (the default), ``span(name)`` returns one shared no-op context
manager: a span site then costs one global check, allocates nothing,
takes no clock, opens no profiler range and never touches the device.
``enable()``, or ``KMERGMA_TRACE=1`` in the environment when this module
is first imported, turns the tracer on; ``log()`` returns the spans
recorded since the last ``reset()``; ``disable()`` turns it off again.

On, each span records ``name``, ``start`` and ``end`` (seconds of
``time.perf_counter``), ``parent`` (the index in the log of the span open
around it, or None), ``call`` (one id per API call, shared by every span
the call causes; None outside a call) and ``counters`` (a dict).
Counters hold only what the host already has: shapes, bucket sizes, byte
counts and values of buffers the program fetches anyway.  Spans are kept
in memory; the program opens them from one host thread.

The spans, by where they open:

- ``call``: ``api.find_genes``, ``find_genes_cluster_mode``,
  ``strobemer_find_genes`` (``api_call``): the call's ``ScanStats``,
  ``launches``, each kernel wrapper's launches over the call (``KERNELS``),
  and in the strobemer miner engines_built, the span engines it built;
- ``parse``: ``utils/fasta.as_records``: records, bp; from the native
  loader also threads (chunks parsed at once), lines and slow_lines (lines
  that failed the one-check-a-line fast path);
- ``prep``: the API's preparation (profile or clusters, thresholds):
  profiles; in ``find_genes`` and cluster mode also trials (random
  sequences the threshold estimate scored), draws (u64s it drew) and
  rng_native (1 where the native library drew them, ``ops/thresholds``);
- ``record``: a miner's work on one record: bp, windows, candidates; in
  the strobemer miner also score_filtered, the hits its alignment-score
  filter dropped;
- ``stage``: a copy of host codes to the device through pinned staging
  (``ops/scan.PinnedStaging``), or their padding on the CPU, or the
  strobemer miner's copy of a record's int8 codes: bytes, and for pinned
  staging waits on a busy staging buffer and staging buffers grown;
- ``extract``: the strobemer miner's randstrobe extraction of a record,
  on the device or the host, and the read of the record's x*, which waits
  for a device extraction to finish: bp, windows (strobe codes);
- ``engine``: the strobemer miner's build of the span engine of an x* it
  has no engine for: xstar;
- ``bitmap``: the block bitmap pass (K1, K4, K3 or K5/K4/K6): profiles,
  windows, and in ``ScanEngine`` depth, the pair depth of the pass (ws - k
  in exact mode);
- ``plan``: the planned pass (``ops/scan._planned_streams``): region plan,
  K2 recompute, R1, stream assembly: k2_rows, rspan, regions_valid,
  region_reruns, run_reruns;
- ``fetch``: each blocking copy back to the host: bytes;
- ``replay``: the exact replay of the minima machine; in cluster mode
  the alignment and the formatting of its accepted hits run inside it:
  hits;
- ``align``: a batch of the aligner: windows, and on the device
  aligner's route (A1) a1_windows, the same count.

No span synchronises the device: where the host waits on it, the wait
lies inside a span (``fetch``, ``stage`` waiting on a busy buffer, or
``extract`` reading x*), so
a traced run's device timeline is an untraced run's.

The shared clock: on, each span also opens a
``torch.profiler.record_function`` range named ``kmergma.<name>``, so any
profiler trace holds the program's spans beside the device's kernels and
copies.  ``enable()`` stores ``anchor()``: ``time.perf_counter_ns()`` and
``time.time_ns()`` read back to back.  ``to_unix_ns`` puts a span time on
the Unix clock in nanoseconds, the clock of the profiler's raw events
(``kineto_event.start_ns()``).
"""

from __future__ import annotations

import functools
import os
import sys
import time

#: each kernel wrapper's launch counter: (kernel, module, attribute of the
#: module, counter); a module not imported yet has launched nothing
KERNELS = (
    ("K1", "kmergma_tpu_torch.ops.scan_fused", "fused_record_bitmaps", "launches"),
    ("K2", "kmergma_tpu_torch.ops.scan_kernels", "match_counts", "launches"),
    ("K3", "kmergma_tpu_torch.ops.scan_cluster_fused", "fused_cluster_record_bitmaps", "launches"),
    ("K4", "kmergma_tpu_torch.ops.scan_kernels", "codes_pair_ab_kcodes", "launches"),
    ("K5", "kmergma_tpu_torch.ops.scan_kernels", "codes_pair_multi", "launches"),
    ("K6", "kmergma_tpu_torch.ops.scan_kernels", "pair_ab_from_kcodes", "launches"),
    ("K7", "kmergma_tpu_torch.bench", "hash_genome", "launches"),
    ("K8", "kmergma_tpu_torch.ops.scan_cluster_fused", "lookup_roundtrip", "launches"),
    ("R1", "kmergma_tpu_torch.ops.scan_kernels", "_R1", "launches"),
    ("R1.kernel", "kmergma_tpu_torch.ops.scan_kernels", "_R1", "kernel_launches"),
    ("A1", "kmergma_tpu_torch.ops.align_device", "align_dp", "launches"),
)

_on = False
_log: list[dict] = []
_stack: list[int] = []  # indices in _log of the open spans, innermost last
_call: "int | None" = None  # the open call's id
_call_counters: "dict | None" = None  # the open call span's counters
_calls = 0  # call ids handed out since the last reset
_anchor: "tuple[int, int] | None" = None


class _Noop:
    """The span of a tracer that is off: does nothing, and is false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counters) -> None:
        pass

    def __bool__(self) -> bool:
        return False


_NOOP = _Noop()


class _Span:
    """One recorded span; ``add`` sums counters into it."""

    __slots__ = ("record", "index", "range")

    def __init__(self, name: str):
        self.record = {"name": name, "start": None, "end": None, "parent": None, "call": None, "counters": {}}

    def __enter__(self):
        from torch.profiler import record_function

        rec = self.record
        # the span holds its profiler range: the clock is read before the
        # range opens and after it closes
        rec["start"] = time.perf_counter()
        self.range = record_function(f"kmergma.{rec['name']}")
        self.range.__enter__()
        rec["parent"] = _stack[-1] if _stack else None
        rec["call"] = _call
        self.index = len(_log)
        _log.append(rec)
        _stack.append(self.index)
        return self

    def __exit__(self, *exc):
        if _stack and _stack[-1] == self.index:
            _stack.pop()
        self.range.__exit__(*exc)
        self.record["end"] = time.perf_counter()
        return False

    def add(self, **counters) -> None:
        c = self.record["counters"]
        for key, value in counters.items():
            c[key] = c.get(key, 0) + value

    def __bool__(self) -> bool:
        return True


class _CallSpan(_Span):
    """The span of one API call: a new call id for every span inside it,
    and each kernel's launches over the call."""

    __slots__ = ("before", "outer")

    def __enter__(self):
        global _call, _call_counters, _calls
        self.outer = (_call, _call_counters)
        if _call is None:
            _call, _calls = _calls, _calls + 1
        super().__enter__()
        _call_counters = self.record["counters"]
        self.before = launch_counts()
        return self

    def __exit__(self, *exc):
        global _call, _call_counters
        after = launch_counts()
        self.record["counters"]["launches"] = {
            k: n - self.before.get(k, 0) for k, n in after.items() if n != self.before.get(k, 0)
        }
        super().__exit__(*exc)
        _call, _call_counters = self.outer
        return False


def span(name: str):
    """A context manager that records one span called ``name``, or the
    shared no-op while the tracer is off.  Both take ``add(**counters)``
    and are true only when recording."""
    if not _on:
        return _NOOP
    return _Span(name)


def api_call(fn):
    """Decorate an API entry point: each call runs in a ``call`` span."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _on:
            return fn(*args, **kwargs)
        with _CallSpan("call"):
            return fn(*args, **kwargs)

    return wrapper


def add_to_call(**counters) -> None:
    """Sum ``counters`` into the open ``call`` span, if there is one."""
    if _on and _call_counters is not None:
        for key, value in counters.items():
            _call_counters[key] = _call_counters.get(key, 0) + value


def launch_counts() -> dict[str, int]:
    """Every registered kernel wrapper's launch counter, by kernel
    (``KERNELS``), for the wrappers whose modules are imported."""
    out = {}
    for kernel, module, attr, counter in KERNELS:
        mod = sys.modules.get(module)
        if mod is not None:
            out[kernel] = int(getattr(getattr(mod, attr, None), counter, 0))
    return out


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn the tracer on and store the clock anchor."""
    global _on, _anchor
    _anchor = (time.perf_counter_ns(), time.time_ns())
    _on = True


def disable() -> None:
    """Turn the tracer off; the log is kept until ``reset()``."""
    global _on
    _on = False


def reset() -> None:
    """Empty the log and start the call ids again at 0; call it between
    API calls, with no span open."""
    global _log, _calls
    _log = []
    _stack.clear()
    _calls = 0


def log() -> list[dict]:
    """The spans recorded since the last ``reset()``, in the order they
    opened; a span still open has ``end`` None."""
    return _log


def anchor() -> "tuple[int, int] | None":
    """(``time.perf_counter_ns()``, ``time.time_ns()``) read back to back at
    the last ``enable()``, or None before it."""
    return _anchor


def to_unix_ns(t: float) -> int:
    """A span time (seconds of ``time.perf_counter``) in nanoseconds of the
    Unix clock, through ``anchor()``."""
    if _anchor is None:
        raise RuntimeError("the tracer has no clock anchor before enable()")
    perf_ns, unix_ns = _anchor
    return unix_ns + round(t * 1e9) - perf_ns


if os.environ.get("KMERGMA_TRACE") == "1":
    enable()
