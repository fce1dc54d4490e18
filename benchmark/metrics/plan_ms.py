"""plan_ms: the engine's planned pass (the program's ``plan`` spans,
ops/scan.py ``_planned_streams``): the region plan, the K2 recompute and
R1 queued from the host, and the stream assembly from R1's fetched
buffer; the fetch itself is ``fetch_ms``; self time summed a call, mean a
traced call (``harness.program_spans``)."""

from benchmark.harness import program_spans

__getattr__ = program_spans.module_getattr


def read(run: dict) -> "float | None":
    return program_spans.self_ms(run, "plan")
