"""stage_ms: the engine's copies of host codes to the card (the program's
``stage`` spans, ops/scan.py ``PinnedStaging.to_device``, the miners'
prefetch included): the host's fill of a pinned buffer and its wait on a
copy still reading that buffer; self time summed a call, mean a traced
call.  The program's tracer is on for the traced run alone
(``harness.program_spans``)."""

from benchmark.harness import program_spans

__getattr__ = program_spans.module_getattr


def read(run: dict) -> "float | None":
    return program_spans.self_ms(run, "stage")
