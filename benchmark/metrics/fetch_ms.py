"""fetch_ms: the engine's blocking reads of the card (the program's
``fetch`` spans, ops/scan.py ``fetch`` and K1's and K3's int32 check):
the host's wait for the work queued before each copy back, and the copy;
self time summed a call, mean a traced call (``harness.program_spans``)."""

from benchmark.harness import program_spans

__getattr__ = program_spans.module_getattr


def read(run: dict) -> "float | None":
    return program_spans.self_ms(run, "fetch")
