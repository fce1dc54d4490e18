"""replay_ms: the API layer's exact replay of the minima machine (the
program's ``replay`` spans, around models/state_machine.py
``replay_single`` and ``replay_omn`` in the miners); in cluster mode the
overlap checks and the formatting of each candidate run inside it, its
alignment is an ``align`` span within it and not counted here; self time
summed a call, mean a traced call (``harness.program_spans``)."""

from benchmark.harness import program_spans

__getattr__ = program_spans.module_getattr


def read(run: dict) -> "float | None":
    return program_spans.self_ms(run, "replay")
