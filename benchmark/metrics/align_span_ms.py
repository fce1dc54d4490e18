"""align_span_ms: the aligner as the program's own ``align`` spans time it
(ops/align.py ``semiglobal_align_batch``, the native host DP, and
``align_hits_batch``'s device route), wherever a miner calls it; the
strobemer miner's calls included, which ``align_ms``'s wrappers do not
reach; self time summed a call, mean a traced call
(``harness.program_spans``)."""

from benchmark.harness import program_spans

__getattr__ = program_spans.module_getattr


def read(run: dict) -> "float | None":
    return program_spans.self_ms(run, "align")
