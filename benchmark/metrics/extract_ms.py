"""extract_ms: the strobemer miner's randstrobe extraction (the program's
``extract`` spans, models/strobe_miner.py around ops/strobemers.py
``strobe_2_mer_codes_torch``): the host's launches of the extraction's
torch operations and its wait for them as it reads the record's x*; self
time summed a call, mean a traced call (``harness.program_spans``)."""

from benchmark.harness import program_spans

__getattr__ = program_spans.module_getattr


def read(run: dict) -> "float | None":
    return program_spans.self_ms(run, "extract")
