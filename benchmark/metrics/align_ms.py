"""align_ms: the miners' aligner (ops/align.py) where models/miner.py
calls ``align_hits_batch`` and models/omn_miner.py ``semiglobal_align_batch``;
self time summed a call, mean a traced call."""

from benchmark.harness.spans import self_ms_per_call

SPANS = {"align": [
    "kmergma_tpu_torch.models.miner:align_hits_batch",
    "kmergma_tpu_torch.models.omn_miner:semiglobal_align_batch",
]}


def read(run: dict) -> "float | None":
    return self_ms_per_call(run, "align")
