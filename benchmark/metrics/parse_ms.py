"""parse_ms: host input, the FASTA parse (utils/fasta.py, native/fastaio.cpp)
where the miners call ``as_records``; self time, mean a traced call."""

from benchmark.harness.spans import self_ms_per_call

SPANS = {"parse": [
    "kmergma_tpu_torch.models.miner:as_records",
    "kmergma_tpu_torch.models.omn_miner:as_records",
]}


def read(run: dict) -> "float | None":
    return self_ms_per_call(run, "parse")
