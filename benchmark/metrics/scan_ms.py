"""scan_ms: the engine (ops/scan.py ScanEngine, ops/scan_cluster.py
ClusterScanEngine): a record's copies, bitmap pass, planned passes and
copy back, each span ending on a device synchronise; self time summed a
call, mean a traced call."""

from benchmark.harness.spans import self_ms_per_call

SPANS = {"scan": [
    "kmergma_tpu_torch.ops.scan:ScanEngine.record_stream",
    "kmergma_tpu_torch.ops.scan_cluster:ClusterScanEngine.record_streams",
]}


def read(run: dict) -> "float | None":
    return self_ms_per_call(run, "scan")
