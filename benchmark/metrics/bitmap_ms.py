"""bitmap_ms: the engine's block bitmap pass (the program's ``bitmap``
spans: ops/scan.py ``ScanEngine._record_bitmap``, each segment of a long
record too, and ops/scan_cluster.py ``ClusterScanEngine._bitmaps``): the
host's launches of K1, K3 or K5 and the torch glue around them; a wait
for K1's or K3's int32 check is a ``fetch`` inside it; self time summed a
call, mean a traced call (``harness.program_spans``)."""

from benchmark.harness import program_spans

__getattr__ = program_spans.module_getattr


def read(run: dict) -> "float | None":
    return program_spans.self_ms(run, "bitmap")
