"""prep_ms: reference preparation (ops/reference.py, ops/thresholds.py) as
api.py calls it: the profile or the clusters, and the threshold estimate;
self time, mean a traced call."""

from benchmark.harness.spans import self_ms_per_call

SPANS = {"prep": [
    "kmergma_tpu_torch.api:gen_ref_ws_cons",
    "kmergma_tpu_torch.api:cluster_ref_api",
    "kmergma_tpu_torch.api:eliminate_null_params",
    "kmergma_tpu_torch.api:estimate_optimal_threshold",
    "kmergma_tpu_torch.api:estimate_optimal_thresholds",
]}


def read(run: dict) -> "float | None":
    return self_ms_per_call(run, "prep")
