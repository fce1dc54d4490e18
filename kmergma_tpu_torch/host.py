"""The host-side pieces the port shares with ``kmergma_tpu``, by import.

FASTA parsing, the reference profile and its clusters, the threshold
estimates, the exact replays of the single and cluster minima state
machines, the alignment trim and the exact int64 host engine are numpy and native C++ with no JAX in them, and they are
golden-pinned: a second copy would drift.  Every name the port takes from
the JAX package comes through this module, so it is the one list of what
is shared.  Importing it leaves ``jax`` out of ``sys.modules``
(tests/test_torch_api.py).
"""

from kmergma_tpu.models.state_machine import OmnHitEvent, replay_omn, replay_single
from kmergma_tpu.ops.align import (
    AlignResult,
    cigar_to_unitrange,
    semiglobal_align,
    semiglobal_align_batch,
)
from kmergma_tpu.ops.reference import (
    ClusterRefs,
    RefProfile,
    cluster_ref_api,
    eliminate_null_params,
    gen_ref_ws_cons,
)
from kmergma_tpu.ops.scan_host import HostScanEngine
from kmergma_tpu.ops.thresholds import estimate_optimal_threshold, estimate_optimal_thresholds
from kmergma_tpu.utils.fasta import FastaRecord, PathOrRecords, as_records, write_fasta
from kmergma_tpu.utils.native import scan_rolling_i64_native

__all__ = [
    "AlignResult",
    "ClusterRefs",
    "FastaRecord",
    "HostScanEngine",
    "OmnHitEvent",
    "PathOrRecords",
    "RefProfile",
    "as_records",
    "cigar_to_unitrange",
    "cluster_ref_api",
    "eliminate_null_params",
    "estimate_optimal_threshold",
    "estimate_optimal_thresholds",
    "gen_ref_ws_cons",
    "replay_omn",
    "replay_single",
    "scan_rolling_i64_native",
    "semiglobal_align",
    "semiglobal_align_batch",
    "write_fasta",
]
