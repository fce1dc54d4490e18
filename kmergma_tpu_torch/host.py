"""The host-side pieces the port shares with ``kmergma_tpu``, by import.

FASTA parsing, the reference profile, the threshold estimate, the exact
replay of the minima state machine, the alignment trim and the exact int64
host engine are numpy and native C++ with no JAX in them, and they are
golden-pinned: a second copy would drift.  Every name the port takes from
the JAX package comes through this module, so it is the one list of what
is shared.  Importing it leaves ``jax`` out of ``sys.modules``
(tests/test_torch_api.py).
"""

from kmergma_tpu.models.state_machine import replay_single
from kmergma_tpu.ops.align import (
    AlignResult,
    cigar_to_unitrange,
    semiglobal_align,
    semiglobal_align_batch,
)
from kmergma_tpu.ops.reference import RefProfile, gen_ref_ws_cons
from kmergma_tpu.ops.scan_host import HostScanEngine
from kmergma_tpu.ops.thresholds import estimate_optimal_threshold
from kmergma_tpu.utils.fasta import FastaRecord, PathOrRecords, as_records, write_fasta
from kmergma_tpu.utils.native import scan_rolling_i64_native

__all__ = [
    "AlignResult",
    "FastaRecord",
    "HostScanEngine",
    "PathOrRecords",
    "RefProfile",
    "as_records",
    "cigar_to_unitrange",
    "estimate_optimal_threshold",
    "gen_ref_ws_cons",
    "replay_single",
    "scan_rolling_i64_native",
    "semiglobal_align",
    "semiglobal_align_batch",
    "write_fasta",
]
