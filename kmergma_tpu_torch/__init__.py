"""kmergma_tpu_torch: the homology scan of ``kmergma_tpu`` (single profile,
cluster mode and strobemers) on PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper.

The JAX package stays the reference; this package keeps its own copy of
the host modules it needs (FASTA parsing, reference profiles, thresholds,
the exact replays, the aligner and its native C++ library, the int64 host
engine) and ports what runs on the device.  It imports nothing of the JAX
package.  Every search runs on the card (``device="cuda"``, the default)
unless the caller asks for the CPU (``device="cpu"``).  Public API:
``find_genes``, ``find_genes_cluster_mode``, ``strobemer_find_genes``,
``write_results``, ``record_kmergma``, ``exact_match``, ``first_match``;
``python -m kmergma_tpu_torch`` is the command line, and
``python -m kmergma_tpu_torch.bench`` the throughput harness.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # the API is imported lazily to keep `import kmergma_tpu_torch` light
    if name in ("find_genes", "find_genes_cluster_mode", "strobemer_find_genes", "write_results"):
        from . import api

        return getattr(api, name)
    if name == "record_kmergma":
        from .models.miner import record_kmergma

        return record_kmergma
    if name in ("exact_match", "first_match"):
        from .ops import exact_match

        return getattr(exact_match, name)
    raise AttributeError(name)
