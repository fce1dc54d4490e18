"""kmergma_tpu_torch: the homology scan of ``kmergma_tpu`` (single profile,
cluster mode and strobemers) on PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper.

The JAX package stays the reference; this package keeps its own copy of
the host modules it needs (FASTA parsing, reference profiles, thresholds,
the exact replays, the aligner and its native C++ library, the int64 host
engine) and ports what runs on the device.  It imports nothing of the JAX
package.  Every search runs on the card (``device="cuda"``, the default)
unless the caller asks for the CPU (``device="cpu"``).  Public API:
``find_genes``, ``find_genes_cluster_mode``, ``strobemer_find_genes`` (each
with ``checkpoint_path=`` for per-record resume), ``write_results``,
``record_kmergma``, ``exact_match``, ``first_match``, and every other name
the JAX package exports (codecs, k-mer spectra, profiles and clusters,
thresholds and sweeps, strobemer counts, paired k-mers, RSS,
``mutation_plot``); ``python -m kmergma_tpu_torch`` is the command line,
and ``python -m kmergma_tpu_torch.bench`` the throughput harness.
"""

__version__ = "0.1.0"


# every public name of the JAX package, by the module of the port that holds
# it; each module is imported on first use, to keep `import kmergma_tpu_torch`
# light
_EXPORTS = {
    ".api": ("find_genes", "find_genes_cluster_mode", "strobemer_find_genes", "write_results"),
    ".models.miner": ("record_kmergma",),
    ".ops.exact_match": ("exact_match", "first_match"),
    ".consts": ("NT_BITS", "encode_seq", "decode_seq", "get_k"),
    ".ops.kmers": ("kmer_count", "kmer_dist", "as_kmer", "as_uint"),
    ".ops.consensus": ("Profile",),
    ".ops.reference": ("gen_ref_ws_cons", "cluster_ref_api", "eliminate_null_params", "get_cluster_index"),
    ".ops.thresholds": (
        "estimate_optimal_threshold", "estimate_optimal_thresholds",
        "substitution_distance_sweep", "strobemer_distance_sweep", "mutate_seq",
    ),
    ".ops.paired_kmers": (
        "kmer_pair_count", "kmer_pair_count_into", "kmer_pair_count_device", "as_index", "initialize_kmers",
    ),
    ".ops.strobemers": ("get_strobe_2_mer", "randstrobe_score", "ungapped_strobe_2_mer_count"),
    ".ops.rss": ("HUMAN_RSSV", "HUMAN_RSSD", "align_rss", "rss_dist", "is_rss"),
    ".utils.fasta": ("fasta_id_to_cumulative_len_dict",),
    ".utils.plots": ("mutation_plot",),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}


def __getattr__(name):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(module, __name__), name)
