"""kmergma_tpu_torch: the homology scan of ``kmergma_tpu`` (single profile
and cluster mode) on PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper.

The JAX package stays the reference; this package reuses its JAX-free host
modules by import (all through ``kmergma_tpu_torch.host``) and ports what
runs on the device.  Public API:
``find_genes``, ``find_genes_cluster_mode``, ``write_results``,
``record_kmergma``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # the API is imported lazily to keep `import kmergma_tpu_torch` light
    if name in ("find_genes", "find_genes_cluster_mode", "write_results"):
        from . import api

        return getattr(api, name)
    if name == "record_kmergma":
        from .models.miner import record_kmergma

        return record_kmergma
    raise AttributeError(name)
