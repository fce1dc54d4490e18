"""Multi-device scans (counterpart of ``kmergma_tpu.parallel``): the device
mesh (``mesh``), the sharded single-profile and cluster engines
(``sharded_scan``), behind ``find_genes(devices=N)`` and
``find_genes_cluster_mode(devices=N)``, the two-axis step
(``sharded_cluster_scan_step`` on ``make_tiles``' tiles), and the
profile-sharded engine for big k (``tp_lookup.TPScanEngine``), which the
miners take on their own where several devices are present."""

from .mesh import make_mesh
from .sharded_scan import ShardedClusterScanEngine, ShardedScanEngine, make_tiles, sharded_cluster_scan_step
from .tp_lookup import TPScanEngine

__all__ = ["ShardedClusterScanEngine", "ShardedScanEngine", "TPScanEngine", "make_mesh", "make_tiles",
           "sharded_cluster_scan_step"]
