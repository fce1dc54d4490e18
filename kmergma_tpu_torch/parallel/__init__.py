"""Multi-device scans (counterpart of ``kmergma_tpu.parallel``): the device
mesh (``mesh``) and the sharded single-profile and cluster engines
(``sharded_scan``), behind ``find_genes(devices=N)`` and
``find_genes_cluster_mode(devices=N)``."""
