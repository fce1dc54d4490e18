"""Multi-device scans (counterpart of ``kmergma_tpu.parallel``): the device
mesh (``mesh``), the sharded single-profile and cluster engines
(``sharded_scan``), behind ``find_genes(devices=N)`` and
``find_genes_cluster_mode(devices=N)``, and the profile-sharded engine
for big k (``tp_lookup.TPScanEngine``), which the miners take on their own
where several devices are present."""
