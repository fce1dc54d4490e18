"""Cluster mode past 32 clusters through the port's API
(``find_genes_cluster_mode``) against the JAX package's on the CPU: the
35 clusters of the Alp_V set on Loci.fasta, where the port raised before,
in one run and in a run killed and resumed.  The engine-level cases are
in ``tests/test_torch_cluster.py``; these API runs take a module of their
own, so that a run spread over workers by module holds them beside it."""

import os
import warnings

import pytest

import kmergma_tpu as jk
import kmergma_tpu_torch as kt
from kmergma_tpu.utils.fasta import as_records
from kmergma_tpu_torch.ops import scan_cluster as tcluster

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from .test_torch_cluster import _many, midpoints  # noqa: F401 (midpoints: a fixture)


@pytest.fixture(scope="module")
def q3(ref_fasta, test_genome, midpoints):
    """(cutoffs, the JAX API's hits and loci) of 35 clusters on Loci.fasta."""
    cut, clusters = _many(ref_fasta, midpoints, 35)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hits, loci = jk.find_genes_cluster_mode(test_genome, ref_fasta, cluster_cutoffs=cut, verbose=False,
                                                do_return_hit_loci=True)
    return cut, clusters, [(h.description, h.seq) for h in hits], loci


def test_many_clusters_api_matches_jax(ref_fasta, test_genome, q3):
    """``find_genes_cluster_mode`` with 35 clusters on Loci.fasta (where
    the port raised before) returns the JAX package's hits and loci."""
    cut, _clusters, want, want_loci = q3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hits, loci = kt.find_genes_cluster_mode(test_genome, ref_fasta, cluster_cutoffs=cut, verbose=False,
                                                do_return_hit_loci=True, device="cpu")
    assert [(h.description, h.seq) for h in hits] == want and loci == want_loci
    assert len(want) > 0


def test_many_clusters_kill_resume(ref_fasta, test_genome, q3, tmp_path, monkeypatch):
    """A 35-cluster run killed on its second record and resumed from its
    checkpoint scans only the records left and returns the JAX package's
    hits and loci of the whole run."""
    cut, clusters, want, want_loci = q3
    scanned = [0]
    real = tcluster.ClusterScanEngine.record_streams

    def counted(self, *a, **kw):
        scanned[0] += 1
        if scanned[0] == kill_at:
            raise KeyboardInterrupt("simulated kill")
        return real(self, *a, **kw)

    monkeypatch.setattr(tcluster.ClusterScanEngine, "record_streams", counted)
    ckpt = str(tmp_path / "many.ckpt")
    kw = dict(cluster_cutoffs=cut, verbose=False, do_return_hit_loci=True, checkpoint_path=ckpt, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kill_at = 2
        with pytest.raises(KeyboardInterrupt):
            kt.find_genes_cluster_mode(test_genome, ref_fasta, **kw)
        assert os.path.exists(ckpt)
        kill_at, scanned[0] = 0, 0
        hits, loci = kt.find_genes_cluster_mode(test_genome, ref_fasta, **kw)
    assert [(h.description, h.seq) for h in hits] == want and loci == want_loci
    # the miner scans the records longer than the cluster loop's bound
    n_records = sum(len(r) - max(clusters.windowsizes) - 6 + 2 >= 1 for r in as_records(test_genome))
    assert n_records > 2 and scanned[0] == n_records - 1 and not os.path.exists(ckpt)
