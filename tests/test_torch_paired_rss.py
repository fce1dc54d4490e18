"""The port's paired k-mers, RSS filter and ``mutation_plot``
(kmergma_tpu_torch.ops.paired_kmers, .ops.rss, .utils.plots) against the
reference goldens of tests/test_paired_strobe_rss.py and tests/test_plots.py
and against the JAX package, with the same seeded inputs through both
(tests/test_torch_host.py holds the host functions against their
originals).
Zero tolerance: the spectra are float64 sums and products of integer
counts.

The module imports the JAX package only inside the tests that compare with
it, so on a GPU host without jax its card test runs as
    python -m pytest --noconftest -m cuda tests/test_torch_paired_rss.py
"""

import numpy as np
import pytest
import torch

from kmergma_tpu_torch.ops.kmers import as_kmer, as_uint
from kmergma_tpu_torch.ops.paired_kmers import (
    as_index,
    initialize_kmers,
    kmer_pair_count,
    kmer_pair_count_device,
    kmer_pair_count_into,
)
from kmergma_tpu_torch.ops.rss import HUMAN_RSSV, align_rss, is_rss, rss_dist

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

TEST_SEQ = "ATGCATGC"  # the reference harness's sequence (tests/conftest.py)


class TestPairedKmers:
    def test_initialize(self):
        assert initialize_kmers(TEST_SEQ, 6) == (228, 228)
        assert as_kmer(initialize_kmers(TEST_SEQ, 3)[0], 2) == "AT"

    def test_as_index(self):
        assert as_index(as_uint("ATGC"), as_uint("ATGC"), 4) == 14650

    def test_pair_count_golden(self):
        assert kmer_pair_count(TEST_SEQ, 1).tolist() == [4.0] * 16
        b2 = kmer_pair_count(TEST_SEQ, 2)
        assert b2.sum() == 49.0
        assert round(float(b2.mean()), 5) == 0.19141

    def test_pair_count_into(self):
        bins = np.zeros(16)
        kmer_pair_count_into(TEST_SEQ, 1, bins)
        assert bins.tolist() == [4.0] * 16
        bins = np.zeros(256)
        kmer_pair_count_into(TEST_SEQ, 2, bins)
        assert bins.sum() == 49.0
        assert round(float(bins.mean()), 5) == 0.19141


class TestRSS:
    def test_align_rss_cigar(self):
        window = (TEST_SEQ + HUMAN_RSSV + TEST_SEQ)[:44]
        assert align_rss(window).cigar == "8D28=8D"

    def test_rss_dist(self):
        assert rss_dist(HUMAN_RSSV, HUMAN_RSSV) == 0
        assert rss_dist(HUMAN_RSSV[:-1] + "T", HUMAN_RSSV) == 1

    def test_is_rss(self):
        window = (TEST_SEQ + HUMAN_RSSV + TEST_SEQ)[:44]
        assert is_rss(window) is True
        assert is_rss(TEST_SEQ * 6) is False


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_paired_kmer_device_matches_host_fuzz(k):
    """``kmer_pair_count_device`` on the CPU equals the port's host loop
    and the JAX package's device function bit for bit, at every length
    from 0 to 3k (the carried register's head is min(k - 1, m) codes long)
    and at longer ones."""
    from kmergma_tpu.ops.paired_kmers import kmer_pair_count_device as jax_device

    rng = np.random.default_rng(3 + k)
    for n in [*range(3 * k + 1), 50, 333]:
        codes = rng.integers(0, 4, n, dtype=np.int8)
        host = kmer_pair_count(codes, k)
        got = kmer_pair_count_device(codes, k, device="cpu")
        assert got.dtype == np.float64 and got.shape == (4 ** (2 * k),)
        assert got.tolist() == host.tolist(), (k, n)
        assert got.tolist() == jax_device(codes, k).tolist(), (k, n)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 40))
    assert kmer_pair_count_device(seq, k, device="cpu").tolist() == kmer_pair_count(seq, k).tolist()


def test_mutation_plot_saves_figure(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from kmergma_tpu_torch.ops.kmers import kmer_count
    from kmergma_tpu_torch.ops.thresholds import substitution_distance_sweep
    from kmergma_tpu_torch.utils.plots import mutation_plot

    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, 150, dtype=np.int8)
    mean_kfv = kmer_count(base, 4).astype(np.float64)
    sweep = substitution_distance_sweep(mean_kfv, base, num_seeds=3, stepsize=0.25)
    out = tmp_path / "sweep.png"
    fig = mutation_plot(sweep, 0.25, save_path=str(out))
    assert out.exists() and out.stat().st_size > 1000
    assert fig.axes[0].get_xlabel() == "mutation rate"
    assert [len(c.get_offsets()) for c in fig.axes[0].collections] == [sweep.shape[1]] * 3
    np.testing.assert_array_equal(fig.axes[0].lines[0].get_ydata(), sweep.mean(axis=0))


@pytest.mark.cuda
def test_paired_spectrum_on_card_matches_cpu():
    """The histograms on the card give the CPU's spectrum, bit for bit, on
    a seeded 1 Mbp sequence and at the short lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    for k in (1, 3, 5):
        for n in (0, k - 1, k, 2 * k, 1_000_000):
            codes = rng.integers(0, 4, n, dtype=np.int8)
            got = kmer_pair_count_device(codes, k, device="cuda")
            assert got.tolist() == kmer_pair_count_device(codes, k, device="cpu").tolist(), (k, n)
    codes = rng.integers(0, 4, 2_000, dtype=np.int8)
    assert kmer_pair_count_device(codes, 3, device="cuda").tolist() == kmer_pair_count(codes, 3).tolist()
