"""Recombination-signal-sequence (RSS) post-filtering for Ig-gene hits (the
port's copy of ``kmergma_tpu.ops.rss``; ref KmerGMA.jl src/RSS.jl, a WIP
feature in the reference, completed with the same constants and
semantics)."""

from __future__ import annotations

from .align import AlignResult, cigar_to_unitrange, semiglobal_align

#: Heptamer + 12/23-nt spacer + nonamer (ref RSS.jl:11-15)
HUMAN_RSSV = "CACAGTG" + "N" * 12 + "ACAAAAACC"
HUMAN_RSSD = "CACAGTG" + "N" * 23 + "ACAAAAACC"


def align_rss(
    seq: str, rss: str = HUMAN_RSSV, gap_open: int = -69, gap_extend: int = -1
) -> AlignResult:
    """Semi-global alignment of the RSS motif into a hit's flanking buffer
    (ref RSS.jl:18-20)."""
    return semiglobal_align(rss, seq, gap_open, gap_extend)


def rss_dist(rss1: str, rss2: str = HUMAN_RSSV) -> int:
    """Positional Hamming distance over rss1's length (ref RSS.jl:22-28)."""
    return sum(1 for a, b in zip(rss1.upper(), rss2.upper()) if a != b)


def is_rss(seq: str, rss: str = HUMAN_RSSV, thr: int = 1) -> bool:
    """True if the CIGAR-trimmed aligned region of ``seq`` is within ``thr``
    Hamming distance of the motif (ref RSS.jl:32-34)."""
    aln = align_rss(seq, rss)
    lo, hi = cigar_to_unitrange(aln)
    return rss_dist(seq.upper()[lo - 1 : hi], rss) <= thr
