"""Gapped k-mer-pair spectrum (the port's copy of
``kmergma_tpu.ops.paired_kmers``; ref KmerGMA.jl src/PairedKmers.jl).

The reference flags this module "has unfixed bugs, do not use; proof of
concept" (PairedKmers.jl:6) yet exports and unit-tests it, so its exact
behaviour is part of the conformance surface (reference
test-KmerGMA.jl:346-366) and is replicated here, including the quirk that
the second rolling register is NOT reset between outer-loop passes
(PairedKmers.jl:44-47):

    for i in 1:length(seq)-k+1            # outer register kmer_i rolls on
        for j in k:length(seq)            # inner register kmer_j is never
            kmer_j = (kmer_j << 2) & mask + code(seq[j])  # re-primed

so each pass starts from the register the previous pass left behind.

``kmer_pair_count`` is the host loop; ``kmer_pair_count_device`` gives the
same bins from three histograms on the card (torch ops: the JAX function it
mirrors is an XLA pass with no Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ..consts import encode_seq
from .scan import resolve_device, rolling_kmer_codes


def _codes(seq) -> np.ndarray:
    return seq if isinstance(seq, np.ndarray) else encode_seq(seq)


def initialize_kmers(seq, k: int) -> tuple[int, int]:
    """Prime both registers with the first k-1 bases (ref PairedKmers.jl:15-21)."""
    codes = _codes(seq)
    kmer = 0
    for c in codes[: k - 1]:
        kmer = (kmer << 2) + int(c)
    return kmer, kmer


def as_index(kmer1: int, kmer2: int, k: int) -> int:
    """1-based paired-spectrum index ((kmer2 << 2k) | kmer1) + 1
    (ref PairedKmers.jl:23-25)."""
    return ((kmer2 << (k << 1)) | kmer1) + 1


def kmer_pair_count(seq, k: int = 3) -> np.ndarray:
    """Paired k-mer spectrum, 4^(2k) float64 bins (ref PairedKmers.jl:36-50).

    O(n^2) nested rolling loop, replicated verbatim including the
    carried-over inner register.
    """
    bins = np.zeros(4 ** (2 * k), dtype=np.float64)
    kmer_pair_count_into(seq, k, bins)
    return bins


def kmer_pair_count_into(seq, k: int, bins: np.ndarray) -> None:
    """In-place variant (ref PairedKmers.jl:52-65)."""
    codes = _codes(seq)
    n = codes.shape[0]
    mask = (4**k) - 1
    kmer_i, kmer_j = initialize_kmers(codes, k)
    view = codes[k - 1 : n]  # Julia's view(seq, k:n)

    # Exact replication of the nested rolling registers.  The inner register
    # kmer_j deliberately persists across outer iterations.  After its first
    # full pass the register content at each inner position is
    # pass-invariant (the roll window saturates after k steps), so passes
    # 2..m share one precomputed index row - only pass 1 differs in its
    # first k-1 positions.
    m = view.shape[0]
    if m == 0:
        return

    # kmer_j values for pass 1 (carrying the initialisation register).
    kj = kmer_j
    pass1 = np.empty(m, dtype=np.int64)
    for t in range(m):
        kj = ((kj << 2) & mask) + int(view[t])
        pass1[t] = kj
    # steady-state pass: register carried from the end of the previous pass.
    pass_rest = np.empty(m, dtype=np.int64)
    for t in range(m):
        kj = ((kj << 2) & mask) + int(view[t])
        pass_rest[t] = kj
    # Passes 3.. equal pass 2 iff the carried register produces the same
    # values; after min(k-1, m) steps both agree, and the carry-in to every
    # pass >= 3 equals pass 2's carry-in (the last k-1 bases of view).
    # Verify cheaply and fall back to the literal loop if not.
    kj2 = int(pass_rest[-1])
    pass3 = np.empty(min(m, k), dtype=np.int64)
    for t in range(pass3.shape[0]):
        kj2 = ((kj2 << 2) & mask) + int(view[t])
        pass3[t] = kj2
    steady = np.array_equal(pass3, pass_rest[: pass3.shape[0]])

    ki = kmer_i
    for p in range(m):
        ki = ((ki << 2) & mask) + int(view[p])
        if p == 0:
            inner = pass1
        elif steady or p == 1:
            inner = pass_rest
        else:  # pragma: no cover - literal fallback
            inner = np.empty(m, dtype=np.int64)
            for t in range(m):
                kj = ((kj << 2) & mask) + int(view[t])
                inner[t] = kj
        idx = ((inner << (k << 1)) | ki)
        np.add.at(bins, idx, 1.0)


def kmer_pair_count_device(seq, k: int = 3, *, device: "str | torch.device" = "cuda") -> np.ndarray:
    """The paired spectrum from histograms on ``device`` (the card unless
    the caller asks for the CPU), bit-identical to ``kmer_pair_count``.

    Both registers are rolling k-mer code streams of the same sequence:
    the outer register ki[p] and the inner pass-1 stream are K =
    ``rolling_kmer_codes(codes, k)``; every later pass sees one steady-state
    stream that differs from K only in its first min(k - 1, m) codes, where
    the carried register still holds the sequence's tail.  Those head codes
    are the rolling codes of (the last k - 1 bases, then the first bases of
    the view).  The joint counts of passes p >= 1 therefore factor into an
    outer product of two histograms,

        bins[(v << 2k) | u] = cv[v] * cu[u]   (+ pass 0's column at u0 = K[0]),

    O(n + 4^2k) work instead of O(n^2).  The three histograms are
    ``torch.bincount`` on the device and cross in one copy; the outer
    product is float64 on the host (products up to n^2 exceed int32).
    """
    codes = _codes(seq)
    n = codes.shape[0]
    bins = np.zeros(4 ** (2 * k), dtype=np.float64)
    m = n - (k - 1)
    if m <= 0:
        return bins
    nb = 4**k
    dev = resolve_device(device)
    codes_dev = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
    kc = rolling_kmer_codes(codes_dev, k)  # ki[p] and the pass-1 stream
    h = min(k - 1, m)
    pass_rest = kc
    if h:
        tail = torch.cat([codes_dev[m:n], codes_dev[k - 1 : k - 1 + h]])
        pass_rest = torch.cat([rolling_kmer_codes(tail, k), kc[h:]])
    counts = torch.cat([
        torch.bincount(kc[1:], minlength=nb),  # cu: the outer register, passes p >= 1
        torch.bincount(pass_rest, minlength=nb),  # cv: the steady-state inner stream
        torch.bincount(kc, minlength=nb),  # c1: pass 0's inner stream
        kc[:1].to(torch.int64),  # u0: pass 0's outer code
    ]).cpu().numpy()
    cu, cv, c1 = (counts[i * nb : (i + 1) * nb].astype(np.float64) for i in range(3))
    out = cv[:, None] * cu[None, :]
    out[:, int(counts[-1])] += c1
    return out.reshape(-1)
