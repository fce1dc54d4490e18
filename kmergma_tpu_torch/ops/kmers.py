"""K-mer spectrum primitives: codecs, counting, distance.

TPU-native rebuild of the reference's L2 feature layer
(ref KmerGMA.jl src/Kmers.jl:14-60 for counting/distance semantics and
Kmers.jl:94-109 for the codecs).

Design notes (TPU-first):
  * A sequence's k-mers are materialised as a dense integer array
    ``K[i] = 2-bit code of the k-mer starting at i`` via k shifted adds -
    a vectorised equivalent of the reference's rolling 2-bit register
    (Kmers.jl:14-28).  Everything downstream (spectra, the scan) indexes
    with K instead of re-rolling registers.
  * Counting is a bincount (scatter-add) on host / ``segment_sum`` on device.
  * Counts are returned as float64 on host to match the reference's
    ``zeros()`` (Float64) bins; the scan path uses exact integer counts.
"""

from __future__ import annotations

import numpy as np

from ..consts import BITS_NT, encode_seq


def _as_codes(seq) -> np.ndarray:
    if isinstance(seq, np.ndarray) and seq.dtype != np.uint8:
        return seq.astype(np.int64)
    return encode_seq(seq).astype(np.int64)


def rolling_kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """K[i] = integer code of the k-mer ``codes[i:i+k]`` (MSB-first), length n-k+1.

    Matches the reference's rolling register semantics (Kmers.jl:14-28): the
    k-mer at 1-based end position i >= k corresponds to K[i-k] here.
    """
    codes = np.asarray(codes, dtype=np.int64)
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        return np.zeros(0, dtype=np.int64)
    out = np.zeros(m, dtype=np.int64)
    for t in range(k):
        out += codes[t : t + m] << (2 * (k - 1 - t))
    return out


def kmer_count(seq, k: int) -> np.ndarray:
    """Dense 4^k k-mer spectrum of ``seq`` (float64, like the reference's bins).

    Counts the n-k+1 k-mers of the sequence; N counts as T per the encoding
    contract (ref Consts.jl:27, Kmers.jl:14-28).
    """
    codes = _as_codes(seq)
    kk = rolling_kmer_codes(codes, k)
    return np.bincount(kk, minlength=4**k).astype(np.float64)


def kmer_count_into(seq, k: int, bins: np.ndarray) -> None:
    """In-place accumulate counts into ``bins`` (ref Kmers.jl:33-44)."""
    codes = _as_codes(seq)
    kk = rolling_kmer_codes(codes, k)
    np.add.at(bins, kk, 1.0)


def kmer_dist(seq1, seq2_or_profile, k: int) -> float:
    """(1/2k) * squared-Euclidean distance between k-mer spectra.

    Mirrors both reference overloads (Kmers.jl:54-60): the second argument
    may be a sequence or a precomputed k-mer frequency vector.
    """
    a = kmer_count(seq1, k)
    b = seq2_or_profile
    is_profile = isinstance(b, np.ndarray) and b.ndim == 1 and b.shape[0] == 4**k and b.dtype.kind == "f"
    if not is_profile:
        b = kmer_count(b, k)
    b = np.asarray(b, dtype=np.float64)
    d = a - b
    return float((1.0 / (2 * k)) * np.dot(d, d))


def as_uint(seq) -> int:
    """Sequence -> integer 2-bit code, MSB-first (ref Kmers.jl:101-107)."""
    codes = _as_codes(seq)
    v = 0
    for c in codes:
        v = (v << 2) | int(c)
    return v


def as_kmer(kmer_uint: int, kmer_len: int) -> str:
    """Integer code -> k-mer string.

    The reference decodes LSB-first bit pairs through an intentionally
    bit-swapped dict (Kmers.jl:68-92); the two transforms cancel, leaving a
    plain MSB-first decode - pinned by the round-trip test
    (reference test-KmerGMA.jl:23-24).
    """
    out = []
    for _ in range(kmer_len):
        out.append(BITS_NT[kmer_uint & 3])
        kmer_uint >>= 2
    return "".join(reversed(out))
