"""Reference preparation: the mean k-mer profile, windowsize and consensus
of a reference set, its clusters, and the Julia-exact distance thresholds.

Frozen copy, at commit 643846b, of the plain NumPy code of
kmergma_tpu_torch/ops/reference.py (``gen_ref_ws_cons``,
``cluster_ref_api``, ``eliminate_null_params``), ops/kmers.py (counting,
``kmer_dist``), ops/consensus.py (``Profile``) and ops/thresholds.py
(``estimate_optimal_threshold(s)``), which follow KmerGMA.jl
src/ReferenceGeneration.jl, Kmers.jl, Consensus.jl and DistanceTesting.jl
operation for operation, so that the float profile and the thresholds are
bit-identical to the upstream's.  Each profile also carries the exact
integer summed spectrum and its record count, from which the scan's
distances are exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .fasta import encode
from .julia_rand import JuliaXoshiro, randdnaseq_codes


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Code of the k-mer at each position, most significant base first."""
    codes = np.asarray(codes, dtype=np.int64)
    m = codes.shape[0] - k + 1
    out = np.zeros(max(m, 0), dtype=np.int64)
    for t in range(k):
        out += codes[t : t + m] << (2 * (k - 1 - t))
    return out


def kmer_count(codes: np.ndarray, k: int) -> np.ndarray:
    return np.bincount(kmer_codes(codes, k), minlength=4**k).astype(np.float64)


def kmer_dist(codes: np.ndarray, profile: np.ndarray, k: int) -> float:
    """(1/2k) times the squared Euclidean distance of the spectra."""
    d = kmer_count(codes, k) - profile
    return float((1.0 / (2 * k)) * np.dot(d, d))


@dataclass
class RefProfile:
    mean_kfv: np.ndarray  # float64[4^k]
    sum_kfv: np.ndarray  # int64[4^k], the exact sum over the set
    n_records: int
    windowsize: int
    consensus: str
    k: int


def _consensus(counts: np.ndarray) -> str:
    return np.frombuffer(b"ACGT", dtype=np.uint8)[np.argmax(counts, axis=0)].tobytes().decode("ascii")


def _add_positions(counts: np.ndarray, codes: np.ndarray) -> None:
    np.add.at(counts[:, : codes.shape[0]], (codes.astype(np.int64), np.arange(codes.shape[0])), 1)


def gen_ref_ws_cons(records: list[tuple[str, bytes]], k: int) -> tuple[RefProfile, int]:
    """(profile, longest record) of a reference set (ReferenceGeneration.jl:4-41)."""
    sums = np.zeros(4**k, dtype=np.float64)
    counts = np.zeros((4, 1), dtype=np.int64)
    n, cum, maxlen = 0, 0, 0
    for _, seq in records:
        codes = encode(seq)
        n += 1
        cum += codes.shape[0]
        maxlen = max(maxlen, codes.shape[0])
        np.add.at(sums, kmer_codes(codes, k), 1.0)
        if codes.shape[0] > counts.shape[1]:
            counts = np.concatenate([counts, np.zeros((4, codes.shape[0] - counts.shape[1]), np.int64)], axis=1)
        _add_positions(counts, codes)
    inv = 1.0 / n
    return RefProfile(sums * inv, sums.astype(np.int64), n, int(np.round(cum * inv)), _consensus(counts), k), maxlen


def _cluster_index(value: float, cutoffs: list) -> int:
    ans = 1
    for num in cutoffs:
        if value <= num:
            return ans
        ans += 1
    return ans


def cluster_profiles(records: list[tuple[str, bytes]], k: int, cutoffs: list) -> list[RefProfile]:
    """The non-empty clusters, then the whole set's profile
    (ReferenceGeneration.jl:75-138 and 152-168): each record goes to the
    bucket of its distance to the mean; a cluster's consensus is cut to its
    windowsize, the appended average keeps its whole consensus."""
    avg, maxlen = gen_ref_ws_cons(records, k)
    m = len(cutoffs) + 1
    sums = [np.zeros(4**k, dtype=np.float64) for _ in range(m)]
    ws_sums, lens = [0] * m, [0] * m
    counts = [np.zeros((4, maxlen), dtype=np.int64) for _ in range(m)]
    for _, seq in records:
        codes = encode(seq)
        ci = _cluster_index(kmer_dist(codes, avg.mean_kfv, k), cutoffs) - 1
        _add_positions(counts[ci], codes)
        ws_sums[ci] += codes.shape[0]
        lens[ci] += 1
        np.add.at(sums[ci], kmer_codes(codes, k), 1.0)
    out = []
    for i in range(m):
        if lens[i]:
            ws = int(np.round(ws_sums[i] / lens[i]))
            out.append(RefProfile(sums[i] / lens[i], sums[i].astype(np.int64), lens[i], ws, _consensus(counts[i])[:ws], k))
    out.append(avg)
    return out


def estimate_optimal_thresholds(profiles: list[RefProfile], buffer: float, seed: int = 42, num_trials: int = 100) -> list[float]:
    """Mean distance of Julia's seeded random sequences to each profile,
    less ``buffer``, one stream across the profiles in order
    (DistanceTesting.jl:8-32); one profile gives the single-profile value."""
    rng = JuliaXoshiro(seed)
    out = []
    for p in profiles:
        total = 0.0
        for _ in range(num_trials):
            total += kmer_dist(randdnaseq_codes(rng, p.windowsize), p.mean_kfv, p.k)
        out.append(total / num_trials - buffer)
    return out
