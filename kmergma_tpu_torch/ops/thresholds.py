"""Distance-threshold estimation and mutation simulation
(ref KmerGMA.jl src/DistanceTesting.jl).

The estimator is BIT-EXACT with the reference: Julia's seeded task-local
Xoshiro256++ stream and BioSequences' ``randdnaseq`` sampling are replicated
in ``utils/julia_rand.py``, so ``estimate_optimal_threshold`` reproduces the
reference's golden values (27 with buffer 12; [38,33,41,37,29] for the five
clusters, test-KmerGMA.jl:114-126) and the default ``find_genes`` threshold
lands on the same side of every knife-edge window as the reference.
"""

from __future__ import annotations

import numpy as np

from ..utils import native
from ..utils.julia_rand import JuliaXoshiro, mutate_seq_julia, randdnaseq_codes_batch
from .kmers import kmer_dist

#: the most bytes of k-mer counts that one block of trials holds: 32
#: trials a block at k 6, one from k 9 up
_BLOCK_BYTES = 1 << 20

#: what the last estimate did, for the API's ``prep`` span: random
#: sequences scored, u64s drawn, and 1 where the native library drew them
last_counters = {"trials": 0, "draws": 0, "rng_native": 0}


def _distance_sum(rng: JuliaXoshiro, kfv: np.ndarray, k: int, length: int, num_trials: int) -> float:
    """The sum, in trial order, of ``kmer_dist`` of ``num_trials`` random
    sequences of ``length`` drawn from ``rng`` in turn to the profile
    ``kfv``, bit for bit.  The k-mers of a block of trials are counted at
    once into one reused buffer (``np.add.at``; ``bincount``, which
    allocates its counts anew each block, took 19.1 against 10.9 ms for the
    Alp_V clusters on an 8-core x86 host), each trial's codes
    offset by its row in the block times 4^k; each distance is
    ``kmer_dist``'s ``np.dot`` on its own contiguous row of counts less
    ``kfv``.  Counts of ones are exact in float64, so each row equals
    ``kmer_count`` less ``kfv``."""
    nbins = 4**k
    kfv = np.asarray(kfv, dtype=np.float64)
    scale = 1.0 / (2 * k)
    block = max(1, _BLOCK_BYTES // (nbins * 8))
    m = max(length - k + 1, 0)
    codes = randdnaseq_codes_batch(rng, num_trials, length).astype(np.int64)
    kmers = np.zeros((num_trials, m), dtype=np.int64)
    for t in range(k):
        kmers += codes[:, t : t + m] << (2 * (k - 1 - t))
    kmers += (np.arange(num_trials, dtype=np.int64) % block)[:, None] * nbins
    d = np.empty((min(block, num_trials), nbins))
    total = 0.0
    for first in range(0, num_trials, block):
        rows = kmers[first : first + block]
        dd = d[: rows.shape[0]]
        dd.fill(0.0)
        np.add.at(dd.reshape(-1), rows.ravel(), 1.0)
        dd -= kfv
        for row in dd:
            total += float(scale * np.dot(row, row))
    last_counters["trials"] += num_trials
    last_counters["draws"] += num_trials * -(-length // 16)
    return total


def _start_counters() -> None:
    last_counters.update(trials=0, draws=0, rng_native=int(native.get_lib() is not None))


def estimate_optimal_threshold(
    mean_kfv: np.ndarray,
    average_length: int,
    seed: int = 42,
    num_trials: int = 100,
    buffer: float = 8.0,
) -> float:
    """Mean distance of seeded-random sequences to the profile, minus
    ``buffer`` (ref DistanceTesting.jl:8-17).  Bit-exact with Julia."""
    from ..consts import get_k

    _start_counters()
    rng = JuliaXoshiro(seed)
    k = get_k(mean_kfv.shape[0])
    return _distance_sum(rng, mean_kfv, k, average_length, num_trials) / num_trials - buffer


def estimate_optimal_thresholds(
    mean_kfvs: list[np.ndarray],
    average_lengths: list[int],
    seed: int = 42,
    num_trials: int = 100,
    buffer: float = 8.0,
) -> list[float]:
    """Cluster-mode overload: one RNG stream shared across clusters in order
    (ref DistanceTesting.jl:19-32 seeds once before the loop)."""
    from ..consts import get_k

    _start_counters()
    rng = JuliaXoshiro(seed)
    k = get_k(mean_kfvs[0].shape[0])
    return [
        _distance_sum(rng, kfv, k, length, num_trials) / num_trials - buffer
        for kfv, length in zip(mean_kfvs, average_lengths)
    ]


def mutate_seq(seq: str, mut_rate: float, seed: int | None = None) -> str:
    """String-level mutation helper (ref DistanceTesting.jl:57-67).

    With a seed, matches Julia's ``Random.seed!(seed); mutate_seq(...)``
    bit-for-bit (goldens dna"AGGC"/"AGGCGTCC", test-KmerGMA.jl:122-125).
    """
    from ..consts import decode_seq, encode_seq

    rng = JuliaXoshiro(seed if seed is not None else np.random.randint(0, 2**31))
    return decode_seq(mutate_seq_julia(encode_seq(seq), mut_rate, rng))


def substitution_distance_sweep(
    mean_kfv: np.ndarray,
    base_seq_codes: np.ndarray,
    num_seeds: int = 42,
    stepsize: float = 0.0125,
) -> np.ndarray:
    """Distance-vs-mutation-rate sweep (ref DistanceTesting.jl:69-84's
    gen_sub_vs_ref, returning the data instead of a Plots scatter).

    Returns an array of shape (num_seeds, n_steps): for each seed, the
    k-mer distance of the progressively mutated sequence to the profile at
    mutation rates 0, stepsize, ..., 1 (seeded Random.seed!(seed) per row,
    like the reference).
    """
    from ..consts import get_k

    k = get_k(mean_kfv.shape[0])
    rates = np.arange(0.0, 1.0 + 1e-12, stepsize)
    out = np.empty((num_seeds, rates.shape[0]), dtype=np.float64)
    for s in range(num_seeds):
        rng = JuliaXoshiro(s + 1)
        for i, rate in enumerate(rates):
            mutated = mutate_seq_codes(base_seq_codes, float(rate), rng)
            out[s, i] = kmer_dist(mutated, mean_kfv, k)
    return out


def strobemer_distance_sweep(
    base_seq_codes: np.ndarray,
    s: int = 2,
    w_min: int = 3,
    w_max: int = 5,
    q: int = 5,
    num_trials: int = 10,
    stepsize: float = 0.05,
    seed: int = 42,
) -> np.ndarray:
    """Mutation-rate sweep of strobemer-spectrum distance
    (ref StrobemerGMA/MonteCarloBenchmark.jl:2-23, made callable).

    Returns (num_trials, n_steps) distances between the base sequence's
    strobemer spectrum and progressively mutated copies.
    """
    from .strobemers import ungapped_strobe_2_mer_count

    k_eff = w_max + s - 1
    base = ungapped_strobe_2_mer_count(base_seq_codes, s, w_min, w_max, q)
    rates = np.arange(0.0, 1.0 + 1e-12, stepsize)
    out = np.empty((num_trials, rates.shape[0]), dtype=np.float64)
    rng = JuliaXoshiro(seed)
    for t in range(num_trials):
        for i, rate in enumerate(rates):
            mutated = mutate_seq_codes(base_seq_codes, float(rate), rng)
            spec = ungapped_strobe_2_mer_count(mutated, s, w_min, w_max, q)
            diff = base - spec
            out[t, i] = (1.0 / (2 * k_eff)) * float(np.dot(diff, diff))
    return out


def mutate_seq_codes(codes: np.ndarray, mut_rate: float, rng: JuliaXoshiro) -> np.ndarray:
    """Random substitution of ~``mut_rate`` of positions to a different base
    (ref DistanceTesting.jl:38-67), Julia-RNG-exact.  Returns a new array."""
    return mutate_seq_julia(codes, mut_rate, rng)
