"""Bit-exact replica of Julia's default RNG pipeline for threshold goldens.

The reference pins `estimate_optimal_threshold` outputs via Julia's seeded
task-local RNG (`Random.seed!(42)` + BioSequences `randdnaseq`,
ref KmerGMA.jl src/DistanceTesting.jl:8-32 and
KmerGMA.jl test/test_folder/test-KmerGMA.jl:114-126).  Julia >= 1.7
(Project.toml compat) uses Xoshiro256++ seeded by SHA-256 of the
little-endian UInt32 limbs of the seed, so the whole stream is replicable:

  * ``JuliaXoshiro`` - Xoshiro256++ core with Julia's integer seeding
    (julia stdlib Random/src/Xoshiro.jl: ``seed!`` hashes ``make_seed(n)``,
    a UInt32-limb vector, with SHA-256 into the four state words);
  * ``rand_float64`` - Julia's CloseOpen01: ``(u >> 11) * 2.0^-53``;
  * ``rand_index`` - Julia's near-division-less Lemire range sampler
    (Random/src/generation.jl SamplerRangeNDL), used by ``rand(1:n)`` and
    vector sampling ``rand(v)``;
  * ``rand_u64s`` - the next n draws at once, from one call of the
    native library (``utils/native.py``), else a Python loop;
  * ``randdnaseq_codes`` - BioSequences v3 ``randseq(::DNAAlphabet{4})``:
    one ``rand(UInt64)`` per 16-nucleotide chunk; the packed chunk is built
    by a shift-left loop over the draw's low 32 bits, so chunk nucleotide j
    reads 2-bit value ``(x >> (32 - 2j)) & 3`` (validated empirically: the
    ONLY bit order reproducing both reference threshold goldens 27 and
    [38,33,41,37,29], plus the knife-edge default ``find_genes`` hit set -
    see tests/test_thresholds.py);
  * ``mutate_seq_julia`` - DistanceTesting.jl:49-67's per-position
    substitution (one Float64 draw per position, one length-3 vector draw
    per mutation), pinned by the dna"AGGC"/"AGGCGTCC" goldens.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import native

_MASK64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK64


class JuliaXoshiro:
    """Xoshiro256++ with Julia's `Random.seed!(::Integer)` seeding."""

    __slots__ = ("s0", "s1", "s2", "s3")

    def __init__(self, seed: int):
        if seed < 0:
            raise ValueError("Julia seeds must be non-negative")
        # Random.make_seed: little-endian UInt32 limbs (at least one)
        limbs = []
        n = int(seed)
        while True:
            limbs.append(n & 0xFFFFFFFF)
            n >>= 32
            if n == 0:
                break
        digest = hashlib.sha256(
            b"".join(l.to_bytes(4, "little") for l in limbs)
        ).digest()
        self.s0, self.s1, self.s2, self.s3 = (
            int.from_bytes(digest[8 * i : 8 * (i + 1)], "little") for i in range(4)
        )

    def rand_u64(self) -> int:
        s0, s1, s2, s3 = self.s0, self.s1, self.s2, self.s3
        res = (_rotl((s0 + s3) & _MASK64, 23) + s0) & _MASK64
        t = (s1 << 17) & _MASK64
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        s3 = _rotl(s3, 45)
        self.s0, self.s1, self.s2, self.s3 = s0, s1, s2, s3
        return res

    def rand_u64s(self, n: int) -> np.ndarray:
        """The next ``n`` draws as uint64[n]; the state ends where ``n``
        calls of ``rand_u64`` leave it.  One call of the native library,
        else a Python loop where it cannot be built."""
        drawn = native.xoshiro256pp_native((self.s0, self.s1, self.s2, self.s3), n)
        if drawn is None:
            return np.fromiter((self.rand_u64() for _ in range(n)), dtype=np.uint64, count=n)
        out, (self.s0, self.s1, self.s2, self.s3) = drawn
        return out

    def rand_float64(self) -> float:
        """Julia rand(): Float64 in [0, 1) from the top 53 bits."""
        return (self.rand_u64() >> 11) * (2.0**-53)

    def rand_index(self, n: int) -> int:
        """Julia rand(1:n) minus 1 (0-based): SamplerRangeNDL (Lemire)."""
        x = self.rand_u64()
        m = x * n
        lo = m & _MASK64
        if lo < n:
            t = (1 << 64) % n
            while lo < t:
                x = self.rand_u64()
                m = x * n
                lo = m & _MASK64
        return m >> 64


#: the shift of chunk nucleotide j = 1..16 in its draw: 32 - 2j
_SHIFTS = np.arange(30, -1, -2, dtype=np.uint64)


def randdnaseq_codes(rng: JuliaXoshiro, length: int) -> np.ndarray:
    """2-bit codes (A=0 C=1 G=2 T=3) of BioSequences' ``randdnaseq(length)``.

    BioSequences v3 fills the 4-bit LongSequence 16 nucleotides per
    ``rand(UInt64)``: chunk nucleotide j reads 2-bit value
    ``(x >> (32 - 2j)) & 3`` of the draw (the shift-left packing loop puts
    the first-consumed low bits in the highest nibble) and one-hot expands
    it to the 4-bit code ``1 << v`` - i.e. the 2-bit value IS the ACGT
    index.  Consumes ceil(length/16) u64 draws.
    """
    return randdnaseq_codes_batch(rng, 1, length)[0]


def randdnaseq_codes_batch(rng: JuliaXoshiro, n_seqs: int, length: int) -> np.ndarray:
    """int8[n_seqs, length]: row i is ``randdnaseq_codes(rng, length)`` of
    the i-th of ``n_seqs`` calls in turn.  Draws all n_seqs * ceil(length/16)
    u64s at once and unpacks their 16 fields with one shift and mask."""
    n_chunks = -(-length // 16)
    x = rng.rand_u64s(n_seqs * n_chunks)
    codes = ((x[:, None] >> _SHIFTS) & np.uint64(3)).astype(np.int8)
    return codes.reshape(n_seqs, n_chunks * 16)[:, :length]


# DistanceTesting.jl:38-42 mutation_dict, as ACGT-code lists
_MUTATION_CHOICES = (
    (1, 2, 3),  # A -> C, G, T
    (0, 2, 3),  # C -> A, G, T
    (1, 0, 3),  # G -> C, A, T
    (1, 2, 0),  # T -> C, G, A
)


def mutate_seq_julia(codes: np.ndarray, mut_rate: float, rng: JuliaXoshiro) -> np.ndarray:
    """Julia-exact ``mutate_seq`` (ref DistanceTesting.jl:49-67).

    Per position: one Float64 draw (the reference's ``rand(1)[1]`` allocates
    a length-1 vector, whose scalar fill path consumes exactly one u64);
    on a hit, one draw from the 3-element mutation vector.
    """
    out = np.asarray(codes, dtype=np.int8).copy()
    for i in range(out.shape[0]):
        if rng.rand_float64() <= mut_rate:
            out[i] = _MUTATION_CHOICES[out[i]][rng.rand_index(3)]
    return out
