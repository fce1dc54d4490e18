"""Julia's seeded Xoshiro256++ stream and BioSequences' ``randdnaseq``,
which the threshold estimate draws from.

Frozen copy of kmergma_tpu_torch/utils/julia_rand.py (``JuliaXoshiro``,
``randdnaseq_codes``) at commit 643846b: Julia >= 1.7 seeds Xoshiro256++
with the SHA-256 of the seed's little-endian UInt32 limbs
(stdlib Random/src/Xoshiro.jl), and BioSequences v3 fills 16 nucleotides
per ``rand(UInt64)``, nucleotide j reading ``(x >> (32 - 2j)) & 3``.
"""

from __future__ import annotations

import hashlib

import numpy as np

_MASK64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK64


class JuliaXoshiro:
    """Xoshiro256++ with Julia's ``Random.seed!(::Integer)`` seeding."""

    __slots__ = ("s0", "s1", "s2", "s3")

    def __init__(self, seed: int):
        if seed < 0:
            raise ValueError("Julia seeds must be non-negative")
        limbs = []
        n = int(seed)
        while True:
            limbs.append(n & 0xFFFFFFFF)
            n >>= 32
            if n == 0:
                break
        digest = hashlib.sha256(b"".join(l.to_bytes(4, "little") for l in limbs)).digest()
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


def randdnaseq_codes(rng: JuliaXoshiro, length: int) -> np.ndarray:
    """2-bit codes (A=0 C=1 G=2 T=3) of BioSequences' ``randdnaseq(length)``."""
    n_chunks = -(-length // 16)
    out = np.empty(n_chunks * 16, dtype=np.int8)
    pos = 0
    for _ in range(n_chunks):
        x = rng.rand_u64()
        for j in range(1, 17):
            out[pos] = (x >> (32 - 2 * j)) & 3
            pos += 1
    return out[:length]
