"""Positional consensus profile (ref KmerGMA.jl src/Consensus.jl).

A ``Profile`` is a (4, len) int64 count matrix - row order A, C, G, T by the
2-bit code (the reference indexes its 4 vectors by NUCLEOTIDE_BITS[nt]+1,
Consensus.jl:11, so N accumulates into the T row).  ``consensus_seq`` is an
argmax per position with ties broken toward the earlier base in A<C<G<T
order (Consensus.jl:37-48 initialises with A and replaces only on strictly
greater counts - exactly NumPy argmax's first-max rule).
"""

from __future__ import annotations

import numpy as np

from ..consts import BITS_NT, encode_seq


class Profile:
    def __init__(self, length: int):
        self.counts = np.zeros((4, length), dtype=np.int64)

    @property
    def len(self) -> int:
        return self.counts.shape[1]

    def __getitem__(self, nt: str) -> np.ndarray:
        code = int(encode_seq(nt)[0])
        return self.counts[code]

    def lengthen(self, new_len: int) -> None:
        """Grow the profile with zero columns (ref Consensus.jl:24-33)."""
        if new_len > self.len:
            pad = np.zeros((4, new_len - self.len), dtype=np.int64)
            self.counts = np.concatenate([self.counts, pad], axis=1)

    def add(self, seq) -> None:
        """Accumulate per-position base counts (ref Consensus.jl:16-20)."""
        codes = seq if isinstance(seq, np.ndarray) else encode_seq(seq)
        n = codes.shape[0]
        if n > self.len:
            raise IndexError("sequence longer than profile; call lengthen first")
        np.add.at(self.counts[:, :n], (codes.astype(np.int64), np.arange(n)), 1)

    def consensus_codes(self) -> np.ndarray:
        """Argmax base per position, ties to the earlier base (A<C<G<T)."""
        return np.argmax(self.counts, axis=0).astype(np.int8)

    def consensus_str(self) -> str:
        lut = np.frombuffer(BITS_NT.encode(), dtype=np.uint8)
        return lut[self.consensus_codes()].tobytes().decode("ascii")
