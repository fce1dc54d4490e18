"""Core constants: nucleotide encodings and scoring matrices.

TPU-native rebuild of the reference's type/constant layer
(ref: KmerGMA.jl src/Consts.jl:22-28 for the 2-bit encoding contract).

Design notes (TPU-first):
  * Sequences are represented as dense ``int8`` code arrays (A=0, C=1, G=2,
    T=3, N=3) instead of bit-packed BioSequences objects.  Dense int8 is the
    natural layout for XLA/Pallas: each code is directly usable as a shift
    operand for rolling k-mer registers and as a gather index, and int8 tiles
    map onto the VPU's (32, 128) native tiling.
  * The encoding contract matches the reference exactly: A=0, C=1, G=2, T=3
    and N=3 (ref Consts.jl:27 maps DNA_N => 3).  Any other character is a
    hard error, mirroring the reference's Dict-lookup crash semantics
    (SURVEY.md section 7 hard-part 4 - we choose "match (error)").
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# 2-bit nucleotide encoding (ref Consts.jl:22-28)
# ---------------------------------------------------------------------------

NT_BITS: dict[str, int] = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 3}

#: Inverse decode table used by ``as_kmer`` (standard A=0,C=1,G=2,T=3 order).
#: The reference's BitNtDict (Kmers.jl:68-72) pairs an intentionally
#: bit-swapped dict with an LSB-first bit-pair decode; the two quirks cancel,
#: so the net behaviour is this plain MSB-first decode (pinned by the codec
#: round-trip test, reference test-KmerGMA.jl:23-24).
BITS_NT: str = "ACGT"

# 256-entry byte -> code lookup table. -1 marks invalid characters.
_ENCODE_LUT = np.full(256, -1, dtype=np.int8)
for _c, _v in NT_BITS.items():
    _ENCODE_LUT[ord(_c)] = _v
    _ENCODE_LUT[ord(_c.lower())] = _v


def encode_seq(seq: "str | bytes | bytearray | np.ndarray") -> np.ndarray:
    """Encode an ASCII DNA sequence into an int8 code array (A=0,C=1,G=2,T=3,N=3).

    Case-insensitive.  Raises ``ValueError`` on any other character, matching
    the reference's behaviour of crashing on unmapped IUPAC codes.
    """
    if isinstance(seq, str):
        raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    elif isinstance(seq, (bytes, bytearray)):
        raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        raw = np.asarray(seq, dtype=np.uint8)
    codes = _ENCODE_LUT[raw]
    if codes.size and codes.min() < 0:
        bad = chr(int(raw[np.argmax(codes < 0)]))
        raise ValueError(f"invalid nucleotide character {bad!r} (only A/C/G/T/N supported)")
    return codes


def decode_seq(codes: np.ndarray) -> str:
    """Decode an int8 code array back to an uppercase ACGT string (N decodes as T)."""
    lut = np.frombuffer(BITS_NT.encode(), dtype=np.uint8)
    return np.asarray(lut)[np.asarray(codes)].tobytes().decode("ascii")


# The EDNAFULL / NUC.4.4 substitution matrix itself lives with the aligner
# (ops/align.py _NUC44, the full 15-letter IUPAC form BioAlignments uses).

#: Default affine gap parameters of the single-profile miner
#: (ref GenomeMiner.jl:17-18); cluster mode uses gap_open=-200
#: (ref OmnGenomeMiner.jl:22).
DEFAULT_GAP_OPEN = -69
DEFAULT_GAP_EXTEND = -1

#: Reference plot palette (ref Consts.jl:13-18) kept for diagnostics parity.
JULIA_PALETTE = {
    "purple": "#9358A4",
    "red": "#CB392E",
    "green": "#369844",
    "blue": "#4C64B0",
}


def get_k(kfv_len: int) -> int:
    """k from a k-mer frequency vector length: log4(len) (ref Consts.jl:43)."""
    k = round(np.log(kfv_len) / np.log(4))
    if 4**k != kfv_len:
        raise ValueError(f"KFV length {kfv_len} is not a power of 4")
    return int(k)
