"""A plain FASTA reader and the 2-bit code of KmerGMA (A=0, C=1, G=2,
T=3, N=3, either case; any other letter is an error, as in KmerGMA.jl
src/Consts.jl:22-28).

Written for the benchmark, not copied: NumPy finds the header lines and
drops the line breaks, so a 400 Mbp file reads in about a second.
"""

from __future__ import annotations

import numpy as np

_CODE = np.full(256, -1, dtype=np.int8)
for _letter, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("N", 3)):
    _CODE[ord(_letter)] = _code
    _CODE[ord(_letter.lower())] = _code

_WHITESPACE = np.zeros(256, dtype=bool)
_WHITESPACE[[9, 10, 11, 12, 13, 32]] = True


def read_fasta(path) -> list[tuple[str, bytes]]:
    """(description, sequence bytes as written) of every record; the
    description is the header line without '>' and surrounding blanks."""
    data = np.fromfile(path, dtype=np.uint8)
    if data.size == 0:
        return []
    line_starts = np.concatenate(([0], np.flatnonzero(data == 10) + 1))
    line_starts = line_starts[line_starts < data.size]
    headers = line_starts[data[line_starts] == ord(">")]
    records = []
    for i, h in enumerate(headers):
        nl = np.flatnonzero(data[h:] == 10)
        head_end = h + int(nl[0]) if nl.size else data.size
        body_end = int(headers[i + 1]) if i + 1 < headers.size else data.size
        body = data[head_end + 1 : body_end] if head_end < data.size else data[:0]
        seq = body[~_WHITESPACE[body]]
        desc = data[h + 1 : head_end].tobytes().decode("ascii").strip()
        records.append((desc, seq.tobytes()))
    return records


def encode(seq: bytes) -> np.ndarray:
    """int8 2-bit codes of ``seq``."""
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = _CODE[raw]
    if codes.size and codes.min() < 0:
        bad = chr(int(raw[np.argmax(codes < 0)]))
        raise ValueError(f"invalid nucleotide character {bad!r}")
    return codes
