"""FASTA ingestion: streaming parser -> packed int8 code tensors.

This is the IO layer of the framework (SURVEY.md section 7, phase 0 item 1).
It replaces the reference's FASTX.FASTA.Reader streaming loop
(ref GenomeMiner.jl:31-32) with a host-side parser that produces dense
NumPy code arrays ready for device transfer.

A ``FastaRecord`` carries:
  * ``identifier`` - first whitespace-delimited token of the header
    (FASTX ``FASTA.identifier`` semantics),
  * ``description`` - the full header line minus '>'
    (FASTX ``FASTA.description`` semantics),
  * ``seq`` - the sequence bytes as read, case preserved, whitespace
    stripped, and ``codes`` - the int8 2-bit-code array (A=0,C=1,G=2,T=3,
    N=3), encoded on first access unless the loader gave it.

A record from the native loader views the loader's one sequence array and
one code array: its ``seq`` is built as ``bytes`` on first access and
kept; ``len(record)`` and ``seq_slice(record, start, stop)`` read the view.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Union

import numpy as np

from ..consts import encode_seq
from . import trace


@dataclass
class FastaRecord:
    description: str
    seq: bytes  # raw sequence bytes as read (case preserved); a property, below
    _codes: np.ndarray | None = field(default=None, repr=False)

    @classmethod
    def _viewing(cls, description: str, seq: np.ndarray, codes: np.ndarray) -> "FastaRecord":
        """A record over a uint8 view of its sequence bytes and its codes."""
        rec = cls(description, b"", codes)
        rec._seq, rec._view = None, seq
        return rec

    @property
    def identifier(self) -> str:
        return self.description.split(None, 1)[0] if self.description else ""

    def __len__(self) -> int:
        return len(self._view) if self._seq is None else len(self._seq)

    @property
    def codes(self) -> np.ndarray:
        if self._codes is None:
            self._codes = encode_seq(self.seq)
        return self._codes

    def seq_str(self) -> str:
        return self.seq.decode("ascii")


def _get_seq(self: FastaRecord) -> bytes:
    if self._seq is None:
        self._seq, self._view = self._view.tobytes(), None
    return self._seq


def _set_seq(self: FastaRecord, value: bytes) -> None:
    self._seq, self._view = value, None


def seq_slice(record, start: int, stop: int) -> bytes:
    """``record.seq[start:stop]``; from a record that views the native
    loader's buffer, without building its ``seq``.  Any record with a
    ``seq`` is taken (the JAX package's too)."""
    view = getattr(record, "_view", None)
    return record.seq[start:stop] if view is None else view[start:stop].tobytes()


# set after the dataclass is made, so that ``seq`` stays its second field
# (``__init__``, ``__eq__`` and ``__repr__`` go through the property)
FastaRecord.seq = property(_get_seq, _set_seq, doc="raw sequence bytes as read (case preserved)")


PathOrRecords = Union[str, os.PathLike, Iterable[FastaRecord]]


def read_fasta(path: str | os.PathLike) -> Iterator[FastaRecord]:
    """Stream records from a fasta file."""
    with open(path, "rb") as fh:
        yield from parse_fasta(fh)


def parse_fasta(fh: io.IOBase) -> Iterator[FastaRecord]:
    desc: str | None = None
    chunks: list[bytes] = []
    for line in fh:
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            if desc is not None:
                yield FastaRecord(desc, b"".join(chunks))
            desc = line[1:].decode("ascii")
            chunks = []
        else:
            chunks.append(line)
    if desc is not None:
        yield FastaRecord(desc, b"".join(chunks))


def as_records(source: PathOrRecords) -> list[FastaRecord]:
    """Accept a fasta path or an iterable of records (ref ReferenceGeneration.jl:6-14).

    Paths go through the native C++ loader when available (fused parse +
    2-bit encode in one sweep, utils/native.py) with the pure-Python parser
    as fallback - identical records either way (tests/test_native.py).
    Runs in a ``parse`` span (utils/trace.py), which the native loader's
    ``threads``, ``lines`` and ``slow_lines`` join."""
    with trace.span("parse") as sp:
        counters: dict = {}
        recs = _as_records(source, counters)
        if sp:
            sp.add(records=len(recs), bytes=sum(len(r) for r in recs), **counters)
        return recs


def _as_records(source: PathOrRecords, counters: dict) -> list[FastaRecord]:
    if isinstance(source, (str, os.PathLike)):
        native = read_fasta_native(source, counters=counters)
        if native is not None:
            return native
        return list(read_fasta(source))
    if hasattr(source, "read") or hasattr(source, "readline"):
        # open file handle / stream (the reference dispatches on a live
        # FASTA.Reader, ref ExactMatch.jl:100-121); text-mode handles are
        # re-wrapped so the byte parser sees bytes
        if isinstance(source, io.TextIOBase):
            return list(parse_fasta(io.BytesIO(source.read().encode("ascii"))))
        return list(parse_fasta(source))
    try:
        recs = list(source)
    except TypeError:
        raise TypeError("invalid input type: expected a fasta path or an iterable of FastaRecord")
    for r in recs:
        if not isinstance(r, FastaRecord):
            raise TypeError("invalid input type")
    return recs


def write_fasta(records: Iterable[FastaRecord], path: str | os.PathLike, width: int = 95, append: bool = True) -> None:
    """Write records to ``path``, wrapping sequence lines at ``width``.

    Appends by default, mirroring the reference's ``write_results`` which
    opens the output in append mode (ref API.jl:234-241).
    """
    mode = "ab" if append else "wb"
    with open(path, mode) as fh:
        for rec in records:
            fh.write(b">" + rec.description.encode("ascii") + b"\n")
            s = rec.seq
            for i in range(0, len(s), width):
                fh.write(s[i : i + width] + b"\n")


def fasta_id_to_cumulative_len_dict(path: str | os.PathLike) -> dict[str, int]:
    """Map each record's full description to the cumulative bp BEFORE it.

    Matches the reference's behaviour (ref ExactMatch.jl:146-158): the first
    contig maps to 0 (the docstring example in the reference is wrong; the
    test pins first => 0, reference test-KmerGMA.jl:336-344).  Keys are full
    descriptions (FASTA.description), not bare identifiers.
    """
    out: dict[str, int] = {}
    cum = 0
    for rec in read_fasta(path):
        out[rec.description] = cum
        cum += len(rec)
    return out


@dataclass
class ContigSet:
    """A parsed multi-contig genome as packed tensors plus a contig table.

    ``genome_pos[i]`` is the cumulative bp before contig ``i`` - the same
    quantity the reference accumulates while streaming
    (ref GenomeMiner.jl:25,106).
    """

    records: list[FastaRecord]

    @property
    def genome_pos(self) -> list[int]:
        out, cum = [], 0
        for r in self.records:
            out.append(cum)
            cum += len(r)
        return out

    @property
    def total_bp(self) -> int:
        return sum(len(r) for r in self.records)


def load_contigs(source: PathOrRecords) -> ContigSet:
    return ContigSet(as_records(source))


def read_fasta_native(path: str | os.PathLike, *, counters: "dict | None" = None) -> "list[FastaRecord] | None":
    """Fast path: parse + encode with the native C++ loader (utils/native.py).

    Returns records that view the loader's code array and its raw
    (case-preserved) sequence bytes, or None when the native library is
    unavailable - callers fall back to ``read_fasta``.  The loader's
    counters are added to ``counters`` when it is given.
    """
    from .native import load_fasta_native

    out = load_fasta_native(str(path))
    if out is None:
        return None
    codes, seq_bytes, offsets, lengths, descs, stats = out
    if counters is not None:
        counters.update(stats)
    ends = (offsets + lengths).tolist()
    return [FastaRecord._viewing(d, seq_bytes[lo:hi], codes[lo:hi]) for d, lo, hi in zip(descs, offsets.tolist(), ends)]
