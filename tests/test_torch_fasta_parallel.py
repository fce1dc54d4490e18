"""The threaded, in-place native FASTA parse (``native/fastaio.cpp``).

``load_fasta_native(path, _threads=T, _min_chunk=1)`` cuts even a small
file into T chunks, so every case below crosses chunk seams.  The records
it gives must equal the one-pass loader's that it replaced (``_one_pass``,
that loader's byte loop in Python), the JAX package's ``as_records`` and,
where the two parsers agree by design, the Python parser's
(``read_fasta``): description, identifier, ``seq`` (``bytes``), codes and
their dtype.  Errors carry the same message, and an invalid byte is
reported at its first offset in file order, whichever chunk holds it."""

import functools
import os
import re

import numpy as np
import pytest

from kmergma_tpu.utils import fasta as jfasta
from kmergma_tpu_torch.utils import fasta as tfasta
from kmergma_tpu_torch.utils import native as tnative
from kmergma_tpu_torch.utils import trace

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from .test_torch_host import DATA, FIXTURES

THREADS = [1, 2, 3, 8]


def _records(recs):
    return [(r.description, r.identifier, r.seq, type(r.seq), r.codes.tobytes(), r.codes.dtype) for r in recs]


def _one_pass(data: bytes, path: str) -> list:
    """The records of the one-pass loader the threaded parse replaced: '>'
    anywhere in sequence opens a header that runs to the next '\\n' with
    every '\\r' dropped; '\\n', '\\r', ' ', '\\t' are skipped; letters before
    the first header belong to no record."""
    if not data:
        return []
    if b">" not in data:
        raise ValueError(f"no fasta records found in {path}")
    recs, i = [], 0
    while i < len(data):
        if data[i] == ord(">"):
            j = data.find(b"\n", i)
            j = len(data) if j < 0 else j
            recs.append((data[i + 1 : j].replace(b"\r", b"").decode("ascii"), bytearray()))
            i = j + 1
            continue
        c = data[i]
        if c in b"ACGTNacgtn":
            if recs:
                recs[-1][1].append(c)
        elif c not in b"\n\r \t":
            raise ValueError(f"invalid nucleotide character at byte {i} of {path} (only A/C/G/T/N supported)")
        i += 1
    return [tfasta.FastaRecord(d, bytes(s)) for d, s in recs]


def _chunk_starts(n: int, data: bytes, threads: int) -> list:
    """Where the loader's chunks start (``load_fasta_native``'s rule): chunk
    t one past the first '\\n' at or after byte n * t / T."""
    starts = [0]
    for t in range(1, threads):
        e = data.find(b"\n", max(n * t // threads, starts[-1]))
        starts.append(n if e < 0 else e + 1)
    return starts


def _native(path, threads: int, monkeypatch, counters=None):
    """``read_fasta_native`` on ``threads`` chunks of at least one byte."""
    monkeypatch.setattr(tnative, "load_fasta_native",
                        functools.partial(tnative.load_fasta_native, _threads=threads, _min_chunk=1))
    return tfasta.read_fasta_native(path, counters=counters)


def _check(path, data: bytes, threads: int, monkeypatch, python_agrees: bool = True):
    """The threaded parse against the one-pass loader, the JAX package's
    ``as_records`` and, where given, the Python parser; or the same error."""
    try:
        want = _records(_one_pass(data, str(path)))
    except ValueError as err:
        with pytest.raises(ValueError, match=f"^{re.escape(str(err))}$"):
            _native(path, threads, monkeypatch)
        with pytest.raises(ValueError, match=f"^{re.escape(str(err))}$"):
            jfasta.as_records(str(path))
        return
    got = _native(path, threads, monkeypatch)
    assert _records(got) == want
    assert _records(jfasta.as_records(str(path))) == want
    if python_agrees:
        assert _records(tfasta.read_fasta(path)) == want


def test_the_jax_reference_is_its_native_loader():
    """The JAX ``as_records`` that these cases compare with runs the JAX
    package's native loader, the one-pass parser's twin."""
    assert jfasta.read_fasta_native(str(DATA / FIXTURES[0])) is not None


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("fixture", FIXTURES)
def test_fixtures_match_at_every_thread_count(fixture, threads, monkeypatch):
    path = DATA / fixture
    _check(path, path.read_bytes(), threads, monkeypatch)


#: (bytes, whether the Python parser gives the same records); the Python
#: parser keeps bytes inside a line that the native loaders skip or read
#: as a header, so those cases compare with the native loaders alone
EDGES = {
    "crlf": (b">r1 first record\r\nACGT\r\nAC\r\n>r2\r\nGG\r\n", True),
    "lower_case": (b">a\nacgtn\nACgtN\n>b\nttttgggg\n", True),
    "n_runs": (b">a\nNNNNNNNN\nACGTNNNN\nNNNN\n>b\nnnnnACGT\n", True),
    "blank_lines": (b"\n\n>a\n\nACGT\n\n\nAC\n\n>b\n\nG\n\n", True),
    "empty_record": (b">a\n>b\nACGT\n>c\n\n>d\nA\n", True),
    "header_only_last": (b">a\nACGT\n>last header", True),
    "header_only_last_newline": (b">a\nACGT\n>last\n", True),
    "sequence_before_first_header": (b"ACGTACGT\nAC\n>a\nGG\n>b\nT\n", True),
    "spaces_and_tabs_in_lines": (b">a x\nAC GT\tAC\n \tACG \n>b\n\tTT  T\n", False),
    "no_final_newline": (b">a\nACGT\nACG", True),
    "gt_inside_a_line": (b">a\nACGT>b mid\nGG\n", False),
    "cr_inside_a_header": (b">a\rb c\nAC\n", False),
    "header_after_leading_space": (b" >a\nAC\n", True),
    "empty_file": (b"", True),
    "whitespace_only": (b"\n \n\t\r\n", True),
    "letters_without_header": (b"ACGT\nACGT\n", True),
    "invalid_without_header": (b"AXGT\n", True),
    "invalid_before_header": (b"AXGT\n>a\nAC\n", False),
    "invalid_in_record": (b">a\nACGT\nAC-T\n>b\nAC\n", False),
    "invalid_then_gt_in_line": (b">a\nACGT\nAX>b\nAC\n", False),
}


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", list(EDGES))
def test_edge_cases_match_at_every_thread_count(case, threads, tmp_path, monkeypatch):
    data, python_agrees = EDGES[case]
    path = tmp_path / f"{case}.fasta"
    path.write_bytes(data)
    _check(path, data, threads, monkeypatch, python_agrees)


def _lines(rng, n: int, width: int, lower: bool) -> bytes:
    letters = np.frombuffer(b"acgtn" if lower else b"ACGTN", np.uint8)
    seq = letters[rng.choice(5, n, p=[0.24, 0.24, 0.24, 0.24, 0.04])]
    return b"\n".join(seq[i : i + width].tobytes() for i in range(0, n, width))


def _seam_files() -> dict:
    """Files whose chunk targets (n * t / T) fall where a chunk may not
    start, each with the thread count that puts them there."""
    rng = np.random.default_rng(22)
    out = {}
    # the middle of a 120-byte header, at T = 2
    head = b">a\n" + _lines(rng, 4_000, 60, False) + b"\n"
    header = b">" + b"h" * 119 + b"\n"
    tail = _lines(rng, 4_000, 60, False) + b"\n"
    data = head + header + tail
    mid = len(data) // 2
    assert data.rfind(b">", 0, mid) == len(head) and data.find(b"\n", mid) == len(head) + len(header) - 1
    out["inside_a_header"] = (data, 2)
    # between '\r' and '\n', at T = 2
    body = _lines(rng, 3_000, 70, False).replace(b"\n", b"\r\n")
    for pad in range(200):
        data = b">a\r\n" + b"A" * pad + body + b"\r\n>b\r\nAC\r\n"
        mid = len(data) // 2
        if data[mid - 1 : mid + 1] == b"\r\n":
            break
    assert data[mid - 1 : mid + 1] == b"\r\n"
    out["between_cr_and_lf"] = (data, 2)
    # one record over at least three chunks, at T = 8
    data = b">long\n" + _lines(rng, 20_000, 80, False) + b"\n>short\nACGT\n"
    starts = _chunk_starts(len(data), data, 8)
    assert sum(s < data.index(b">short") for s in starts[1:]) >= 2
    out["record_over_three_chunks"] = (data, 8)
    return out


SEAMS = _seam_files()


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("case", list(SEAMS))
def test_seams_match(case, extra, tmp_path, monkeypatch):
    """The seam cases at their own thread count, and at one more."""
    data, threads = SEAMS[case]
    path = tmp_path / f"{case}.fasta"
    path.write_bytes(data)
    _check(path, data, threads + extra, monkeypatch)


def _random_genome(seed: int, crlf: bool) -> bytes:
    """About 3 MB of records of drawn lengths and line widths, upper or
    lower case, with N runs, blank lines and empty records."""
    rng = np.random.default_rng(seed)
    parts = []
    for r in range(40):
        n = int(rng.integers(0, 150_000)) if r % 9 else 0
        body = _lines(rng, n, int(rng.integers(50, 130)), bool(rng.integers(0, 2)))
        if n:
            runs = rng.integers(0, max(1, len(body) - 200), 3)
            body = bytearray(body)
            for at in runs:
                body[at : at + 150] = bytes(b if b == 10 else 78 for b in body[at : at + 150])
            body = bytes(body)
        blank = b"\n" if rng.integers(0, 4) == 0 else b""
        parts.append(b">rec%d scaffold %d\n" % (r, seed) + blank + body + (b"\n" if body else b""))
    data = b"".join(parts)
    return data.replace(b"\n", b"\r\n") if crlf else data


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("crlf", [False, True])
def test_generated_genomes_match(crlf, threads, tmp_path, monkeypatch):
    data = _random_genome(7 + crlf, crlf)
    path = tmp_path / "genome.fasta"
    path.write_bytes(data)
    want = _records(tfasta.read_fasta(path))
    counters = {}
    assert _records(_native(path, threads, monkeypatch, counters)) == want
    assert _records(jfasta.as_records(str(path))) == want
    # letters only, blank lines and CRLF ends included: every line is fast
    assert counters == {"threads": threads, "lines": data.count(b"\n"), "slow_lines": 0}


@pytest.mark.parametrize("threads", [2, 3, 8])
def test_invalid_byte_in_each_chunk_reports_the_first(threads, tmp_path, monkeypatch):
    """An invalid byte in chunk t, and another in each later chunk: the
    error names the first in file order, as the one-pass loader did."""
    clean = _random_genome(11, False)
    n = len(clean)
    starts = _chunk_starts(n, clean, threads)
    seq_at = np.flatnonzero(np.isin(np.frombuffer(clean, np.uint8), np.frombuffer(b"ACGTNacgtn", np.uint8)))
    path = tmp_path / "bad.fasta"
    for t in range(threads):
        data = bytearray(clean)
        for u in range(t, threads):
            hi = starts[u + 1] if u + 1 < threads else n
            inside = seq_at[(seq_at >= starts[u]) & (seq_at < hi)]
            data[int(inside[len(inside) // 2])] = ord("X")
        first = data.index(b"X")
        path.write_bytes(bytes(data))
        msg = f"invalid nucleotide character at byte {first} of {path} (only A/C/G/T/N supported)"
        with pytest.raises(ValueError, match=f"^{re.escape(msg)}$"):
            _native(path, threads, monkeypatch)
        with pytest.raises(ValueError, match=f"^{re.escape(msg)}$"):
            jfasta.as_records(str(path))


def test_records_view_one_buffer(tmp_path, monkeypatch):
    """``len(record)`` and ``seq_slice`` read the view (of any record with a
    ``seq``, the JAX package's too); ``seq`` is built
    once, as ``bytes``, and kept; the codes of every record share one array."""
    path = tmp_path / "g.fasta"
    path.write_bytes(_random_genome(3, False))
    recs = _native(path, 3, monkeypatch)
    assert len({id(r.codes.base) for r in recs}) == 1
    want = list(tfasta.read_fasta(path))
    assert [len(r) for r in recs] == [len(w.seq) for w in want]
    assert [tfasta.seq_slice(r, 5, 300) for r in recs] == [w.seq[5:300] for w in want]
    assert all(r._seq is None for r in recs)
    seq = recs[1].seq
    assert type(seq) is bytes and seq == want[1].seq and recs[1].seq is seq
    assert tfasta.seq_slice(recs[1], -40, 10**9) == seq[-40:]
    plain = tfasta.FastaRecord("p", b"acgtN")
    assert plain.seq == b"acgtN" and len(plain) == 5 and tfasta.seq_slice(plain, 1, 3) == b"cg"
    assert tfasta.seq_slice(jfasta.FastaRecord("j", b"ACGTA"), 1, 4) == b"CGT"
    assert plain.codes.tolist() == [0, 1, 2, 3, 3]


def test_parse_span_counts_without_building_seq(tmp_path):
    """A traced ``as_records`` of a file past ``PARALLEL_MIN_BYTES`` runs
    threaded, and its ``parse`` span carries records, bytes, threads, lines
    and slow_lines while every ``seq`` stays unbuilt."""
    rng = np.random.default_rng(5)
    data = b"".join(b">chr%d\n" % i + _lines(rng, 1_200_000, 80, False) + b"\n" for i in range(4))
    data += b">odd\nAC GT\nACGT\n"
    path = tmp_path / "big.fasta"
    path.write_bytes(data)
    assert len(data) >= tnative.PARALLEL_MIN_BYTES
    trace.reset()
    trace.enable()
    try:
        recs = tfasta.as_records(path)
        spans = [s for s in trace.log() if s["name"] == "parse"]
    finally:
        trace.disable()
        trace.reset()
    assert all(r._seq is None for r in recs)
    (span,) = spans
    threads = min(tnative.parse_threads(len(data)), len(data) // tnative.MIN_CHUNK_BYTES)
    assert span["counters"] == {
        "records": 5, "bytes": 4 * 1_200_000 + 8, "threads": threads,
        "lines": data.count(b"\n"), "slow_lines": 1,
    }
    assert threads > 1 or tnative.parse_threads(len(data)) == 1


def test_small_files_parse_on_one_thread():
    """The 24 kb reference and a 485 kb locus file take one thread; a
    file past the threshold takes min(8, the process's CPUs)."""
    assert tnative.parse_threads((DATA / "Alp_V_ref.fasta").stat().st_size) == 1
    assert tnative.parse_threads(485_000) == 1
    assert tnative.parse_threads(tnative.PARALLEL_MIN_BYTES - 1) == 1
    assert tnative.parse_threads(404_000_000) == min(8, len(os.sched_getaffinity(0)))
