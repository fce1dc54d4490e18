"""The port's randstrobe search (``strobemer_find_genes`` on the CPU)
against the benchmark's plain reference (benchmark/reference/strobe.py),
hit records equal, on seeded genomes of 50-400 kb records with the Alp_V
genes planted in both orientations; and that reference's extraction and
distances against a step-by-step transcription of the upstream's loop
(KmerGMA.jl src/StrobemerGMA/Strobemers.jl:45-65 and
StrobeGenomeMiner.jl:48-90) on short records."""

from pathlib import Path

import numpy as np
import pytest
import torch

import kmergma_tpu_torch as kt
from benchmark.reference import strobe as ref
from benchmark.reference.fasta import encode, read_fasta
from kmergma_tpu_torch.utils import trace

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REF = str(Path(__file__).parent / "data" / "Alp_V_ref.fasta")
GENES = [seq.upper() for _, seq in read_fasta(REF)]
WS = 289  # the Alp_V set's windowsize
_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")


def _background(rng, n: int) -> bytearray:
    return bytearray(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)].tobytes())


def _planted(rng, n: int, reverse: bool) -> bytes:
    """A record of ``n`` bp with Alp_V genes every 9-15 kb, each with 0-5%
    substitutions, reverse-complemented where ``reverse``."""
    seq = _background(rng, n)
    pos = int(rng.integers(500, 3000))
    while pos + 400 < n:
        gene = bytearray(GENES[int(rng.integers(len(GENES)))])
        sites = np.flatnonzero(rng.random(len(gene)) < rng.uniform(0.0, 0.05))
        for s in sites:
            gene[s] = b"ACGT"[(b"ACGT".index(gene[s]) + int(rng.integers(1, 4))) % 4]
        seq[pos : pos + len(gene)] = gene
        pos += int(rng.integers(9_000, 15_000))
    out = bytes(seq)
    return out.translate(_COMPLEMENT)[::-1] if reverse else out


def _write(path: Path, records: list[tuple[str, bytes]]) -> str:
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(f">{name} test record\n".encode())
            for i in range(0, len(seq), 80):
                fh.write(seq[i : i + 80] + b"\n")
    return str(path)


def _genome(seed: int, tmp_path: Path) -> str:
    """Three or four planted records of 50-400 kb in either orientation,
    with a record shorter than the windowsize (skipped, GenomePos not
    advanced) and two of ws and ws + 1 bp (one window, no step) among them."""
    rng = np.random.default_rng(seed)
    records = [(f"chr{i}", _planted(rng, int(rng.integers(50_000, 400_000)), bool(i % 2 == seed % 2)))
               for i in range(3 + seed % 2)]
    records.insert(1, ("short", bytes(_background(rng, 200))))
    records.insert(3, ("one_window", bytes(_background(rng, WS))))
    records.append(("one_window_more", bytes(_background(rng, WS + 1))))
    return _write(tmp_path / f"genome_{seed}.fasta", records)


def _port(path: str, **kwargs) -> list:
    out = kt.strobemer_find_genes(path, REF, verbose=False, device="cpu", **kwargs)
    return [(h.description, bytes(h.seq)) for h in out[0]]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_port_equals_the_reference(seed, tmp_path):
    path = _genome(seed, tmp_path)
    want = ref.find_hits("strobemer_find_genes", {"verbose": False}, path, REF)
    got = _port(path)
    assert want and got == want
    # the record shorter than the windowsize leaves GenomePos where it was
    pos, at = {}, 0
    for desc, seq in read_fasta(path):
        if len(seq) >= WS:
            pos[desc.split()[0]] = at
            at += len(seq)
    for desc, _ in want:
        name, *_rest, genome_pos, _len = desc.split(" | ")
        assert genome_pos == f"GenomePos = {pos[name]}"


def test_the_score_filter_drops_hits_in_both(tmp_path):
    """At an alignment-score threshold between a diverged copy's score and
    an exact one's (289 x 5), some hits go and some stay, in both; the
    port counts what it dropped on its ``record`` spans."""
    path = _genome(5, tmp_path)
    kwargs = {"align_score_thr": 1400, "buffer": 30}
    want = ref.find_hits("strobemer_find_genes", {**kwargs, "verbose": False}, path, REF)
    trace.reset()
    trace.enable()
    try:
        got = _port(path, **kwargs)
    finally:
        trace.disable()
    dropped = sum(s["counters"].get("score_filtered", 0) for s in trace.log() if s["name"] == "record")
    replayed = sum(s["counters"].get("replay_hits", 0) for s in trace.log() if s["name"] == "call")
    trace.reset()
    assert got == want and want
    assert dropped > 0 and len(want) + dropped == replayed


def test_without_alignment_and_at_another_threshold(tmp_path):
    path = _genome(6, tmp_path)
    kwargs = {"do_align": False, "kmer_dist_thr": 24, "buffer": 10}
    want = ref.find_hits("strobemer_find_genes", {**kwargs, "verbose": False}, path, REF)
    assert want and _port(path, **kwargs) == want


# --- the reference against the upstream's loop, transcribed -----------------

_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}


def _as_uint(text: str) -> int:
    out = 0
    for ch in text:
        out = 4 * out + _BASE[ch]
    return out


def _get_strobe_2_mer(seq: str, s: int, w_min: int, w_max: int, q: int) -> str:
    """Strobemers.jl:45-65, ungapped: ``min_score`` starts at ``2 << 63``,
    which wraps to 0 in Int64."""
    first = seq[:s]
    min_score, min_ind = 0, w_min
    for i in range(w_min, w_max + 1):
        cur = (_as_uint(first) + _as_uint(seq[i - 1 : i - 1 + s])) % q
        if cur <= min_score:
            min_score, min_ind = cur, i
    return first + seq[min_ind - 1 : min_ind - 1 + s]


def _strobe_gma(seq: str, spectrum: np.ndarray, r: int, ws: int, s: int, w_min: int, w_max: int, q: int) -> list[int]:
    """StrobeGenomeMiner.jl:48-90's count vector, a step at a time, and
    ||r c - S||^2 summed anew from it after every step."""
    k = w_max + s - 1
    c = np.zeros(4 ** (2 * s), dtype=np.int64)
    for p in range(ws - k + 1):  # the strobemers of seq[1:ws]
        c[_as_uint(_get_strobe_2_mer(seq[p : p + k], s, w_min, w_max, q))] += 1
    out = [int(((r * c - spectrum) ** 2).sum())]
    for i in range(1, len(seq) - ws):  # i = 1 .. n - ws - 1
        left = _as_uint(_get_strobe_2_mer(seq[i - 1 : i - 1 + k], s, w_min, w_max, q))
        right = _as_uint(_get_strobe_2_mer(seq[i + ws - k - 1 : i + ws - 1], s, w_min, w_max, q))
        if left != right:
            c[left] -= 1
            c[right] += 1
        out.append(int(((r * c - spectrum) ** 2).sum()))
    return out


@pytest.mark.parametrize("s,w_min,w_max,q,ws,n", [(2, 3, 5, 5, 60, 700), (2, 2, 6, 7, 41, 500), (3, 4, 8, 11, 70, 400)])
def test_reference_against_the_upstream_loop(s, w_min, w_max, q, ws, n):
    rng = np.random.default_rng(ws + n)
    text = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    k = w_max + s - 1
    codes = torch.as_tensor(encode(text.encode()))
    sc = ref.strobe_codes(codes, s, w_min, w_max, q)
    want = [_as_uint(_get_strobe_2_mer(text[p : p + k], s, w_min, w_max, q)) for p in range(n - k + 1)]
    assert sc.tolist() == want
    spectrum = rng.integers(0, 9, 4 ** (2 * s)).astype(np.int64)
    r = 7
    loop = _strobe_gma(text, spectrum, r, ws, s, w_min, w_max, q)
    scale = 2.0 * k * r * r
    dist0, stream = ref.record_stream(sc, torch.as_tensor(spectrum), r, ws - k, n - ws - 1, float("inf"), scale)
    assert dist0 == loop[0] / scale
    assert stream == [(i, d / scale) for i, d in enumerate(loop) if i >= 1]
    # the threshold keeps the steps below it and the one after each
    thr = float(np.median(loop[1:]) / scale)
    _, part = ref.record_stream(sc, torch.as_tensor(spectrum), r, ws - k, n - ws - 1, thr, scale)
    below = [d / scale < thr for d in loop]
    assert [i for i, _ in part] == [i for i in range(1, len(loop)) if below[i] or below[i - 1]]


def test_reference_spectrum_against_the_upstream_strobemers():
    s, w_min, w_max, q = 2, 3, 5, 5
    k = w_max + s - 1
    want = np.zeros(4 ** (2 * s), dtype=np.int64)
    for gene in GENES[:10]:
        text = gene.decode()
        for p in range(len(text) - k + 1):
            want[_as_uint(_get_strobe_2_mer(text[p : p + k], s, w_min, w_max, q))] += 1
    np.testing.assert_array_equal(ref.strobe_spectrum(GENES[:10], s, w_min, w_max, q), want)


def test_reference_against_the_upstream_goldens():
    """The reference's extraction and spectrum on the upstream's own
    strobemer goldens (test-StrobemerGMA.jl, as
    tests/test_paired_strobe_rss.py holds the JAX package to them)."""
    from .conftest import TEST_SEQ

    for seq, want in (("ATCTCTGTTT", "ATCT"), (TEST_SEQ, "ATGC")):
        assert int(ref.strobe_codes(torch.as_tensor(encode(seq.encode())), 2, 3, 5, 5)[0]) == _as_uint(want)
    counts = ref.strobe_spectrum([TEST_SEQ.encode()], 1, 2, 4, 5)
    assert counts.sum() / counts.size == 0.3125
    assert counts[3] == 2 and counts[4] == counts[11] == counts[14] == 1
