"""Exact match of the port (kmergma_tpu_torch.ops.exact_match) against the
JAX package's (kmergma_tpu.ops.exact_match) on the CPU: the cases of
tests/test_exact_match.py through both, the device route (``use_device``,
on CPU tensors) against ``bytes.find`` for queries of 1-40 bases with N,
and the subject cache's byte budget."""

import numpy as np
import pytest

import kmergma_tpu_torch as kt
from kmergma_tpu.ops import exact_match as jem
from kmergma_tpu.utils.fasta import fasta_id_to_cumulative_len_dict as jax_cumulative_len_dict
from kmergma_tpu_torch.ops import exact_match as tem
from kmergma_tpu_torch.utils.fasta import fasta_id_to_cumulative_len_dict, read_fasta

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _both(query, subject, **kw):
    """(port, JAX) results of exact_match on the same inputs."""
    return kt.exact_match(query, subject, device="cpu", **kw), jem.exact_match(query, subject, **kw)


@pytest.mark.parametrize("query,subject,overlap,want", [
    ("GAG", "CCCCCCCGAGCTTTT", True, [(8, 10)]),
    ("GAG", "CGAGCCCGAGCTTTT", True, [(2, 4), (8, 10)]),
    ("GAG", "CGAGAGAGAAGGCCGAGCTTTT", True, [(2, 4), (4, 6), (6, 8), (15, 17)]),
    ("GAG", "CGAGAGAGAAGGCCGAGCTTTT", False, [(2, 4), (6, 8), (15, 17)]),
    ("GAG", "CCCCCCTTT", True, None),
])
def test_single_sequence_cases(query, subject, overlap, want):
    for use_device in (None, True):  # bytes.find, then the device route
        got, ref = _both(query, subject, overlap=overlap, use_device=use_device)
        assert got == ref == want


def test_reader_cases(ref_fasta):
    rec = next(read_fasta(ref_fasta))
    cases = [
        (rec.seq_str()[41:69], {"AM773729|IGHV1-1*01|Vicugna": [(42, 69)]}),
        (rec, {"AM773729|IGHV1-1*01|Vicugna": [(1, 296)]}),
        ("AAAAAAAAA", "no match"),
        ("AAATT", {"AM773729|IGHV1-1*01|Vicugna": [(174, 178)], "AM939700|IGHV1S5*01|Vicugna": [(174, 178)]}),
    ]
    for query, want in cases:
        got = kt.exact_match(query, ref_fasta, device="cpu")
        # the JAX package takes its own record type: hand it the bytes
        assert got == jem.exact_match(getattr(query, "seq", query), ref_fasta) == want
    with open(ref_fasta, "rb") as fh:
        assert kt.exact_match("AAATT", fh, device="cpu") == cases[3][1]
    with open(ref_fasta, "r") as fh:
        assert kt.exact_match("AAATT", fh, device="cpu") == cases[3][1]


def test_engine_matches_host_on_loci(test_genome):
    rec = next(read_fasta(test_genome))
    sub = rec.seq.upper()
    q = sub[20000:20030]
    for qq in (q, q[::-1], *(sub[1000 : 1000 + n] for n in (3, 7, 15, 16, 17))):
        got = tem.match_starts_engine(sub, qq, device="cpu").tolist()
        assert got == tem.match_starts_np(sub, qq).tolist() == jem.match_starts_np(sub, qq).tolist()


def test_device_route_equals_bytes_find_with_n():
    """Queries of 1-40 bases, some with N, on a 1 Mbp subject with N runs:
    the register folds N into T, and the byte verification keeps only true
    occurrences."""
    rng = np.random.default_rng(4)
    sub_arr = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 1 << 20)].copy()
    for pos in rng.integers(0, (1 << 20) - 50, 300):
        sub_arr[pos : pos + rng.integers(1, 6)] = ord("N")
    sub = sub_arr.tobytes()
    n_hits = 0
    for qlen in range(1, 41):
        at = int(rng.integers(0, len(sub) - qlen))
        q = sub[at : at + qlen]
        if qlen % 7 == 0:
            q = q[: qlen // 2] + b"N" + q[qlen // 2 + 1 :]
        got = tem.match_starts_engine(sub, q, device="cpu")
        assert got.tolist() == tem.match_starts_np(sub, q).tolist(), qlen
        n_hits += got.size
    assert n_hits > 40
    assert kt.exact_match(sub[5000:5030], sub, device="cpu") == jem.exact_match(sub[5000:5030], sub, use_device=False)


def test_subject_cache_evicts_by_bytes_only():
    """More than four subjects stay cached under the byte budget (the JAX
    package's clear() at four entries is not copied); past the budget the
    oldest go first."""
    rng = np.random.default_rng(5)
    subjects = [np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 20_000)].tobytes() for _ in range(6)]
    cache = tem.SubjectCache(1 << 30)
    for sub in subjects:
        assert tem.match_starts_engine(sub, sub[100:120], device="cpu", cache=cache).tolist()[:1] == [100]
    assert len(cache) == 6
    per_entry = cache.held_bytes() // 6
    small = tem.SubjectCache(3 * per_entry)
    for sub in subjects:
        tem.match_starts_engine(sub, sub[:10], device="cpu", cache=small)
    assert len(small) == 3 and small.held_bytes() <= 3 * per_entry
    assert small.get(tem._subject_key(subjects[-1], "cpu")) is not None
    assert small.get(tem._subject_key(subjects[0], "cpu")) is None


def test_subject_cache_keys_by_content():
    """Equal subjects held by distinct objects (``_as_bytes`` makes a new
    one on every call) share one cache entry and one host-to-device copy."""

    class CountingCache(tem.SubjectCache):
        puts = 0

        def put(self, key, codes):
            self.puts += 1
            super().put(key, codes)

    rng = np.random.default_rng(9)
    sub = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 30_000)].tobytes()
    twin = bytes(bytearray(sub))
    assert twin == sub and twin is not sub
    cache = CountingCache(1 << 30)
    for s in (sub, twin):
        assert tem.match_starts_engine(s, sub[700:730], device="cpu", cache=cache).tolist() == [700]
    assert len(cache) == 1 and cache.puts == 1


def test_first_match_and_guards(ref_fasta, test_genome):
    assert tem.first_match(ref_fasta, "AAATT") == jem.first_match(ref_fasta, "AAATT")
    assert ("AM773729|IGHV1-1*01|Vicugna", (174, 178)) in kt.first_match(ref_fasta, "AAATT")
    with pytest.raises(ValueError):
        kt.exact_match("", "ACGT", device="cpu")
    assert tem._query_register(b"ACGTNACGTTTGCAGTCA") == jem._query_register(b"ACGTNACGTTTGCAGTCA")
    assert tem._query_register(b"GA") == jem._query_register(b"GA")
    assert fasta_id_to_cumulative_len_dict(test_genome) == jax_cumulative_len_dict(test_genome)
