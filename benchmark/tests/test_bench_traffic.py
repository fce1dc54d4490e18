"""The generator: deterministic for a seed, with the stated lengths and
planted counts."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import genome
from benchmark.reference.fasta import read_fasta

BENCH = Path(__file__).resolve().parents[1]
REF = BENCH / "data" / "Alp_V_ref.fasta"
GENES = [seq for _, seq in read_fasta(REF)]
SEED = 2**31 + 12345


def mix(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_mul32_is_uint32_product():
    x = np.random.default_rng(0).integers(0, 2**32, 1000, dtype=np.uint64)
    for c in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35):
        want = (x.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = genome._mul32(torch.as_tensor(x.astype(np.int64)), c).numpy()
        assert np.array_equal(got, want.astype(np.int64))


def test_hash_codes_deterministic_and_seeded():
    a = genome.hash_codes(10_000, 5, SEED, "cpu")
    assert torch.equal(a, genome.hash_codes(10_000, 5, SEED, "cpu"))
    assert not torch.equal(a, genome.hash_codes(10_000, 5, SEED + 1, "cpu"))
    assert torch.equal(a[5:], genome.hash_codes(9_995, 10, SEED, "cpu"))
    counts = torch.bincount(a.long(), minlength=4).double() / a.numel()
    assert torch.all((counts - 0.25).abs() < 0.02)


def test_genome_mix_lengths_and_plants():
    files = genome.layout(mix("genome"), SEED, len(GENES), [len(g) for g in GENES])
    assert len(files) == 1
    recs = files[0]
    assert [r.length for r in recs[:3]] == [248_956_422, 107_043_718, 46_709_983]
    assert sorted(r.length for r in recs[3:]) == [20_000 + 12_000 * i for i in range(16)]
    assert sum(r.length for r in recs) == 404_470_123
    chr14 = recs[1]
    assert [len(r.plants) for r in recs] == [0, 84, 0] + [0] * 16
    assert sorted(p.gene for p in chr14.plants) == list(range(84))
    assert all(chr14.length - 1_200_000 <= p.pos and p.pos + len(GENES[p.gene]) <= chr14.length for p in chr14.plants)
    assert all(0.0 <= p.rate < 0.05 for p in chr14.plants)
    starts = [p.pos for p in chr14.plants]
    assert starts == sorted(starts) and min(np.diff(starts)) > 12_000 - 4_000 - 1


LOCI = {d.split()[0]: seq for d, seq in read_fasta(BENCH / "data" / "Loci.fasta")}


@pytest.mark.parametrize("seed", [SEED, 7])
def test_loci_mix_same_sizes_every_seed(seed):
    m = mix("loci")
    files = genome.layout(m, seed, len(GENES), [len(g) for g in GENES], genome.source_records(m, BENCH.parent))
    assert len(files) == 16
    for recs in files:
        assert sorted((r.name, r.length) for r in recs) == sorted((n, len(s)) for n, s in LOCI.items())
        assert sum(r.length for r in recs) == 485_283
        assert all(0 <= r.rotation < r.length and not r.plants for r in recs)
    for name in LOCI:  # each contig in each orientation in half of the files
        assert sum(r.reverse for recs in files for r in recs if r.name == name) == 8
    assert len({tuple(r.name for r in recs) for recs in files}) > 1  # orders drawn


def reverse_complement(seq: bytes) -> bytes:
    return seq[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


def test_source_files_hold_the_rotated_contigs(tmp_path):
    small = {"files": 4, "line_width": 80, "source": "benchmark/data/Loci.fasta"}
    paths, layouts = genome.make(small, SEED, GENES, tmp_path, "cpu")
    for path, recs in zip(paths, layouts):
        got = read_fasta(path)
        assert [d.split(",")[0].split()[0] for d, _ in got] == [r.name for r in recs]
        for (_, seq), rec in zip(got, recs):
            want = reverse_complement(LOCI[rec.name]) if rec.reverse else LOCI[rec.name]
            assert seq == want[rec.rotation :] + want[: rec.rotation]


@pytest.mark.parametrize("name", ["genome", "loci"])
def test_layout_is_deterministic_for_a_seed(name):
    m = mix(name)
    src = genome.source_records(m, BENCH.parent)
    a = genome.layout(m, SEED, len(GENES), [len(g) for g in GENES], src)
    b = genome.layout(m, SEED, len(GENES), [len(g) for g in GENES], src)
    c = genome.layout(m, SEED + 1, len(GENES), [len(g) for g in GENES], src)
    assert a == b
    assert a != c


def test_written_files_hold_the_layout(tmp_path):
    small = {"files": 2, "substitutions": [0.0, 0.0], "line_width": 80,
             "records": [{"name": "a", "length": 30_001, "locus": {"last_bp": 30_001, "spacing": 8000, "jitter": 2000}},
                         {"name": "b", "length": 999}],
             "scaffolds": {"name": "s", "count": 3, "min_length": 500, "max_length": 700}}
    paths, layouts = genome.make(small, SEED, GENES, tmp_path, "cpu")
    (tmp_path / "again").mkdir()
    again, _ = genome.make(small, SEED, GENES, tmp_path / "again", "cpu")
    assert [p.read_bytes() for p in paths] == [p.read_bytes() for p in again]
    for path, recs in zip(paths, layouts):
        lines = path.read_bytes().split(b"\n")
        assert max(len(line) for line in lines if not line.startswith(b">")) == 80
        got = read_fasta(path)
        assert [d.split()[0] for d, _ in got] == [r.name for r in recs]
        assert [len(s) for _, s in got] == [r.length for r in recs]
        for (_, seq), rec in zip(got, recs):
            for p in rec.plants:  # rate 0: the genes verbatim
                assert seq[p.pos : p.pos + len(GENES[p.gene])] == GENES[p.gene].upper()
    assert [len(r.plants) for r in layouts[0]] == [4, 0, 0, 0, 0]  # at 4, 12, 20 and 28 kb


def test_substitutions_follow_the_rate():
    rng = np.random.default_rng(1)
    gene = GENES[0] * 40
    out = genome.mutate(gene, 0.05, rng)
    diff = np.frombuffer(out, np.uint8) != np.frombuffer(gene.upper(), np.uint8)
    assert 0.03 < diff.mean() < 0.07
    assert set(out) <= set(b"ACGT")
