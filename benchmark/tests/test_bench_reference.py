"""The plain reference: the upstream's ground truth on the copied files,
exact distances against a brute-force count, the control failing, and
the import rules of the benchmark's modules."""

import ast
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference.distances import RecordScan
from benchmark.reference.fasta import read_fasta
from benchmark.reference.kmergma import find_hits
from benchmark.reference.prep import cluster_profiles, estimate_optimal_thresholds, gen_ref_ws_cons

BENCH = Path(__file__).resolve().parents[1]
DATA = BENCH / "data"
REF = DATA / "Alp_V_ref.fasta"

#: KmerGMA.jl test/test_folder/test-KmerGMA.jl:189: findGenes' hit loci on Loci.fasta
GOLDEN_LOCI = [8543, 20425, 221912, 234018, 450875, 467930, 477868]
#: chip_smoke.py GOLDEN_LOCUS, GOLDEN_CLUSTER_THRS and GOLDEN_CLUSTER (commit 643846b)
GOLDEN_LOCUS = [
    "AM773548.1 | dist = 8.1 | MatchPos = 6852:7140 | GenomePos = 0 | Len = 289",
    "AM773548.1 | dist = 24.87 | MatchPos = 23907:24201 | GenomePos = 0 | Len = 295",
    "AM773548.1 | dist = 10.99 | MatchPos = 33845:34133 | GenomePos = 0 | Len = 289",
]
GOLDEN_CLUSTER_THRS = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
#: KmerGMA.jl test/test_folder/test-KmerGMA.jl:167-211: findGenes on Loci.fasta at fixed thresholds,
#: (kwargs, number of hits, {index: description})
UPSTREAM_LOCI = [
    ({"kmer_dist_thr": 30, "do_align": False}, 7, {
        1: "JQ684648.1 | dist = 9.21 | MatchPos = 20380:20768 | GenomePos = 0 | Len = 389",
        4: "AM773548.1 | dist = 8.1 | MatchPos = 6807:7195 | GenomePos = 444023 | Len = 389"}),
    ({"kmer_dist_thr": 30, "do_align": True}, 7, {
        1: "JQ684648.1 | dist = 9.21 | MatchPos = 20425:20713 | GenomePos = 0 | Len = 289",
        4: "AM773548.1 | dist = 8.1 | MatchPos = 6852:7140 | GenomePos = 444023 | Len = 289",
        5: "AM773548.1 | dist = 24.87 | MatchPos = 23907:24201 | GenomePos = 444023 | Len = 295"}),
    ({"kmer_dist_thr": 10, "do_align": False}, 3, {
        0: "JQ684648.1 | dist = 9.21 | MatchPos = 20380:20768 | GenomePos = 0 | Len = 389",
        2: "AM773548.1 | dist = 8.1 | MatchPos = 6807:7195 | GenomePos = 444023 | Len = 389"}),
]
#: KmerGMA.jl test-KmerGMA.jl:215-226: cluster mode on Alp_V_locus.fasta, five clusters without the
#: average, thresholds [37, 33, 38, 34, 28], buffer 200
UPSTREAM_CLUSTER_BUFF200 = [
    "AM773548.1 | Dist = 20.17 | KFV = 3 | MatchPos = 6852:7139 | GenomePos = 0 | Len = 288",
    "AM773548.1 | Dist = 33.96 | KFV = 4 | MatchPos = 23907:24198 | GenomePos = 0 | Len = 292",
    "AM773548.1 | Dist = 26.17 | KFV = 3 | MatchPos = 33845:34132 | GenomePos = 0 | Len = 288",
]
#: find_genes_cluster_mode at its defaults (Julia's thresholds, buffer 100) on Loci.fasta, as the JAX
#: package of this repository returns it on the CPU at commit 643846b: a second implementation, though
#: one that the program's plain code was ported from
JAX_CLUSTER_LOCI = [
    "JQ684648.1 | Dist = 37.42 | KFV = 4 | MatchPos = 646:934 | GenomePos = 0 | Len = 289",
    "JQ684648.1 | Dist = 29.88 | KFV = 5 | MatchPos = 8543:8832 | GenomePos = 0 | Len = 290",
    "JQ684648.1 | Dist = 28.51 | KFV = 5 | MatchPos = 20425:20714 | GenomePos = 0 | Len = 290",
    "JQ684647.1 | Dist = 37.46 | KFV = 4 | MatchPos = 21333:21621 | GenomePos = 121478 | Len = 289",
    "JQ684647.1 | Dist = 37.36 | KFV = 4 | MatchPos = 36848:37136 | GenomePos = 121478 | Len = 289",
    "AM773729.1 | Dist = 29.88 | KFV = 5 | MatchPos = 685:974 | GenomePos = 221227 | Len = 290",
    "AM773729.1 | Dist = 28.51 | KFV = 5 | MatchPos = 12791:13080 | GenomePos = 221227 | Len = 290",
    "AM773548.1 | Dist = 37.59 | KFV = 4 | MatchPos = 6852:7140 | GenomePos = 444023 | Len = 289",
    "AM773548.1 | Dist = 11.98 | KFV = 5 | MatchPos = 23907:24199 | GenomePos = 444023 | Len = 293",
    "AM773548.1 | Dist = 29.47 | KFV = 5 | MatchPos = 33851:34139 | GenomePos = 444023 | Len = 289",
]
GOLDEN_CLUSTER = [
    "AM773548.1 | Dist = 20.17 | KFV = 3 | MatchPos = 6852:7139 | GenomePos = 0 | Len = 288",
    "AM773548.1 | Dist = 33.96 | KFV = 4 | MatchPos = 23907:24193 | GenomePos = 0 | Len = 287",
    "AM773548.1 | Dist = 26.17 | KFV = 3 | MatchPos = 33845:34132 | GenomePos = 0 | Len = 288",
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


def test_loci_golden_hit_loci():
    hits = find_hits("find_genes", {"verbose": False}, DATA / "Loci.fasta", REF)
    loci = [int(re.search(r"MatchPos = (\d+):", d).group(1)) + int(re.search(r"GenomePos = (\d+)", d).group(1))
            for d, _ in hits]
    assert loci == GOLDEN_LOCI


def test_locus_golden_records():
    hits = find_hits("find_genes", {"verbose": False}, DATA / "Alp_V_locus.fasta", REF)
    assert [d for d, _ in hits] == GOLDEN_LOCUS
    assert [len(s) for _, s in hits] == [289, 295, 289]


def test_cluster_golden_records():
    hits = find_hits("find_genes_cluster_mode", {"kmer_dist_thrs": GOLDEN_CLUSTER_THRS, "buffer": 100},
                     DATA / "Alp_V_locus.fasta", REF)
    assert [d for d, _ in hits] == GOLDEN_CLUSTER


@pytest.mark.parametrize("case", range(len(UPSTREAM_LOCI)))
def test_loci_upstream_records(case):
    kwargs, n, want = UPSTREAM_LOCI[case]
    hits = find_hits("find_genes", {**kwargs, "verbose": False}, DATA / "Loci.fasta", REF)
    assert len(hits) == n
    assert {i: hits[i][0] for i in want} == want


def test_cluster_upstream_records_at_buffer_200():
    # the average's profile is kept from firing by a threshold below every distance
    hits = find_hits("find_genes_cluster_mode", {"kmer_dist_thrs": [37, 33, 38, 34, 28, -1], "buffer": 200},
                     DATA / "Alp_V_locus.fasta", REF)
    assert [d for d, _ in hits] == UPSTREAM_CLUSTER_BUFF200


def test_cluster_defaults_on_loci_equal_the_jax_package():
    hits = find_hits("find_genes_cluster_mode", {"verbose": False}, DATA / "Loci.fasta", REF)
    assert [d for d, _ in hits] == JAX_CLUSTER_LOCI
    assert [len(s) for _, s in hits] == [int(d.rsplit("= ", 1)[1]) for d in JAX_CLUSTER_LOCI]


def test_thresholds_upstream_goldens():
    # KmerGMA.jl test-KmerGMA.jl:115-120
    refs = read_fasta(REF)
    profile = dataclasses.replace(gen_ref_ws_cons(refs, 6)[0], windowsize=299)
    assert round(estimate_optimal_thresholds([profile], 12)[0]) == 27
    clusters = cluster_profiles(refs, 6, [7, 12, 20, 25])[:-1]  # without the average
    assert [round(t) for t in estimate_optimal_thresholds(clusters, 8)] == [38, 33, 41, 37, 29]


def _brute(codes: np.ndarray, s: np.ndarray, k: int, ws: int, r: int) -> np.ndarray:
    out = []
    for i in range(codes.shape[0] - ws + 1):
        win = codes[i : i + ws]
        kc = sum(win[t : t + ws - k + 1].astype(np.int64) << (2 * (k - 1 - t)) for t in range(k))
        c = np.bincount(kc, minlength=4**k)
        out.append(int(((r * c - s) ** 2).sum()))
    return np.array(out) / (2.0 * k * r * r)


@pytest.mark.parametrize("k,wss", [(2, [7, 9]), (3, [12, 12, 20])])
def test_record_scan_equals_brute_force(k, wss):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 400).astype(np.int8)
    codes[100:130] = codes[200:230]  # repeats make counts above one
    profiles = [(rng.integers(0, 9, 4**k), int(rng.integers(1, 5)), ws) for ws in wss]
    dists = [_brute(codes, s, k, ws, r) for s, r, ws in profiles]
    thrs = [float(np.quantile(d, 0.3)) for d in dists]
    scan = RecordScan(codes, k, "cpu")
    got = scan.streams(profiles, thrs, [len(d) - 1 for d in dists])
    for (dist0, stream), d, thr in zip(got, dists, thrs):
        below = d < thr
        keep = below.copy()
        keep[1:] |= below[:-1]
        keep[0] = False
        assert dist0 == d[0]
        assert stream == [(int(i), float(d[i])) for i in np.flatnonzero(keep)]


def test_record_scan_chunks_agree(monkeypatch):
    from benchmark.reference import distances

    codes = np.random.default_rng(5).integers(0, 4, 3000).astype(np.int8)
    args = ([(np.arange(4**3) % 7, 3, 40)], [9.0], [2960])
    whole = RecordScan(codes, 3, "cpu").streams(*args)
    monkeypatch.setattr(distances, "CHUNK", 97)
    assert RecordScan(codes, 3, "cpu").streams(*args) == whole


#: the genome mix's planted locus at a size a test holds: two 485 kb files of the hashed background,
#: a gene every 8 kb with 0-5% substitutions
PLANTED = {"files": 2, "substitutions": [0.0, 0.05], "line_width": 80,
           "records": [{"name": "locus", "length": 485_283, "locus": {"last_bp": 485_283, "spacing": 8000, "jitter": 2000}}]}


@pytest.mark.parametrize("name, traffic, records", [("single.genome", PLANTED, 90), ("cluster.loci", "loci", 60)])
def test_control_comes_out_not_correct(tmp_path, name, traffic, records):
    """The float32 control differs from the exact reference through either
    configuration: on the genome mix's planted locus, and on six files of
    the loci mix (the cells run 404.5 Mbp a file, or 16 files)."""
    from benchmark.control import readings
    from benchmark.harness.spec import load_cell

    cell = load_cell(name)
    if traffic == "loci":
        cell.traffic = dict(cell.traffic, files=6)
    else:
        cell.traffic = traffic
    got = readings(cell, 1, "cpu", tmp_path)
    assert got["hit_records"] > records
    assert got["program_hits_differing"] == 0
    assert got["control_hits_differing"] > 0


def test_reference_on_the_card_equals_the_cpu(card):
    args = ("find_genes_cluster_mode", {"verbose": False}, DATA / "Loci.fasta", REF)
    assert find_hits(*args, device=card) == find_hits(*args, device="cpu")


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = _top_level_imports(path) & {"jax", "jaxlib", "flax", "kmergma_tpu"}
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "kmergma_tpu_torch" not in _top_level_imports(path), path
