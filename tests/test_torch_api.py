"""The port's public API (kmergma_tpu_torch.find_genes, write_results,
record_kmergma) on the reference goldens of tests/test_api_golden.py and
tests/test_miner_golden.py, and the guard that the port never imports jax."""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

import kmergma_tpu_torch as kt
from kmergma_tpu.ops.reference import gen_ref_ws_cons
from kmergma_tpu.ops.scan_host import HostScanEngine
from kmergma_tpu.utils.fasta import as_records, read_fasta
from kmergma_tpu_torch.models.miner import _default_engine, mine_genome
from kmergma_tpu_torch.ops.scan import ScanEngine

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_LOCUS = [
    "AM773548.1 | dist = 8.1 | MatchPos = 6852:7140 | GenomePos = 0 | Len = 289",
    "AM773548.1 | dist = 24.87 | MatchPos = 23907:24201 | GenomePos = 0 | Len = 295",
    "AM773548.1 | dist = 10.99 | MatchPos = 33845:34133 | GenomePos = 0 | Len = 289",
]


def test_find_genes_golden(mini_genome, ref_fasta):
    hits = kt.find_genes(genome_path=mini_genome, ref_path=ref_fasta, verbose=False)[0]
    assert [h.description for h in hits] == GOLDEN_LOCUS


def test_find_genes_loci_align_and_hit_loci(test_genome, ref_fasta):
    hits, loci = kt.find_genes(
        test_genome, ref_fasta, kmer_dist_thr=30, do_return_hit_loci=True, verbose=False
    )
    assert len(hits) == 7
    assert loci == [8543, 20425, 221912, 234018, 450875, 467930, 477868]
    assert hits[1].description == (
        "JQ684648.1 | dist = 9.21 | MatchPos = 20425:20713 | GenomePos = 0 | Len = 289"
    )
    assert hits[5].description == (
        "AM773548.1 | dist = 24.87 | MatchPos = 23907:24201 | GenomePos = 444023 | Len = 295"
    )


def test_find_genes_return_dists(test_genome, ref_fasta):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # thr below the estimate, dists memory
        hits, dists = kt.find_genes(
            test_genome, ref_fasta, kmer_dist_thr=10, do_align=False,
            do_return_dists=True, verbose=False,
        )
    assert dists.shape[0] == 484127
    assert round(float(dists.mean())) == 46
    assert len(hits) == 3
    assert hits[0].description == (
        "JQ684648.1 | dist = 9.21 | MatchPos = 20380:20768 | GenomePos = 0 | Len = 389"
    )
    assert hits[-1].description == (
        "AM773548.1 | dist = 8.1 | MatchPos = 6807:7195 | GenomePos = 444023 | Len = 389"
    )


def test_output_ordering(mini_genome, ref_fasta):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = kt.find_genes(
            mini_genome, ref_fasta, do_return_hit_loci=True, do_return_align=True,
            do_return_dists=True, verbose=False,
        )
    assert len(out) == 4  # hits, loci, aligns, dists
    hits, loci, aligns, dists = out
    assert len(hits) == len(loci) == len(aligns) == 3
    assert dists.shape[0] == 41260 - 289


def test_write_results_roundtrip(tmp_path, mini_genome, ref_fasta):
    hits = kt.find_genes(mini_genome, ref_fasta, verbose=False)[0]
    out = tmp_path / "hits.fasta"
    kt.write_results(hits, str(out))
    back = list(read_fasta(out))
    assert [r.description for r in back] == [h.description for h in hits]
    assert [r.seq for r in back] == [h.seq for h in hits]


def test_record_kmergma_golden(mini_genome, ref_fasta):
    profile = gen_ref_ws_cons(ref_fasta, 6)
    record = as_records(mini_genome)[0]
    hits = kt.record_kmergma(record, profile, thr=30)
    assert [h.description for h in hits] == [d.replace(" | GenomePos = 0", "") for d in GOLDEN_LOCUS]


@pytest.mark.parametrize("kwarg", ["devices", "checkpoint_path"])
def test_unported_options_raise(mini_genome, ref_fasta, kwarg):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        kt.find_genes(mini_genome, ref_fasta, verbose=False, **{kwarg: 2 if kwarg == "devices" else "x.ckpt"})


def test_overflow_falls_back_to_host_engine(ref_fasta, mini_genome):
    """A profile beyond the int32 headroom mines on the exact int64 host
    engine, with the same hits as the device engine where both apply."""
    profile = gen_ref_ws_cons(ref_fasta, 6)
    assert isinstance(_default_engine(profile), ScanEngine)
    big = gen_ref_ws_cons(ref_fasta, 6)
    big.sum_kfv = profile.sum_kfv * 1000
    big.n_records = profile.n_records * 1000
    assert isinstance(_default_engine(big), HostScanEngine)
    host = mine_genome(mini_genome, profile, thr=30, engine=HostScanEngine(
        profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records))
    dev = mine_genome(mini_genome, profile, thr=30)
    assert [h.description for h in dev.hits] == [h.description for h in host.hits] == GOLDEN_LOCUS
    np.testing.assert_array_equal([len(h.seq) for h in dev.hits], [289, 295, 289])


def test_port_never_imports_jax(mini_genome, ref_fasta):
    # a subprocess: this test process has jax loaded (tests/conftest.py)
    code = (
        "import sys, kmergma_tpu_torch as kt, kmergma_tpu_torch.host\n"
        f"hits = kt.find_genes({mini_genome!r}, {ref_fasta!r}, verbose=False)[0]\n"
        "assert len(hits) == 3, hits\n"
        f"hits = kt.find_genes_cluster_mode({mini_genome!r}, {ref_fasta!r}, verbose=False)[0]\n"
        "assert len(hits) > 0, hits\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # see tests/_torch_one_thread.py
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_host_names_are_the_shared_originals():
    """kmergma_tpu_torch.host re-exports the JAX package's host objects
    themselves, not copies."""
    import importlib

    from kmergma_tpu_torch import host

    origins = {
        "kmergma_tpu.models.state_machine": ["OmnHitEvent", "replay_omn", "replay_single"],
        "kmergma_tpu.ops.align": ["AlignResult", "cigar_to_unitrange", "semiglobal_align", "semiglobal_align_batch"],
        "kmergma_tpu.ops.reference": [
            "ClusterRefs", "RefProfile", "cluster_ref_api", "eliminate_null_params", "gen_ref_ws_cons",
        ],
        "kmergma_tpu.ops.scan_host": ["HostScanEngine"],
        "kmergma_tpu.ops.thresholds": ["estimate_optimal_threshold", "estimate_optimal_thresholds"],
        "kmergma_tpu.utils.fasta": ["FastaRecord", "PathOrRecords", "as_records", "write_fasta"],
        "kmergma_tpu.utils.native": ["scan_rolling_i64_native"],
    }
    assert sorted(n for names in origins.values() for n in names) == sorted(host.__all__)
    for mod, names in origins.items():
        origin = importlib.import_module(mod)
        for name in names:
            assert getattr(host, name) is getattr(origin, name), name


def _imported_modules(path: Path) -> set[str]:
    import ast

    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


_ROOT = Path(__file__).resolve().parent.parent
_PORT_FILES = sorted(
    str(p.relative_to(_ROOT)) for p in [_ROOT / "chip_smoke.py", *(_ROOT / "kmergma_tpu_torch").rglob("*.py")]
)


@pytest.mark.parametrize("rel", _PORT_FILES)
def test_jax_package_reached_only_through_host(rel):
    """No file of the port, and not chip_smoke.py, imports jax; only
    kmergma_tpu_torch/host.py names modules of the JAX package."""
    mods = _imported_modules(_ROOT / rel)
    assert not {m for m in mods if m == "jax" or m.startswith(("jax.", "jaxlib"))}, rel
    jax_pkg = {m for m in mods if m == "kmergma_tpu" or m.startswith("kmergma_tpu.")}
    if rel == "kmergma_tpu_torch/host.py":
        assert jax_pkg
    else:
        assert not jax_pkg, (rel, jax_pkg)


def test_chip_smoke_phases_on_cpu(capsys):
    """chip_smoke.run drives every phase of both paths, single profile and
    cluster mode, the stage breakdown and the busy shares included, on CPU
    tensors at a small size: the wrappers take their plain twins, so the
    kernels' report shows no launch and no error."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    report = cs.run("cpu", contig_bp=150_000, n_contigs=2, plant_every=50_000, whole_bp=20_000, runs=1, label="cpu")
    out = capsys.readouterr().out
    assert [k["name"] for k in report["kernels"]] == [
        "fused_record_bitmaps", "match_counts", "fused_cluster_record_bitmaps", "lookup_roundtrip", "codes_pair_multi",
    ]
    assert all(k["launches"] == 0 and k["max_abs_err"] == 0 for k in report["kernels"])
    assert all(k["replaces"].startswith("kmergma_tpu/") and (_ROOT / k["source"]).exists() for k in report["kernels"])
    assert "hits equal the host oracle's" in out
    assert "cluster hits equal the host oracle's" in out
    assert "cluster goldens: Alp_V_locus 3 hits exact" in out
    assert out.count("idle share") == 2


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_cuda(tmp_path, where):
    """Without a CUDA device (and so here, on the CPU) chip_smoke.py exits
    non-zero and prints no result, in the checkout and copied alone."""
    import shutil

    script = _ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
