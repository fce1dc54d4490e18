"""The port's public API (kmergma_tpu_torch.find_genes, write_results,
record_kmergma) on the reference goldens of tests/test_api_golden.py and
tests/test_miner_golden.py, the guards that the port never imports jax or
the JAX package, and that every entry point runs on the card unless asked
for the CPU."""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import kmergma_tpu_torch as kt
from kmergma_tpu.ops.reference import gen_ref_ws_cons
from kmergma_tpu_torch.ops.scan_host import HostScanEngine
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
    hits = kt.find_genes(genome_path=mini_genome, ref_path=ref_fasta, verbose=False, device="cpu")[0]
    assert [h.description for h in hits] == GOLDEN_LOCUS


def test_find_genes_loci_align_and_hit_loci(test_genome, ref_fasta):
    hits, loci = kt.find_genes(
        test_genome, ref_fasta, kmer_dist_thr=30, do_return_hit_loci=True, verbose=False, device="cpu"
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
            do_return_dists=True, verbose=False, device="cpu",
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
            do_return_dists=True, verbose=False, device="cpu",
        )
    assert len(out) == 4  # hits, loci, aligns, dists
    hits, loci, aligns, dists = out
    assert len(hits) == len(loci) == len(aligns) == 3
    assert dists.shape[0] == 41260 - 289


def test_write_results_roundtrip(tmp_path, mini_genome, ref_fasta):
    hits = kt.find_genes(mini_genome, ref_fasta, verbose=False, device="cpu")[0]
    out = tmp_path / "hits.fasta"
    kt.write_results(hits, str(out))
    back = list(read_fasta(out))
    assert [r.description for r in back] == [h.description for h in hits]
    assert [r.seq for r in back] == [h.seq for h in hits]


def test_record_kmergma_golden(mini_genome, ref_fasta):
    profile = gen_ref_ws_cons(ref_fasta, 6)
    record = as_records(mini_genome)[0]
    hits = kt.record_kmergma(record, profile, thr=30, device="cpu")
    assert [h.description for h in hits] == [d.replace(" | GenomePos = 0", "") for d in GOLDEN_LOCUS]


@pytest.mark.parametrize("kwarg", ["devices"])
def test_unported_options_raise(mini_genome, ref_fasta, kwarg):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 2"):
        kt.find_genes(mini_genome, ref_fasta, verbose=False, device="cpu", **{kwarg: 2})


def test_overflow_falls_back_to_host_engine(ref_fasta, mini_genome):
    """A profile beyond the int32 headroom mines on the exact int64 host
    engine, with the same hits as the device engine where both apply."""
    profile = gen_ref_ws_cons(ref_fasta, 6)
    assert isinstance(_default_engine(profile, "cpu"), ScanEngine)
    big = gen_ref_ws_cons(ref_fasta, 6)
    big.sum_kfv = profile.sum_kfv * 1000
    big.n_records = profile.n_records * 1000
    assert isinstance(_default_engine(big, "cpu"), HostScanEngine)
    host = mine_genome(mini_genome, profile, thr=30, engine=HostScanEngine(
        profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records))
    dev = mine_genome(mini_genome, profile, thr=30, device="cpu")
    assert [h.description for h in dev.hits] == [h.description for h in host.hits] == GOLDEN_LOCUS
    np.testing.assert_array_equal([len(h.seq) for h in dev.hits], [289, 295, 289])


def test_port_never_imports_jax(mini_genome, ref_fasta):
    # a subprocess: this test process has jax and the JAX package loaded
    # (tests/conftest.py); the port must load neither, nor the JAX
    # package's native library
    code = (
        "import sys, kmergma_tpu_torch as kt\n"
        f"hits = kt.find_genes({mini_genome!r}, {ref_fasta!r}, verbose=False, device='cpu')[0]\n"
        "assert len(hits) == 3, hits\n"
        f"hits = kt.find_genes_cluster_mode({mini_genome!r}, {ref_fasta!r}, verbose=False, device='cpu')[0]\n"
        "assert len(hits) > 0, hits\n"
        f"hits = kt.strobemer_find_genes({mini_genome!r}, {ref_fasta!r}, verbose=False, device='cpu')[0]\n"
        "assert len(hits) == 3, hits\n"
        "assert kt.exact_match('ACG', b'TTACGTTACG' * 120_000, device='cpu')[:2] == [(3, 5), (8, 10)]\n"
        "import kmergma_tpu_torch.bench, kmergma_tpu_torch.utils.cli\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'kmergma_tpu') or m.startswith(('jax.', 'jaxlib', 'kmergma_tpu.')))\n"
        "assert not bad, bad\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'kmergma_tpu/native' not in maps\n"
        "print('ok')\n"
    )
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # see tests/_torch_one_thread.py
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _imported_modules(path: Path) -> set[str]:
    """Every module a file imports, by statement or by name through
    ``importlib.import_module`` / ``__import__``."""
    import ast

    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                mods.add(node.args[0].value)
    return mods


_ROOT = Path(__file__).resolve().parent.parent
_PORT_FILES = sorted(
    str(p.relative_to(_ROOT)) for p in [_ROOT / "chip_smoke.py", *(_ROOT / "kmergma_tpu_torch").rglob("*.py")]
)


def _names_jax_package(mod: str) -> bool:
    # kmergma_tpu and kmergma_tpu.* exactly: kmergma_tpu_torch is the port
    return mod == "kmergma_tpu" or mod.startswith("kmergma_tpu.")


@pytest.mark.parametrize("rel", _PORT_FILES)
def test_jax_package_reached_only_through_host(rel):
    """No file of the port, and not chip_smoke.py, imports jax or a module
    of the JAX package (the port keeps its own copy of every host module
    it uses; kmergma_tpu_torch/host.py, which re-exported them, is gone)."""
    mods = _imported_modules(_ROOT / rel)
    assert not {m for m in mods if m == "jax" or m.startswith(("jax.", "jaxlib"))}, rel
    assert not {m for m in mods if _names_jax_package(m)}, rel
    assert rel != "kmergma_tpu_torch/host.py"


def test_import_guard_tells_the_port_from_the_jax_package():
    assert _names_jax_package("kmergma_tpu") and _names_jax_package("kmergma_tpu.ops.scan")
    assert not _names_jax_package("kmergma_tpu_torch") and not _names_jax_package("kmergma_tpu_torch.ops.scan")
    assert not (_ROOT / "kmergma_tpu_torch" / "host.py").exists()


def _entry_points(mini_genome, ref_fasta):
    """Every entry point of the port that picks a device, called with its
    default device."""
    from kmergma_tpu_torch.models.omn_miner import mine_genome_clusters
    from kmergma_tpu_torch.models.strobe_miner import StrobeSpanEngine, gen_strobe_ref_ws_cons, strobe_mine_genome
    from kmergma_tpu_torch.ops.reference import cluster_ref_api, eliminate_null_params
    from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons as port_gen_ref_ws_cons
    from kmergma_tpu_torch import bench as tbench
    from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
    from kmergma_tpu_torch.utils.cli import main as cli_main

    profile = port_gen_ref_ws_cons(ref_fasta, 6)
    clusters = eliminate_null_params(cluster_ref_api(ref_fasta, 6)).profiles
    strobe = gen_strobe_ref_ws_cons(ref_fasta)
    return {
        "find_genes": lambda: kt.find_genes(mini_genome, ref_fasta, verbose=False),
        "find_genes_cluster_mode": lambda: kt.find_genes_cluster_mode(mini_genome, ref_fasta, verbose=False),
        "strobemer_find_genes": lambda: kt.strobemer_find_genes(mini_genome, ref_fasta, verbose=False),
        "record_kmergma": lambda: kt.record_kmergma(as_records(mini_genome)[0], profile),
        "mine_genome": lambda: mine_genome(mini_genome, profile, thr=30),
        "mine_genome_clusters": lambda: mine_genome_clusters(mini_genome, clusters, thr_vec=[30.0] * len(clusters)),
        "strobe_mine_genome": lambda: strobe_mine_genome(mini_genome, strobe, thr=30),
        "ScanEngine": lambda: ScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records),
        "ClusterScanEngine": lambda: ClusterScanEngine(clusters, k=6),
        "StrobeSpanEngine": lambda: StrobeSpanEngine(strobe, 0),
        "bench.run": lambda: tbench.run(n_mbp=0.01, skip_extras=True),
        "exact_match": lambda: kt.exact_match("ACGTACGTAC", b"ACGT" * (1 << 18)),
        "cli": lambda: cli_main(["find-genes", "--genome", mini_genome, "--refs", ref_fasta, "-q"]),
    }


ENTRY_POINTS = [
    "find_genes", "find_genes_cluster_mode", "strobemer_find_genes", "record_kmergma", "mine_genome",
    "mine_genome_clusters", "strobe_mine_genome", "ScanEngine", "ClusterScanEngine", "StrobeSpanEngine",
    "bench.run", "exact_match", "cli",
]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_refuse_without_cuda(mini_genome, ref_fasta, name, monkeypatch):
    """With no device given, every entry point runs on the card, and raises
    without CUDA instead of going on on the CPU."""
    call = _entry_points(mini_genome, ref_fasta)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_other_devices_refused():
    from kmergma_tpu_torch.ops.scan import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_chip_smoke_phases_on_cpu(capsys):
    """chip_smoke.run drives every phase of every path (single profile,
    cluster mode, strobemers, checkpoint/resume of the three miners, the
    paired spectrum, the mixed-depth cluster set, the bench), the
    stage breakdowns and the busy shares included, on CPU tensors at a
    small size: the wrappers take their plain twins, so the kernels' report
    shows no launch and no error."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    bench_sizes = dict(n_mbp=0.5, dense_mbp=0.5, k10_mbp=0.2, strobe_mbp=0.1, g3_mbp=1.0, g3_rec_mbp=0.5)
    report = cs.run("cpu", contig_bp=100_000, n_contigs=3, plant_every=50_000, whole_bp=20_000, runs=1, label="cpu",
                    bench_sizes=bench_sizes, fragments=8)
    out = capsys.readouterr().out
    assert [k["name"] for k in report["kernels"]] == [
        "fused_record_bitmaps", "match_counts", "fused_cluster_record_bitmaps", "lookup_roundtrip", "codes_pair_multi",
        "codes_pair_ab_kcodes[K4r]", "codes_pair_ab_kcodes[K4]", "pair_ab_from_kcodes", "hash_genome",
    ]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    # each median time with its fastest window beside it; K1's and K3's stages on the card; device
    # times (K2, K4, K6), K2's whole-record rows, K6's prefix depth and K4r's s = 3 route
    extra = {"ms_min", "plain_ms_min", "library_ms_min", "stages_ms", "device_ms", "whole_record", "prefix_depth", "s3",
             "shapes", "fragmented"}
    assert all(keys | {"ms_min", "plain_ms_min"} <= set(k) <= keys | extra for k in report["kernels"])
    assert all(k["ms_min"] <= k["ms"] and k["plain_ms_min"] <= k["plain_ms"] for k in report["kernels"])
    assert [k["name"] for k in report["kernels"] if "stages_ms" in k] == ["fused_record_bitmaps", "fused_cluster_record_bitmaps"]
    assert [k["name"] for k in report["kernels"] if "device_ms" in k] == [
        "match_counts", "codes_pair_multi", "codes_pair_ab_kcodes[K4]", "pair_ab_from_kcodes",
    ]
    # K5 at the 60 kb, 16 kb and whole-record shapes, each with its launch shape and bound; the fragmented
    # assembly on the split route with both routes' bitmap passes
    k5 = next(k for k in report["kernels"] if k["name"] == "codes_pair_multi")
    assert sorted(k5["shapes"]) == ["16000", "20000", "60000"]
    assert all(v["bound_ms"] > 0 and v["launch"]["tile"] == 256 for v in k5["shapes"].values())
    assert k5["fragmented"]["records"] == 8 and k5["fragmented"]["mbps"] > 0
    assert sorted(k5["fragmented"]["bitmap_pass"]) == ["16000", "60000"]
    assert "the first 8 fragments' streams equal the int64 host cluster oracle's" in out
    k2 = next(k for k in report["kernels"] if k["name"] == "match_counts")
    k6 = next(k for k in report["kernels"] if k["name"] == "pair_ab_from_kcodes")
    assert k2["whole_record"]["rows"] > 0 and k6["prefix_depth"]["depth"] == 14
    assert all(k["launches"] == 0 and k["max_abs_err"] == 0 for k in report["kernels"])
    assert all(k["replaces"].startswith(("kmergma_tpu/", "bench.py:")) and (_ROOT / k["source"]).exists() for k in report["kernels"])
    assert all(k["bound_ms"] > 0 and k["bound_by"] in ("bytes", "operations") for k in report["kernels"])
    assert [k["library_ms"] is not None for k in report["kernels"]] == [False, False, False, True, False, False, False, False, False]
    assert out.count("bench # ") == 7
    assert "bench json: " in out and "bench hit-dense: " in out and "bench k=10: " in out
    assert "bench headline: K1 bit-identical to its twin" in out and "bench k=10 row: K1 (4^10 bins) bit-identical" in out
    assert "streams on the resident genome equal the int64 host cluster oracle's" in out
    assert "hits equal the int64 host strobe oracle's" in out
    assert "bench 3.2 Gbp: 2 records, dist0, streams and hits equal the int64 host engine's over each whole record" in out
    assert "hits equal the host oracle's" in out
    assert "cluster hits equal the host oracle's" in out
    assert "cluster goldens: Alp_V_locus 3 hits exact" in out
    assert "strobe goldens: Alp_V_locus 3 hits" in out
    assert "strobe hits equal the host oracle's" in out
    assert out.count("mixed-depth streams equal the int64 host oracle's") == 2
    assert out.count("idle share") == 6
    # each miner killed on its third record and resumed to the uninterrupted hits, then find_genes resumed
    for name, scanned in (("single", "1 records scanned of 3"), ("cluster", "2 records scanned of 4"),
                          ("strobe", "1 records scanned of 3")):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"checkpoint {name}: killed on record 2 after "))
        assert scanned in line and " bytes; resumed in " in line and line.endswith("[cpu]")
    assert "checkpoint api: find_genes resumed a run killed on record 2" in out
    assert "max_abs_err 0.0 against the CPU; 4000 bp slice max_abs_err 0.0 against the host loop" in out


def test_chip_smoke_pair_kernels_on_cpu(capsys):
    """``chip_smoke.py --pair-kernels`` (K2, K4, K6 and K5 alone at the main
    paths' shapes, each held against its plain twin) on CPU tensors at a
    small size: every shape timed, no device time off the card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.pair_kernels("cpu", label="cpu", contig_bp=150_000, whole_bp=20_000)
    assert sorted(out) == [
        "K2_region_rows", "K2_whole_record", "K4_depth14", "K4_depth16", "K5_16000bp", "K5_20000bp", "K5_60000bp",
        "K6_depth14", "K6_depth16",
    ]
    assert all(v["ms"] > 0 and v["ms_min"] <= v["ms"] and v["device_ms"] is None for v in out.values())
    assert "bit-identical=False" not in capsys.readouterr().out


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
