"""The harness: every name resolves to its file, a new cell needs only new
files and entries, the metric readers, the result line, and the check
failing when the timed path is broken underneath."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark.harness import spec, trace
from benchmark.harness.runner import run_cell
from benchmark.harness.spans import Spans, self_ms_per_call

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
#: a mix small enough for the CPU: two files, planted loci, a short scaffold
TINY = {"files": 2, "substitutions": [0.0, 0.05], "line_width": 80, "profile_calls": 2,
        "records": [{"name": "a", "length": 40_000, "locus": {"last_bp": 40_000, "spacing": 8000, "jitter": 2000}},
                    {"name": "b", "length": 12_000, "locus": {"last_bp": 12_000, "spacing": 8000, "jitter": 2000}}],
        "scaffolds": {"name": "s", "count": 2, "min_length": 3000, "max_length": 5000}}
#: the loci mix's shape on the 41 kb locus: real contigs, rotated, one file of two reversed
TINY_SOURCE = {"files": 2, "line_width": 80, "profile_calls": 2,
               "source": "benchmark/data/Alp_V_locus.fasta"}


def tiny_run(name: str, trace_on: bool, tmp_path: Path, root: Path = ROOT, seconds: float = 1.0) -> dict:
    cell = spec.load_cell(name, root=root)
    if cell.traffic.get("files", 0) > 2 or name.endswith("genome"):
        cell.traffic = TINY_SOURCE if cell.traffic.get("source") else TINY
    return run_cell(cell, 2**31 + 99, seconds, trace_on, "cpu", time.perf_counter(), tmp_path, log=lambda _: None)


def test_every_name_resolves_to_its_file():
    bench = spec.load_benchmark()
    assert bench["paths"] == ["benchmark"]
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.parts[-3:-1] == ("benchmark", "configs")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["reduced"] == ["genome_bp_max"] and cfg["genome_bp_max"] < cfg["source_genome_bp"]
        assert (ROOT / cfg["ref_set"]).is_file()
    for w in bench["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        cell = spec.load_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        names = {m.name for m in cell.end_to_end}
        assert {"mbp_per_s", "setup_s"} <= names
        assert {m.name for m in cell.per_layer} == {"parse_ms", "prep_ms", "scan_ms", "align_ms", "scan_roofline", "device_idle_pct"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]).read)


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "single.tiny", "config": "igv_single_k6", "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher", "source": "program_span",
                               "layer": "engine", "moves": "mbp_per_s", "workloads": ["single.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(TINY))
    (root / "benchmark" / "metrics" / "calls_traced.py").write_text(
        'SPANS = {"engine_call": ["kmergma_tpu_torch.ops.scan:ScanEngine.record_stream"]}\n\n'
        "def read(run):\n    return len(run['traced_calls'])\n")
    out = tiny_run("single.tiny", True, tmp_path, root=root)
    assert out["correct"]
    assert out["metrics"]["calls_traced"]["value"] == out["attempted"] - TINY["profile_calls"]  # the window's
    assert set(out["metrics"]) == {"calls_traced"}  # the others list their cells


def test_span_readers_on_a_hand_made_log():
    spans = [
        {"name": "call", "start": 0.0, "end": 1.0, "parent": None, "call": 0},
        {"name": "parse", "start": 0.0, "end": 0.2, "parent": 0, "call": 0},
        {"name": "scan", "start": 0.3, "end": 0.7, "parent": 0, "call": 0},
        {"name": "prep", "start": 0.7, "end": 0.75, "parent": 0, "call": 0},
        {"name": "call", "start": 1.0, "end": 2.0, "parent": None, "call": 1},
        {"name": "scan", "start": 1.1, "end": 1.3, "parent": 4, "call": 1},
        {"name": "align", "start": 1.15, "end": 1.2, "parent": 5, "call": 1},
    ]
    run = {"spans": spans, "traced_calls": [0, 1]}
    assert self_ms_per_call(run, "parse") == pytest.approx(100.0)
    assert self_ms_per_call(run, "scan") == pytest.approx((400 + 150) / 2)
    assert self_ms_per_call(run, "align") == pytest.approx(25.0)
    assert self_ms_per_call(run, "call") == pytest.approx((1000 - 650 + 1000 - 200) / 2)
    assert spec.load_reader("prep_ms").read(run) == pytest.approx(25.0)
    assert spec.load_reader("parse_ms").read({"spans": [], "traced_calls": []}) is None


def test_window_readers_on_hand_made_calls():
    calls = [{"start": float(i), "end": i + 0.5 + 0.01 * i, "bp": 2_000_000} for i in range(20)]
    run = {"calls": calls, "setup_s": 12.5}
    assert spec.load_reader("mbp_per_s").read(run) == pytest.approx(40.0 / (19.69 - 0.0))
    walls = sorted(c["end"] - c["start"] for c in calls)
    assert spec.load_reader("call_p90_ms").read(run) == pytest.approx(1e3 * (walls[17] + 0.9 * (walls[18] - walls[17])))
    assert spec.load_reader("setup_s").read(run) == 12.5


def test_trace_readers_on_a_hand_made_trace():
    tr = {
        "device": [(10.0, 20.0), (15.0, 30.0), (50.0, 60.0), (95.0, 120.0)],
        "kernels": [(10.0, 20.0), (15.0, 30.0), (95.0, 120.0)],
        "ops": {"k1": 25.0, "Memcpy HtoD": 10.0, "k2": 5.0},
        "ranges": [("call", 0.0, 100.0), ("parse", 0.0, 9.0), ("scan", 30.0, 100.0), ("align", 60.0, 70.0)],
    }
    run = {"trace": tr, "files": [[1_000_000]], "windowsizes": [289], "profiled_calls": [{"file": 0}]}
    assert trace.busy_us(tr) == pytest.approx(20.0 + 10.0 + 5.0)
    assert trace.busy_us(tr, "kernels") == pytest.approx(25.0)
    assert spec.load_reader("device_idle_pct").read(run) == pytest.approx(65.0)
    least_us = 1_000_000 / 3.35e12 * 1e6
    assert spec.load_reader("scan_roofline").read(run) == pytest.approx(100 * least_us / 25.0)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["k1", 25.0e-6]
    # [60, 95): align holds 60-70, scan 70-95
    assert b["idle_gaps"] == [["scan", 35e-6], ["scan", 20e-6], ["parse", 10e-6]]
    assert spec.load_reader("scan_roofline").read({"trace": None}) is None


def test_spans_wrap_and_restore():
    import kmergma_tpu_torch.models.miner as miner

    original = miner.as_records
    spans = Spans("cpu")
    spans.install({"parse": ["kmergma_tpu_torch.models.miner:as_records"]})
    assert miner.as_records is not original
    spans.remove()
    assert miner.as_records is original


@pytest.mark.parametrize("name", ["single.genome", "cluster.loci"])
@pytest.mark.parametrize("trace_on", [False, True])
def test_result_line_has_the_contract_keys(tmp_path, name, trace_on):
    out = tiny_run(name, trace_on, tmp_path, seconds=4.0)
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) == set(KEYS) | {"checks"} | ({"breakdown"} if trace_on else set())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert all(c["value"] == 0 and c["limit"] == 0 for c in out["checks"].values())
    if trace_on:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert {"parse_ms", "prep_ms", "scan_ms", "align_ms"} <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"mbp_per_s", "setup_s"} | ({"call_p90_ms"} if name == "cluster.loci" else set())
    json.dumps(out)


def test_an_input_past_the_configured_scale_is_refused(tmp_path):
    cell = spec.load_cell("single.genome")
    cell.traffic = TINY
    cell.config["genome_bp_max"] = 40_000
    with pytest.raises(ValueError, match="genome_bp_max"):
        run_cell(cell, 1, 1.0, False, "cpu", time.perf_counter(), tmp_path, log=lambda _: None)


def test_the_profiled_stretch_has_ranges_without_syncs(tmp_path, monkeypatch):
    """The window's spans synchronise and come off before the profiled
    stretch, whose ranges do not; the span metrics read the window alone."""
    from benchmark.harness import runner

    made = []

    class Kept(Spans):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(runner, "Spans", Kept)
    out = tiny_run("cluster.loci", True, tmp_path, seconds=2.0)
    assert out["correct"]
    window, ranges = made
    assert window.sync and not ranges.sync
    assert not window._patches and not ranges._patches
    window_ids = {s["call"] for s in window.log}
    profiled_ids = {s["call"] for s in ranges.log}
    assert profiled_ids and not window_ids & profiled_ids
    assert {s["name"] for s in ranges.log} == {s["name"] for s in window.log}
    assert out["attempted"] == len(window_ids) + len(profiled_ids)


def _alter_answer(mp):
    import kmergma_tpu_torch.models.miner as miner

    mp.setattr(miner, "fmt_dist", lambda x: repr(round(float(x) + 0.01, 2)))


def _drop_half(mp):
    import kmergma_tpu_torch.models.miner as miner

    original = miner.as_records
    mp.setattr(miner, "as_records", lambda g: original(g)[len(original(g)) // 2 :])


def _state_unchanged(mp):
    from kmergma_tpu_torch.ops.scan import ScanEngine

    original = ScanEngine.record_stream
    mp.setattr(ScanEngine, "record_stream", lambda self, *a, **kw: (original(self, *a, **kw)[0], [], None))


@pytest.mark.parametrize("fault", [_alter_answer, _drop_half, _state_unchanged])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    """The run past the chip check, with the timed path broken underneath:
    an answer altered where it is made, half of the records left out, and
    a scan that hands back no candidates.  (One card: no exchange between
    chips to leave out.)"""
    fault(monkeypatch)
    out = tiny_run("single.genome", False, tmp_path)
    assert not out["correct"]
    assert out["failed"] == out["attempted"]
    assert out["checks"]["hits_differing"]["value"] > 0


def test_a_call_that_raises_is_failed(tmp_path, monkeypatch):
    import kmergma_tpu_torch.models.omn_miner as omn

    def boom(*a, **kw):
        raise RuntimeError("planted")

    monkeypatch.setattr(omn, "semiglobal_align_batch", boom)
    out = tiny_run("cluster.loci", False, tmp_path)
    assert not out["correct"]
    assert out["checks"]["calls_raised"]["value"] == out["attempted"] > 0


def _run_py(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "single.genome", "--seed", "3000000000",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_cuda():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    got = _run_py(ROOT)
    assert got.returncode != 0 and got.stdout == ""
    assert "CUDA is not available" in got.stderr


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    got = _run_py(tmp_path)
    assert got.returncode != 0 and got.stdout == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    try:
        import run as run_py
    finally:
        sys.path.remove(str(BENCH))
    assert run_py.forbidden_modules() == [] or "kmergma_tpu_torch" not in run_py.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kmergma_tpu_torch_extra", sys)
    assert "kmergma_tpu_torch_extra" not in run_py.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run_py.forbidden_modules() == ["jaxlib"]
