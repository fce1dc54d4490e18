"""The readers of the program's own spans (``harness/program_spans.py``):
each reads a number in a traced run and nothing in an untraced one, the
tracer stays off without ``--trace 1``, the readers read nothing from a
program without a tracer, and the idle gaps named by program spans."""

import pytest

from benchmark.harness import program_spans, spec
from benchmark.tests.test_bench_harness import tiny_run
from kmergma_tpu_torch.utils import trace

PROGRAM = ["stage_ms", "bitmap_ms", "plan_ms", "fetch_ms", "replay_ms", "recompute_pct"]
BENCH = ["parse_ms", "prep_ms", "scan_ms", "align_ms", "scan_roofline", "device_idle_pct"]


def test_every_cell_reads_the_program_span_metrics():
    for w in spec.load_benchmark()["workloads"]:
        cell = spec.load_cell(w["name"])
        assert [m.name for m in cell.per_layer] == BENCH + PROGRAM
        for m in cell.per_layer[len(BENCH):]:
            assert m.reader.SPANS == {} and callable(m.reader.read)
    trace.disable()
    trace.reset()


@pytest.mark.parametrize("name", ["single.genome", "cluster.loci"])
def test_a_traced_run_reads_each_program_metric(tmp_path, name):
    """With tracing each new metric reads a number, the engine's spans
    inside ``record_stream(s)`` add up to no more than ``scan_ms``, and the
    tracer is off and empty again after the run."""
    assert not trace.enabled()
    out = tiny_run(name, True, tmp_path, seconds=2.0)
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(PROGRAM) <= set(got)
    assert all(got[k] >= 0 for k in PROGRAM) and got["stage_ms"] > 0 and got["plan_ms"] > 0
    assert 0 < got["recompute_pct"] <= 200
    engine = sum(got[k] for k in ("stage_ms", "bitmap_ms", "plan_ms", "fetch_ms"))
    assert engine <= got["scan_ms"] * 1.01 + 0.05
    assert not trace.enabled() and trace.log() == []


def test_an_untraced_run_leaves_the_tracer_off(tmp_path):
    trace.reset()
    out = tiny_run("single.genome", False, tmp_path)
    assert out["correct"] and not set(PROGRAM) & set(out["metrics"])
    assert not trace.enabled() and trace.log() == []


def test_a_program_without_a_tracer_reads_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(program_spans, "_tracer", lambda: None)
    out = tiny_run("cluster.loci", True, tmp_path)
    assert out["correct"] and not set(PROGRAM) & set(out["metrics"])
    assert {"parse_ms", "scan_ms"} <= set(out["metrics"])


def _span(name, start, end, parent, call, **counters):
    return {"name": name, "start": start, "end": end, "parent": parent, "call": call, "counters": counters}


def test_window_calls_and_gaps_on_hand_made_spans(tmp_path, monkeypatch):
    """The program's calls are kept whole by the runner's call they lie in,
    re-indexed; the readers take the window's; the profiled call's idle gaps
    are named by the innermost program span, on the profiler's clock."""
    spans = [
        _span("call", 0.1, 0.9, None, 0, windows_scanned=4096),
        _span("plan", 0.2, 0.5, 0, 0, k2_rows=2, rspan=1024),
        _span("fetch", 0.4, 0.5, 1, 0),
        _span("call", 10.1, 10.9, None, 1, windows_scanned=1000),
        _span("stage", 10.2, 10.4, 3, 1),
        _span("plan", 10.4, 10.8, 3, 1, k2_rows=1, rspan=1024),
    ]

    class Log:
        @staticmethod
        def log():
            return spans

        @staticmethod
        def enabled():
            return True

    monkeypatch.setattr(program_spans, "_tracer", lambda: Log)
    monkeypatch.setattr(program_spans, "_run_name", lambda: "hand-made")
    monkeypatch.setattr(program_spans, "ROOT", tmp_path)
    run = {
        "calls": [{"start": 0.0, "end": 1.0}], "traced_calls": [0],
        "profiled_calls": [{"start": 10.0, "end": 11.0}],
        # the profiler's clock runs 5 s behind the host's, in microseconds
        "trace": {"device": [(5.25e6, 5.3e6), (5.45e6, 5.5e6)], "kernels": [], "ops": {},
                  "ranges": [("call", 5.0e6, 6.0e6)]},
    }
    assert [s["name"] for s in program_spans.collect(run)] == ["call", "plan", "fetch"]
    assert [s["parent"] for s in run["program_profiled"]] == [None, 0, 0]
    assert spec.load_reader("plan_ms").read(run) == pytest.approx(200.0)
    assert spec.load_reader("fetch_ms").read(run) == pytest.approx(100.0)
    assert spec.load_reader("stage_ms").read(run) is None
    assert spec.load_reader("recompute_pct").read(run) == pytest.approx(100.0 * 2048 / 4096)
    gaps = program_spans.idle_gaps(run)
    # host 10.1-10.9 is the stretch, the device busy at 10.25-10.3 and
    # 10.45-10.5: each gap goes whole to the span open longest in it
    assert gaps["by_span"] == pytest.approx({"plan": 0.4, "call": 0.15, "stage": 0.15})
    assert gaps["idle_gaps"][0] == ["plan", pytest.approx(0.4)]
    assert (tmp_path / "build" / "benchmark" / "gaps-hand-made.json").is_file()
