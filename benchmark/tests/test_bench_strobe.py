"""The randstrobe cell and the locus cell of ``find_genes``: both resolve
with their metrics, the three readers that only ``strobe.genome`` reads,
and a small ``igv_strobe_s2`` run on the CPU that comes out correct."""

import pytest

from benchmark.harness import spec
from benchmark.harness.k4_bound import k4_least_ms
from benchmark.tests.test_bench_harness import tiny_run
from kmergma_tpu_torch.utils import trace

BENCH = ["parse_ms", "prep_ms", "scan_ms", "align_ms", "scan_roofline", "device_idle_pct"]
PROGRAM = ["stage_ms", "bitmap_ms", "plan_ms", "fetch_ms", "replay_ms", "recompute_pct"]
STROBE = ["extract_ms", "k4_roofline", "align_span_ms"]


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test here starts with the program's tracer off and empty."""
    trace.disable()
    trace.reset()
    yield


def test_the_new_cells_resolve_with_their_metrics():
    strobe = spec.load_cell("strobe.genome")
    assert strobe.config["name"] == "igv_strobe_s2" and strobe.config["entry"] == "strobemer_find_genes"
    assert strobe.config["reference"] == "benchmark.reference.strobe" and strobe.chips == 1
    assert strobe.traffic == spec.load_cell("single.genome").traffic
    assert [m.name for m in strobe.end_to_end] == ["mbp_per_s", "setup_s"]
    # the benchmark's own wrappers of as_records, the API's preparation and
    # the miners' aligner calls do not reach the strobemer miner
    assert [m.name for m in strobe.per_layer] == ["scan_ms", "device_idle_pct"] + PROGRAM + STROBE
    loci = spec.load_cell("single.loci")
    assert loci.config == spec.load_cell("single.genome").config and loci.traffic == spec.load_cell("cluster.loci").traffic
    assert [m.name for m in loci.end_to_end] == ["mbp_per_s", "call_p90_ms", "setup_s"]
    assert [m.name for m in loci.per_layer] == BENCH + PROGRAM
    for name in ("single.genome", "cluster.genome", "cluster.loci"):
        assert not set(STROBE) & {m.name for m in spec.load_cell(name).per_layer}
    trace.disable()
    trace.reset()


def _span(name, start, end, parent, call, **counters):
    return {"name": name, "start": start, "end": end, "parent": parent, "call": call, "counters": counters}


def test_extract_ms_on_a_hand_made_span_log():
    spans = [
        _span("call", 0.0, 1.0, None, 0),
        _span("record", 0.1, 0.6, 0, 0),
        _span("extract", 0.1, 0.13, 1, 0, bp=1000, windows=995),
        _span("record", 0.6, 0.9, 0, 0),
        _span("extract", 0.6, 0.61, 3, 0, bp=500, windows=495),
        _span("call", 1.0, 2.0, None, 1),
        _span("record", 1.1, 1.5, 5, 1),
        _span("extract", 1.1, 1.12, 6, 1, bp=1000, windows=995),
    ]
    reader = spec.load_reader("extract_ms")
    assert reader.read({"program_spans": spans, "traced_calls": [0, 1]}) == pytest.approx((40.0 + 20.0) / 2)
    assert reader.read({"program_spans": [s for s in spans if s["name"] != "extract"], "traced_calls": [0, 1]}) is None


def test_align_span_ms_on_a_hand_made_span_log():
    spans = [
        _span("call", 0.0, 1.0, None, 0),
        _span("record", 0.1, 0.9, 0, 0),
        _span("align", 0.5, 0.8, 1, 0, windows=12),
        _span("call", 1.0, 2.0, None, 1),
        _span("record", 1.1, 1.5, 3, 1),
        _span("align", 1.2, 1.3, 4, 1, windows=3),
        _span("align", 1.3, 1.4, 4, 1, windows=2),
    ]
    reader = spec.load_reader("align_span_ms")
    assert reader.read({"program_spans": spans, "traced_calls": [0, 1]}) == pytest.approx((300.0 + 200.0) / 2)
    assert reader.read({"program_spans": [s for s in spans if s["name"] != "align"], "traced_calls": [0, 1]}) is None


def test_k4_roofline_on_a_hand_made_trace():
    ops = {
        "void (anonymous namespace)::pair_roll_hist_kernel(unsigned char const*, long long, int, int, int, int, int*, int*)": 300.0,
        "void (anonymous namespace)::pair_depth_codes_kernel<unsigned char>(unsigned char const*, int, int, int, int, int, int*, int*)": 100.0,
        "void (anonymous namespace)::match_counts_kernel<false>(int const*)": 50.0,
        "Memcpy HtoD (Pageable -> Device)": 900.0,
    }
    tr = {"device": [], "kernels": [], "ops": ops, "ranges": []}
    files = [[10_000_000, 100, 290, 291, 5_000]]
    run = {"trace": tr, "files": files, "windowsizes": [289], "profiled_calls": [{"file": 0}, {"file": 0}]}
    # the records of 100, 290 and 291 bp have no transition
    nt = (10_000_000 - 290) + (5_000 - 290)
    assert k4_least_ms(files[0], 289) == pytest.approx(9 * nt / 3.35e12 * 1e3)
    want = 100.0 * 2 * (9 * nt / 3.35e12 * 1e6) / 400.0
    reader = spec.load_reader("k4_roofline")
    assert reader.read(run) == pytest.approx(want)
    assert reader.read({"trace": None}) is None
    assert reader.read({**run, "trace": {**tr, "ops": {"Memcpy HtoD": 5.0}}}) is None


@pytest.mark.parametrize("trace_on", [False, True])
def test_a_small_strobe_cell_runs_correct_on_the_cpu(tmp_path, trace_on):
    out = tiny_run("strobe.genome", trace_on, tmp_path, seconds=2.0)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert all(c["value"] == 0 and c["limit"] == 0 for c in out["checks"].values())
    if trace_on:
        # the CPU's trace has no device intervals, so K4 reads nothing here
        got = {k: v["value"] for k, v in out["metrics"].items()}
        assert set(got) == {"scan_ms", "device_idle_pct"} | set(PROGRAM) | {"extract_ms", "align_span_ms"}
        assert all(got[k] > 0 for k in ("scan_ms", "bitmap_ms", "plan_ms", "extract_ms", "align_span_ms"))
        assert got["device_idle_pct"] == 100.0
        assert not trace.enabled() and trace.log() == []
    else:
        assert set(out["metrics"]) == {"mbp_per_s", "setup_s"}
