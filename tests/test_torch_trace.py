"""The port's own tracer (kmergma_tpu_torch/utils/trace.py): the span tree
each API call leaves, hit records unchanged by tracing, nothing recorded
while it is off, the ``call`` span's counters against the miners'
``ScanStats``, the spans on the profiler's clock, and the kernels'
launch counts a call on the card."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kmergma_tpu_torch as kt
from kmergma_tpu_torch.utils import trace

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

DATA = Path(__file__).parent / "data"
GENOME = str(DATA / "Alp_V_locus.fasta")
REF = str(DATA / "Alp_V_ref.fasta")
ENTRIES = ["find_genes", "find_genes_cluster_mode", "strobemer_find_genes"]

#: (span, its parent's name) pairs of one call on the one-contig locus:
#: the reference set is parsed inside ``prep``, the genome inside ``call``;
#: the record's copy and passes nest in ``record``; in cluster mode each
#: candidate is aligned inside the replay
_TREE = {
    ("call", None), ("prep", "call"), ("parse", "prep"), ("parse", "call"), ("record", "call"),
    ("stage", "record"), ("bitmap", "record"), ("plan", "record"), ("fetch", "plan"), ("replay", "record"),
}
TREES = {
    "find_genes": _TREE | {("align", "record")},
    "find_genes_cluster_mode": _TREE | {("align", "replay")},
    "strobemer_find_genes": _TREE | {("align", "record"), ("extract", "record"), ("engine", "record")},
}


def _call(entry: str, device: str = "cpu") -> list:
    return getattr(kt, entry)(GENOME, REF, verbose=False, device=device)


def _records(hits) -> list:
    return [(h.description, bytes(h.seq)) for h in hits]


@pytest.fixture
def tracing():
    """The tracer on and empty for one test, then off and empty again."""
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


@pytest.fixture(scope="module")
def runs() -> dict:
    """Each entry's hit records untraced, then traced, and the traced
    call's span log."""
    assert not trace.enabled()
    out = {}
    for entry in ENTRIES:
        plain = _records(_call(entry)[0])
        trace.reset()
        trace.enable()
        try:
            traced = _records(_call(entry)[0])
        finally:
            trace.disable()
        out[entry] = (plain, traced, trace.log())
        trace.reset()
    return out


@pytest.mark.parametrize("entry", ENTRIES)
def test_each_call_leaves_one_closed_span_tree(runs, entry):
    """One ``call`` span a call, every span in it under its id and closed,
    each child inside its parent, and the names nested as the tracer's
    table says."""
    log = runs[entry][2]
    assert [s["name"] for s in log].count("call") == 1 and log[0]["name"] == "call"
    assert {s["call"] for s in log} == {0}
    pairs = set()
    for s in log:
        assert s["end"] is not None and s["start"] <= s["end"]
        parent = None if s["parent"] is None else log[s["parent"]]
        if parent is not None:
            assert parent["start"] <= s["start"] and s["end"] <= parent["end"]
        pairs.add((s["name"], None if parent is None else parent["name"]))
    assert pairs == TREES[entry]
    assert not trace._stack


@pytest.mark.parametrize("entry", ENTRIES)
def test_tracing_leaves_the_hit_records_unchanged(runs, entry):
    plain, traced, _log = runs[entry]
    assert plain and traced == plain


#: the ``prep`` span's threshold-estimate counters a call on the locus:
#: 100 random sequences a profile, ceil(length / 16) draws each
PREP_COUNTERS = {
    "find_genes": {"profiles": 1, "trials": 100, "draws": 1900},
    "find_genes_cluster_mode": {"profiles": 6, "trials": 600, "draws": 11100},
}


@pytest.mark.parametrize("entry", sorted(PREP_COUNTERS))
def test_the_prep_span_counts_the_threshold_estimate(runs, entry):
    (prep,) = [s for s in runs[entry][2] if s["name"] == "prep"]
    counters = dict(prep["counters"])
    assert counters.pop("rng_native") in (0, 1)
    assert counters == PREP_COUNTERS[entry]


def test_off_records_nothing_and_hands_out_one_no_op():
    assert not trace.enabled()
    trace.reset()
    first, second = trace.span("stage"), trace.span("plan")
    assert first is second and not first
    with first as sp:
        sp.add(bytes=1)
    trace.add_to_call(hits=1)
    assert _call("find_genes")[0]
    assert trace.log() == []


def test_the_strobe_call_opens_its_spans_with_their_counters():
    """A strobemer call on the one-contig locus: one ``extract`` and one
    ``engine`` span in its ``record`` span, one engine built, K4's pass at
    depth ws - k, the replay's hits that the score filter drops; the record's int8 crossing is a ``stage`` span where the
    miner extracts on the device (here the CPU stands in for it).  Off,
    the same calls record nothing."""
    from kmergma_tpu_torch.models.strobe_miner import gen_strobe_ref_ws_cons, strobe_mine_genome

    n = 41_260
    profile = gen_strobe_ref_ws_cons(REF)
    for on in (True, False):
        trace.reset()
        if on:
            trace.enable()
        try:
            _call("strobemer_find_genes")
            strobe_mine_genome(GENOME, profile, thr=30, device="cpu", device_extract=True)
        finally:
            trace.disable()
        log = trace.log()
        if not on:
            assert log == []
            continue
        api_log, miner_log = [s for s in log if s["call"] == 0], [s for s in log if s["call"] is None]
        (call,) = [s for s in api_log if s["name"] == "call"]
        assert call["counters"]["engines_built"] == 1
        for part in (api_log, miner_log):
            by = {name: [s for s in part if s["name"] == name] for name in ("record", "extract", "engine", "bitmap")}
            assert [s["counters"] for s in by["extract"]] == [{"bp": n, "windows": n - 5}]
            (engine,) = by["engine"]
            assert set(engine["counters"]) == {"xstar"} and 0 <= engine["counters"]["xstar"] < 256
            assert [s["counters"]["depth"] for s in by["bitmap"]] == [profile.windowsize - profile.k - 1]
            # the three hits of the locus stay; the score filter drops the rest of the replay's
            (replay,) = [s for s in part if s["name"] == "replay"]
            assert [s["counters"]["score_filtered"] for s in by["record"]] == [replay["counters"]["hits"] - 3]
            assert replay["counters"]["hits"] > 3
            for s in by["extract"] + by["engine"]:
                assert log[s["parent"]]["name"] == "record"
        stages = [s for s in miner_log if s["name"] == "stage"]
        assert [s["counters"] for s in stages] == [{"bytes": n}]
        assert log[stages[0]["parent"]]["name"] == "record"
    trace.reset()


def test_the_call_span_holds_the_mine_stats(tracing, monkeypatch):
    """Two calls back to back: two ``call`` spans with their own ids and
    their own counter records, each the ``ScanStats`` the miner returned;
    their ``record`` spans add up to the same windows and candidates."""
    import kmergma_tpu_torch.api as api

    results = []
    original = api.mine_genome

    def keep(*args, **kwargs):
        results.append(original(*args, **kwargs))
        return results[-1]

    monkeypatch.setattr(api, "mine_genome", keep)
    _call("find_genes")
    _call("find_genes")
    log = trace.log()
    calls = [s for s in log if s["name"] == "call"]
    assert [s["call"] for s in calls] == [0, 1] and calls[0]["counters"] is not calls[1]["counters"]
    for s, res in zip(calls, results):
        stats = dataclasses.asdict(res.stats)
        assert {k: s["counters"][k] for k in stats} == stats
        assert stats["replay_hits"] == stats["windows_aligned"] == stats["hits"] == 3
        records = [r for r in log if r["name"] == "record" and r["call"] == s["call"]]
        assert sum(r["counters"]["windows"] for r in records) == stats["windows_scanned"]
        assert sum(r["counters"]["candidates"] for r in records) == stats["candidate_windows"]
        assert s["counters"]["launches"] == {}  # the plain twins on the CPU launch nothing


def test_the_spans_are_on_the_profilers_clock(tracing):
    """Under ``torch.profiler`` every span is a ``kmergma.<name>`` range
    whose ends, on the Unix clock through the tracer's anchor, lie within
    1 ms of the span's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call("find_genes_cluster_mode")
    events = sorted(
        (e for e in prof.profiler.kineto_results.events() if e.name().startswith("kmergma.")),
        key=lambda e: e.start_ns(),
    )
    spans = sorted(trace.log(), key=lambda s: s["start"])
    assert [e.name() for e in events] == [f"kmergma.{s['name']}" for s in spans]
    for e, s in zip(events, spans):
        assert abs(e.start_ns() - trace.to_unix_ns(s["start"])) < 1e6
        assert abs(e.end_ns() - trace.to_unix_ns(s["end"])) < 1e6


def test_the_environment_turns_it_on_at_import():
    env = dict(os.environ, KMERGMA_TRACE="1")
    code = "from kmergma_tpu_torch.utils import trace; print(trace.enabled(), trace.anchor() is not None)"
    got = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert got.returncode == 0 and got.stdout.split() == ["True", "True"]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_launch_deltas_a_call_on_card(tracing, entry):
    """On the card each ``call`` span holds every kernel wrapper's launches
    over the call, as the wrappers' own counters move: at least the
    bitmap pass's, K2 and R1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _call(entry, "cuda")  # builds the kernels and imports every wrapper
    before = trace.launch_counts()
    _call(entry, "cuda")
    after = trace.launch_counts()
    calls = [s for s in trace.log() if s["name"] == "call"]
    want = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    assert calls[-1]["counters"]["launches"] == want
    assert want["K2"] >= 1 and want["R1"] == want["R1.kernel"] >= 1
    assert {"K1", "K3", "K4", "K5"} & set(want)
