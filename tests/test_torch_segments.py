"""Long records on the port: the segmented pass, mid-record resume, the
cross-record prefetch and the pinned copies to the card, against the JAX
package.

A record of host codes longer than 2 x chunk windows is scanned a segment
at a time (``ScanEngine._segmented_bitmaps``); its (dist0, stream) must
equal the one-pass path's and the JAX ``ScanEngine``'s exactly.  A run
killed after N segments resumes after segment N, within the port and
across packages in both directions: the segment counts of the resumed runs
prove it.  The JAX package is imported inside the tests that use it, so
the ``cuda`` test here runs on the card with ``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_segments.py
"""

import json
import os

import numpy as np
import pytest
import torch

from kmergma_tpu_torch.models import miner as tminer
from kmergma_tpu_torch.models import omn_miner as tomn
from kmergma_tpu_torch.ops import reference as tref
from kmergma_tpu_torch.ops import scan as tscan
from kmergma_tpu_torch.ops.scan import PinnedStaging, ScanEngine
from kmergma_tpu_torch.ops.scan_cluster import ClusterScanEngine
from kmergma_tpu_torch.utils.checkpoint import ScanCheckpoint
from kmergma_tpu_torch.utils.fasta import FastaRecord, as_records

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CLUSTER_THRS = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]


def _planted_record(ref_fasta, seed: int, positions, n: int = 120_000) -> FastaRecord:
    """Random background with reference genes planted at ``positions``
    (the JAX fault-tolerance tests' record)."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)].copy()
    refs = as_records(ref_fasta)
    for pos in positions:
        g = refs[pos % len(refs)].seq.upper()
        seq[pos : pos + len(g)] = np.frombuffer(g, dtype=np.uint8)
    return FastaRecord("big", seq.tobytes())


def _engine(profile, chunk: int) -> ScanEngine:
    return ScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records, device="cpu",
                      chunk_windows=chunk)


def _kill_after(engine, n_segments: int) -> None:
    """Make ``engine``'s segmented pass raise ``KeyboardInterrupt`` once
    ``n_segments`` segments are persisted (the JAX tests' killer)."""
    real = engine._segmented_bitmaps
    done = [0]

    def killer(codes, nw, thr_int, tracker=None):
        if tracker is not None:
            orig = tracker.done_segment

            def dying(si, words, fp):
                orig(si, words, fp)
                done[0] += 1
                if done[0] >= n_segments:
                    raise KeyboardInterrupt("killed mid-record")

            tracker.done_segment = dying
        return real(codes, nw, thr_int, tracker)

    engine._segmented_bitmaps = killer


def _count_segments(engine) -> list:
    """Count the segments the port's engine scans (one K1 pass each)."""
    real, calls = engine._record_bitmap, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    engine._record_bitmap = counted
    return calls


def _same(got, want) -> None:
    assert [(h.description, h.seq) for h in got.hits] == [(h.description, h.seq) for h in want.hits]
    assert got.hit_loci == want.hit_loci


# --- the JAX package's segment tests, on the port --------------------------


def test_mid_record_segment_resume(tmp_path, ref_fasta):
    profile = tref.gen_ref_ws_cons(ref_fasta, 6)
    record = _planted_record(ref_fasta, 5, (20_000, 55_000, 90_000))
    engine = _engine(profile, 4096)  # segments of 8192 windows: 15 of them
    baseline = tminer.mine_genome([record], profile, thr=30, engine=engine, get_hit_loci=True)
    assert len(baseline.hits) >= 3

    ckpt = str(tmp_path / "seg.ckpt")
    _kill_after(engine, 4)
    with pytest.raises(KeyboardInterrupt):
        tminer.mine_genome([record], profile, thr=30, engine=engine, get_hit_loci=True, checkpoint_path=ckpt)
    data = json.load(open(ckpt))
    assert data["seg_next"] == 4 and data["seg_record"] == 0

    engine = _engine(profile, 4096)
    scanned = _count_segments(engine)
    res = tminer.mine_genome([record], profile, thr=30, engine=engine, get_hit_loci=True, checkpoint_path=ckpt)
    _same(res, baseline)
    n_segs = -(-(len(record) - profile.windowsize + 1) // 8192)
    assert scanned[0] == n_segs - 4
    assert not os.path.exists(ckpt)


def test_segment_resume_discards_stale_parameters(tmp_path, ref_fasta):
    profile = tref.gen_ref_ws_cons(ref_fasta, 6)
    record = _planted_record(ref_fasta, 6, (40_000,))
    eng_a = _engine(profile, 4096)
    baseline = tminer.mine_genome([record], profile, thr=30, engine=eng_a, get_hit_loci=True)
    assert len(baseline.hits) >= 1

    ckpt = str(tmp_path / "stale.ckpt")
    _kill_after(eng_a, 2)
    with pytest.raises(KeyboardInterrupt):
        tminer.mine_genome([record], profile, thr=30, engine=eng_a, checkpoint_path=ckpt)
    assert json.load(open(ckpt))["seg_next"] == 2

    # another chunk: the stored segments are ignored, every segment rescanned
    eng_b = _engine(profile, 8192)
    scanned = _count_segments(eng_b)
    res = tminer.mine_genome([record], profile, thr=30, engine=eng_b, checkpoint_path=ckpt, get_hit_loci=True)
    _same(res, baseline)
    assert scanned[0] == -(-(len(record) - profile.windowsize + 1) // 16384)


def test_segment_boundary_straddling_hit(ref_fasta):
    """A gene straddling the first segment boundary: the segmented stream
    equals the one-pass path's and the JAX engine's, and the plant is
    found near the boundary."""
    from kmergma_tpu.ops.scan import ScanEngine as JaxScanEngine

    from kmergma_tpu_torch.models.state_machine import replay_single

    profile = tref.gen_ref_ws_cons(ref_fasta, 6)
    k, ws = profile.k, profile.windowsize
    eng = _engine(profile, 8192)
    seg = 2 * eng.chunk
    rng = np.random.default_rng(13)
    n = 3 * seg + ws
    codes = rng.integers(0, 4, n, dtype=np.int8)
    gene = as_records(ref_fasta)[0].codes
    for pos in (seg - gene.shape[0] // 2, seg + seg // 2):
        codes[pos : pos + gene.shape[0]] = gene

    scanned = _count_segments(eng)
    one_pass = eng.record_stream(codes, 30.0, codes_dev=eng.prepare_codes(codes))
    assert scanned[0] == 1
    segmented = eng.record_stream(codes, 30.0)
    assert scanned[0] == 1 + 4
    jeng = JaxScanEngine(profile.sum_kfv, k=k, ws=ws, r=profile.n_records, chunk_windows=8192)
    jeng.full_fetch_windows = 0
    want = jeng.record_stream(codes, 30.0)
    assert segmented[:2] == one_pass[:2] == want[:2]
    hits = replay_single(segmented[1], segmented[0], 30.0, k, ws, n, buff=50)
    assert hits and abs(hits[0].cmi - (seg - gene.shape[0] // 2)) < ws


# --- segmented against one pass and the JAX engine -------------------------


@pytest.mark.parametrize("n_segs", [2, 3, 5])
def test_segmented_matches_one_pass_and_jax(n_segs):
    """Random records of 2-5 segments, a random profile and a threshold in
    the distance distribution: the segmented (dist0, stream) equals the
    one-pass path's and the JAX ``ScanEngine``'s (which segments too)."""
    from kmergma_tpu.ops.kmers import kmer_count
    from kmergma_tpu.ops.scan import ScanEngine as JaxScanEngine
    from kmergma_tpu.ops.scan_host import scan_window_distances_np_i64

    rng = np.random.default_rng(40 + n_segs)
    k, ws, r, chunk = 6, int(rng.integers(150, 300)), int(rng.integers(2, 8)), 2048
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
    s = sum(kmer_count(ref, k).astype(np.int64) for ref in refs)
    n = (n_segs - 1) * 2 * chunk + int(rng.integers(ws + 100, 2 * chunk)) + ws - 1
    codes = rng.integers(0, 4, n, dtype=np.int8)
    for pos in range(500, n - ws - 50, 1_700):
        mutant = refs[pos % r].copy()
        idx = rng.integers(0, ws, ws // 6)
        mutant[idx] = rng.integers(0, 4, ws // 6)
        codes[pos : pos + ws] = mutant
    port = ScanEngine(s, k=k, ws=ws, r=r, device="cpu", chunk_windows=chunk)
    d = scan_window_distances_np_i64(codes, s, k, ws, r)
    thr = float(np.percentile(d / port.scale, float(rng.uniform(1.0, 6.0))))
    scanned = _count_segments(port)
    segmented = port.record_stream(codes, thr)
    assert scanned[0] == n_segs
    one_pass = port.record_stream(torch.from_numpy(codes), thr)
    jeng = JaxScanEngine(s, k=k, ws=ws, r=r, chunk_windows=chunk)
    jeng.full_fetch_windows = 0
    want = jeng.record_stream(codes, thr)
    assert segmented[:2] == one_pass[:2] == want[:2]
    assert len(want[1]) > 4


# --- mid-record resume across packages -------------------------------------


@pytest.mark.parametrize("killer", ["jax", "jax_tpu_words", "port"])
def test_mid_record_resume_across_packages(tmp_path, ref_fasta, killer):
    """A run of one package killed after 3 segments resumes in the other
    after segment 3: the uninterrupted hits and loci, only the remaining
    segments scanned, the file removed.  ``jax_tpu_words``: the JAX file
    with the ``fused`` field its TPU kernel writes, on the same grid."""
    from kmergma_tpu.models import miner as jminer
    from kmergma_tpu.ops import reference as jref
    from kmergma_tpu.ops.scan import ScanEngine as JaxScanEngine
    from kmergma_tpu.utils.fasta import FastaRecord as JaxFastaRecord

    jprof, tprof = jref.gen_ref_ws_cons(ref_fasta, 6), tref.gen_ref_ws_cons(ref_fasta, 6)
    record = _planted_record(ref_fasta, 5, (20_000, 55_000, 90_000))
    jrecord = JaxFastaRecord(record.identifier, record.seq)
    n_segs = -(-(len(record) - tprof.windowsize + 1) // 8192)

    def jax_engine():
        return JaxScanEngine(jprof.sum_kfv, k=6, ws=jprof.windowsize, r=jprof.n_records, chunk_windows=4096)

    want = jminer.mine_genome([jrecord], jprof, thr=30, engine=jax_engine(), get_hit_loci=True)
    assert len(want.hits) >= 3
    ckpt = str(tmp_path / "cross.ckpt")
    dying = _engine(tprof, 4096) if killer == "port" else jax_engine()
    _kill_after(dying, 3)
    with pytest.raises(KeyboardInterrupt):
        if killer != "port":
            jminer.mine_genome([jrecord], jprof, thr=30, engine=dying, get_hit_loci=True, checkpoint_path=ckpt)
        else:
            tminer.mine_genome([record], tprof, thr=30, engine=dying, get_hit_loci=True, checkpoint_path=ckpt)
    data = json.load(open(ckpt))
    assert data["seg_record"] == 0 and data["seg_next"] == 3
    assert data["seg_fingerprint"].split("|")[7] == "False"
    if killer == "jax_tpu_words":
        data["seg_fingerprint"] = data["seg_fingerprint"].replace("|False|", "|True|")
        json.dump(data, open(ckpt, "w"))

    if killer != "port":
        engine = _engine(tprof, 4096)
        scanned = _count_segments(engine)
        got = tminer.mine_genome([record], tprof, thr=30, engine=engine, get_hit_loci=True, checkpoint_path=ckpt)
    else:
        engine = jax_engine()
        real, scanned = engine.prepare_codes, [0]

        def counted(*a, **kw):  # the JAX segmented pass copies each segment once
            scanned[0] += 1
            return real(*a, **kw)

        engine.prepare_codes = counted
        got = jminer.mine_genome([jrecord], jprof, thr=30, engine=engine, get_hit_loci=True, checkpoint_path=ckpt)
    _same(got, want)
    assert scanned[0] == n_segs - 3
    assert not os.path.exists(ckpt)


# --- cross-record prefetch --------------------------------------------------


@pytest.mark.parametrize("miner", ["single", "cluster"])
def test_prefetched_record_equals_unprefetched(mini_genome, ref_fasta, miner):
    """A record handed over as ``prepare_codes`` gave it gives the same
    stream(s) as one the engine copies itself."""
    record = as_records(mini_genome)[0]
    if miner == "single":
        p = tref.gen_ref_ws_cons(ref_fasta, 6)
        eng = ScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records, device="cpu")
        got = eng.record_stream(record.codes, 30.0, codes_dev=eng.prepare_codes(record.codes))
        want = eng.record_stream(record.codes, 30.0)
        assert got[:2] == want[:2] and len(want[1]) > 0
    else:
        clusters = tref.eliminate_null_params(tref.cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
        eng = ClusterScanEngine(clusters.profiles, k=6, device="cpu")
        got = eng.record_streams(record.codes, CLUSTER_THRS, codes_dev=eng.prepare_codes(record.codes))
        assert got == eng.record_streams(record.codes, CLUSTER_THRS)


@pytest.mark.parametrize("miner", ["single", "cluster", "single_segmented"])
def test_miner_prefetch_skips_checkpointed_records(tmp_path, test_genome, ref_fasta, miner):
    """In the multi-record loop each record after the first is copied
    once, while the record before it is scanned, and a record the
    checkpoint has done is never copied.  Only the next record to scan is
    copied ahead, and only where the engine takes it whole: with record 1
    segmented (``single_segmented``: Loci's records reordered so that the
    longest comes second, at a chunk that segments it alone), nothing is
    copied ahead while record 0 is scanned, and record 2 is copied while
    record 1 is."""
    records = as_records(test_genome)
    genome, chunk = test_genome, None
    if miner == "single_segmented":
        records = [records[3], records[2], records[1], records[0]]
        genome, chunk = records, 65536
    lengths = [len(r) for r in records]
    prefetched = []
    if miner != "cluster":
        p = tref.gen_ref_ws_cons(ref_fasta, 6)
        eng = ScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records, chunk_windows=chunk, device="cpu")
        full = tminer.mine_genome(genome, p, thr=30, engine=eng, get_hit_loci=True)
        genome_id = f"{genome if chunk is None else 'records'}|k=6|ws={p.windowsize}|thr=30"

        def run(**kw):
            return tminer.mine_genome(genome, p, thr=30, engine=eng, get_hit_loci=True, **kw)
    else:
        clusters = tref.eliminate_null_params(tref.cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
        eng = ClusterScanEngine(clusters.profiles, k=6, device="cpu")
        full = tomn.mine_genome_clusters(test_genome, clusters.profiles, thr_vec=CLUSTER_THRS, buff=100, engine=eng,
                                         get_hit_loci=True)
        genome_id = (f"{test_genome}|cluster|k=6|ws={[q.windowsize for q in clusters.profiles]}"
                     f"|thr={CLUSTER_THRS}")

        def run(**kw):
            return tomn.mine_genome_clusters(test_genome, clusters.profiles, thr_vec=CLUSTER_THRS, buff=100,
                                             engine=eng, get_hit_loci=True, **kw)

    real = eng.prepare_codes

    def spy(codes):
        prefetched.append(lengths.index(len(codes)) if len(codes) in lengths else "segment")
        return real(codes)

    eng.prepare_codes = spy
    if chunk is not None:  # each scan's start too
        real_stream = eng.record_stream

        def stream_spy(codes, *args, **kwargs):
            prefetched.append(f"scan {lengths.index(len(codes))}")
            return real_stream(codes, *args, **kwargs)

        eng.record_stream = stream_spy
    assert [(h.description, h.seq) for h in run().hits] == [(h.description, h.seq) for h in full.hits]
    if chunk is None:
        # record 1 is queued before record 0, which the scan copies itself;
        # then each record's copy is queued before the one before it is
        # scanned
        assert prefetched == [1, 0, 2, 3]
    else:
        n_segs = -(-(lengths[1] - p.windowsize + 1) // (2 * chunk))
        assert n_segs == 2 and eng.takes_whole(lengths[2]) and not eng.takes_whole(lengths[1])
        assert prefetched == ["scan 0", 0, 2, "scan 1", *["segment"] * n_segs, 3, "scan 2", "scan 3"]
    prefetched.clear()
    ckpt = tmp_path / "pf.ckpt"
    c = ScanCheckpoint.load_or_create(str(ckpt), genome_id)
    done = [h for h in full.hits if h.description.startswith(records[0].identifier)]
    c.record_done(0, lengths[0], done, full.hit_loci[: len(done)])
    done2 = [h for h in full.hits if h.description.startswith(records[1].identifier)]
    c.record_done(1, lengths[0] + lengths[1], done2, full.hit_loci[len(done) : len(done) + len(done2)])
    resumed = run(checkpoint_path=str(ckpt))
    _same(resumed, full)
    # records 0 and 1 are done, and never copied
    assert prefetched == ([3, 2] if chunk is None else [3, "scan 2", 2, "scan 3"])


# --- pinned copies to the card ----------------------------------------------


class _DeferredEvent:
    """A copy still in flight: it reads its source only when waited for,
    as a queued copy from a pinned buffer reads it when the card runs it."""

    def __init__(self, run):
        self.run = run

    def synchronize(self):
        if self.run is not None:
            self.run()
            self.run = None


class _DeferredStaging(PinnedStaging):
    """``PinnedStaging``'s bookkeeping on the CPU: unpinned buffers, and
    copies that run only when their event is waited for, or at
    ``finish``.  With ``wait=False`` the staging is handed events that do
    not wait: the fault the events guard against."""

    def __init__(self, wait: bool = True):
        super().__init__(pin=False)
        self.wait = wait
        self.in_flight = []

    def _copy(self, dst, src):
        event = _DeferredEvent(lambda: dst.copy_(src))
        self.in_flight.append(event)
        return event if self.wait else _DeferredEvent(None)

    def finish(self):
        for event in self.in_flight:
            event.synchronize()


#: GPU cycles a held stream sleeps before the copies queued behind it (tens of ms)
HOLD_CYCLES = 100_000_000


def _twelve_records(seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, int(rng.integers(1, 50_000)), dtype=np.int8) for _ in range(12)]


@pytest.mark.parametrize("wait", [True, False])
def test_pinned_staging_bookkeeping(wait):
    """Twelve records of random lengths staged back to back, each copy
    left in flight until its buffer comes round again: every record
    arrives intact.  Without the wait for the event, records are
    overwritten in the buffer under their copies (the twin catches it)."""
    staging = _DeferredStaging(wait)
    records = _twelve_records()
    outs = []
    for rec in records:
        out = torch.empty(rec.shape[0], dtype=torch.int8)

        def fill(view, rec=rec):
            view[:] = rec

        staging.to_device(out, fill, rec.shape, np.int8)
        outs.append(out)
    staging.finish()
    intact = [np.array_equal(o.numpy(), r) for o, r in zip(outs, records)]
    assert all(intact) if wait else not all(intact)


@pytest.mark.cuda
def test_pinned_copies_to_a_card_not_current():
    """Twelve records through ``pad_to_device`` onto the second card while
    the first is current, queued behind a kernel that holds the second
    card's stream: the copies run on that card's stream, and each staging
    buffer waits for them before it is refilled, so every record arrives
    intact."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    records = _twelve_records(seed=4)
    with torch.cuda.device(0):
        with torch.cuda.device(other):
            torch.cuda._sleep(HOLD_CYCLES)
        outs = [tscan.pad_to_device(rec, rec.shape[0] + 4096, np.int8, other) for rec in records]
    torch.cuda.synchronize(other)
    for out, rec in zip(outs, records):
        assert out.device == other
        assert np.array_equal(out[: rec.shape[0]].cpu().numpy(), rec)
        assert not out[rec.shape[0] :].any()


def test_pinned_staging_records_on_the_copy_stream(monkeypatch):
    """The event behind a copy is recorded on the current stream of the
    destination's device, where ``copy_`` queues the copy, and not on the
    current device's: otherwise a buffer staging copies to a card that is
    not current is refilled under a copy still in flight."""
    import contextlib

    seen = []

    class Event:
        def record(self, stream=None):
            seen.append(("record", stream))

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: ("stream of", device))
    monkeypatch.setattr(torch.cuda, "device", lambda d: seen.append(("device", d)) or contextlib.nullcontext())
    dst = torch.empty(7, dtype=torch.int8)
    rec = np.arange(7, dtype=np.int8)

    def fill(view):
        view[:] = rec

    PinnedStaging(pin=False).to_device(dst, fill, rec.shape, np.int8)
    assert seen == [("device", dst.device), ("record", ("stream of", dst.device))]
    assert np.array_equal(dst.numpy(), rec)


@pytest.mark.cuda
def test_pinned_copies_on_card():
    """The same twelve records through ``pad_to_device`` on the card, back
    to back with no synchronisation between them, and region rows cut from
    host codes: each arrives intact, zero-padded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned copies need one)")
    dev = torch.device("cuda")
    records = _twelve_records()
    torch.cuda._sleep(HOLD_CYCLES)  # the copies queue behind it, still in flight as the host goes on
    outs = [tscan.pad_to_device(rec, rec.shape[0] + 4096, np.int8, dev) for rec in records]
    torch.cuda.synchronize()
    for out, rec in zip(outs, records):
        assert np.array_equal(out[: rec.shape[0]].cpu().numpy(), rec)
        assert not out[rec.shape[0] :].any()
    starts = np.array([0, 1000, records[0].shape[0] - 10], dtype=np.int64)
    rows = tscan.host_region_rows(records[0], starts, 300, dev).cpu()
    padded = np.concatenate([records[0], np.zeros(300, dtype=np.int8)])
    assert np.array_equal(rows.numpy(), np.stack([padded[s : s + 300] for s in starts]))
