"""The port's own copies of the JAX package's host modules (FASTA parsing
and its native library, reference profiles and clusters, thresholds, the
exact replays, the aligner, the int64 host engine) against the JAX
originals, with the same inputs through both.  Zero tolerance: the copies
differ from their originals only in imports and in the JAX paths they
drop."""

import os
from pathlib import Path

import numpy as np
import pytest

from kmergma_tpu.models import state_machine as jsm
from kmergma_tpu.ops import align as jalign
from kmergma_tpu.ops import reference as jref
from kmergma_tpu.ops import scan_host as jhost
from kmergma_tpu.ops import thresholds as jthr
from kmergma_tpu.utils import fasta as jfasta
from kmergma_tpu_torch.models import state_machine as tsm
from kmergma_tpu_torch.ops import align as talign
from kmergma_tpu_torch.ops import reference as tref
from kmergma_tpu_torch.ops import scan_host as thost
from kmergma_tpu_torch.ops import thresholds as tthr
from kmergma_tpu_torch.utils import fasta as tfasta
from kmergma_tpu_torch.utils import native as tnative

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

DATA = Path(__file__).parent / "data"
REF = str(DATA / "Alp_V_ref.fasta")
FIXTURES = ["Alp_V_locus.fasta", "Loci.fasta", "8_ident_Alp_V_loci.fasta", "Alp_V_ref.fasta"]


def _records(recs):
    return [(r.description, r.identifier, r.seq, r.codes.tobytes(), r.codes.dtype) for r in recs]


@pytest.mark.parametrize("fixture", FIXTURES)
def test_as_records_native_and_python_match_jax(fixture):
    path = str(DATA / fixture)
    want = _records(jfasta.as_records(path))
    native = tfasta.read_fasta_native(path)
    assert native is not None, "the port's native library did not build"
    assert _records(native) == want
    assert _records(tfasta.read_fasta(path)) == want
    assert _records(tfasta.as_records(path)) == want


def test_native_library_is_the_ports_own():
    """The port builds its own fastaio.cpp into build/kmergma_tpu_torch/,
    keyed by the source's hash, and loads nothing from kmergma_tpu/native."""
    lib = tnative.get_lib()
    assert lib is not None
    path = Path(lib._name).resolve()
    root = Path(__file__).resolve().parent.parent
    assert path.parent == root / "build" / "kmergma_tpu_torch"
    assert path.name.startswith("libfastaio_") and path == tnative._so_path()
    assert "kmergma_tpu/native" not in str(path)


def test_reference_profiles_and_clusters_match_jax():
    for k in (3, 6):
        got, want = tref.gen_ref_ws_cons(REF, k), jref.gen_ref_ws_cons(REF, k)
        assert (got.windowsize, got.n_records, got.consensus, got.k) == (want.windowsize, want.n_records, want.consensus, want.k)
        np.testing.assert_array_equal(got.sum_kfv, want.sum_kfv)
        np.testing.assert_array_equal(got.mean_kfv, want.mean_kfv)
    got = tref.eliminate_null_params(tref.cluster_ref_api(REF, 6, get_dists=True))
    want = jref.eliminate_null_params(jref.cluster_ref_api(REF, 6, get_dists=True))
    assert got.windowsizes == want.windowsizes and got.consensus_seqs == want.consensus_seqs
    assert got.dists == want.dists and got.invalid == want.invalid
    for a, b in zip(got.profiles, want.profiles):
        assert a.n_records == b.n_records
        np.testing.assert_array_equal(a.sum_kfv, b.sum_kfv)
        np.testing.assert_array_equal(a.mean_kfv, b.mean_kfv)


def test_thresholds_match_jax():
    p = jref.gen_ref_ws_cons(REF, 6)
    for buffer in (8.0, 12.0):
        assert tthr.estimate_optimal_threshold(p.mean_kfv, p.windowsize, buffer=buffer) == \
            jthr.estimate_optimal_threshold(p.mean_kfv, p.windowsize, buffer=buffer)
    c = jref.eliminate_null_params(jref.cluster_ref_api(REF, 6))
    assert tthr.estimate_optimal_thresholds(c.kfvs, c.windowsizes, buffer=7.0) == \
        jthr.estimate_optimal_thresholds(c.kfvs, c.windowsizes, buffer=7.0)


def _seeded_stream(rng, n, thr):
    d = rng.uniform(thr - 4, thr + 6, n)
    d[rng.random(n) < 0.5] = thr + 10  # long quiet stretches
    below = d < thr
    mask = below.copy()
    mask[1:] |= below[:-1]
    mask[0] = False
    idx = np.nonzero(mask)[0]
    return float(d[0]), list(zip(idx.tolist(), d[idx].tolist()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replays_match_jax(seed):
    rng = np.random.default_rng(seed)
    thr = 30.0
    dist0, stream = _seeded_stream(rng, 5_000, thr)
    for cmi_offset in (None, 0):
        kw = dict(k=6, ws=289, seq_len=5_300, buff=50, cmi_offset=cmi_offset)
        got = tsm.replay_single(stream, dist0, thr, **kw)
        assert [vars(h) for h in got] == [vars(h) for h in jsm.replay_single(stream, dist0, thr, **kw)]
        assert [vars(h) for h in got] == [vars(h) for h in tsm.replay_single_seq(stream, dist0, thr, **kw)]
        assert got
    pairs = [_seeded_stream(rng, 5_000, t) for t in (30.0, 31.0, 29.0)]
    thrs, wss = [30.0, 31.0, 29.0], [288, 289, 290]
    events = {}
    for name, mod in (("port", tsm), ("jax", jsm)):
        out = []
        mod.replay_omn([p[1] for p in pairs], [p[0] for p in pairs], thrs, 6, wss, 5_300,
                       lambda ev, out=out: out.append(vars(ev).copy()) or len(out) % 3 != 0)
        events[name] = out
    assert events["port"] == events["jax"] and events["port"]


def _seeded_pairs(seed):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    query = letters[rng.integers(0, 4, 120)].tobytes().decode()
    subjects = []
    for i in range(12):
        s = np.frombuffer(query.encode(), np.uint8).copy()
        idx = rng.integers(0, s.shape[0], 15)
        s[idx] = letters[rng.integers(0, 4, 15)]
        flank = letters[rng.integers(0, 4, 30 + i)]
        subjects.append((flank.tobytes() + s.tobytes()[: 100 + i] + flank[:20].tobytes()).decode())
    return query, subjects


@pytest.mark.parametrize("native", ["1", "0"])
def test_alignment_matches_jax(native, monkeypatch):
    """semiglobal_align_batch and align_hits_batch on seeded pairs, through
    the native DP and through the NumPy batch (KMERGMA_ALIGN_NATIVE=0)."""
    monkeypatch.setenv("KMERGMA_ALIGN_NATIVE", native)
    for seed, (go, ge) in ((3, (-69, -1)), (4, (-69, -5)), (5, (-200, -1))):
        query, subjects = _seeded_pairs(seed)
        want = [(a.score, a.cigar) for a in jalign.semiglobal_align_batch(query, subjects, go, ge)]
        assert [(a.score, a.cigar) for a in talign.semiglobal_align_batch(query, subjects, go, ge)] == want
        assert [(a.score, a.cigar) for a in talign.align_hits_batch(query, subjects, go, ge)] == want
        single = talign.semiglobal_align(query, subjects[0], go, ge)
        assert (single.score, single.cigar) == want[0]
        assert [talign.cigar_to_unitrange(a) for a in talign.align_hits_batch(query, subjects, go, ge)] == \
            [jalign.cigar_to_unitrange(a) for a in jalign.semiglobal_align_batch(query, subjects, go, ge)]
    assert os.environ["KMERGMA_ALIGN_NATIVE"] == native


@pytest.mark.parametrize("fixture", ["Alp_V_locus.fasta", "8_ident_Alp_V_loci.fasta"])
def test_host_scan_engine_streams_match_jax(fixture):
    p = jref.gen_ref_ws_cons(REF, 6)
    got_eng = thost.HostScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records)
    want_eng = jhost.HostScanEngine(p.sum_kfv, k=6, ws=p.windowsize, r=p.n_records)
    n = 0
    for rec in jfasta.as_records(str(DATA / fixture)):
        if len(rec) < p.windowsize:
            continue
        got = got_eng.record_stream(rec.codes, 36.0, collect_dists=True)
        want = want_eng.record_stream(rec.codes, 36.0, collect_dists=True)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(
            thost.scan_window_distances_np_i64(rec.codes, p.sum_kfv, 6, p.windowsize, p.n_records),
            jhost.scan_window_distances_np_i64(rec.codes, p.sum_kfv, 6, p.windowsize, p.n_records),
        )
        n += len(got[1])
    assert n > 0
