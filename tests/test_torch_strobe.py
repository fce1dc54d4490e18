"""The strobemer path of the port (kmergma_tpu_torch.ops.strobemers,
.ops.scan_strobe, .models.strobe_miner, strobemer_find_genes) and its pair
kernel (K4/K4r, K6: ops.scan_kernels.codes_pair_ab_kcodes and
pair_ab_from_kcodes) against the JAX package on the CPU, with the same
seeded inputs through both.  Zero tolerance: the scan is integer
arithmetic and the streams are integer distances divided by the same
float64 scale.

On CPU tensors K4 and K6 run their plain twins; the JAX side runs its XLA
formulations (``_pair_ab_xla``, the span engine with ``use_pallas`` off),
no interpret-mode Pallas."""

import importlib.util
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmergma_tpu as km
import kmergma_tpu_torch as kt
from kmergma_tpu.models import strobe_miner as jstrobe
from kmergma_tpu.utils.fasta import FastaRecord as JaxFastaRecord
from kmergma_tpu.ops import scan as jscan
from kmergma_tpu.ops.scan_strobe import strobe_scan_from_codes as jax_strobe_scan
from kmergma_tpu.ops.strobemers import strobe_2_mer_codes_jnp
from kmergma_tpu_torch.models import strobe_miner as tstrobe
from kmergma_tpu_torch.ops.scan_kernels import codes_pair_ab_kcodes, pair_ab_from_kcodes, scan_window_lower_bounds_codes
from kmergma_tpu_torch.ops.scan_strobe import strobe_scan_distances_np, strobe_scan_from_codes
from kmergma_tpu_torch.ops.strobemers import strobe_2_mer_codes, strobe_2_mer_codes_torch
from kmergma_tpu_torch.utils.fasta import FastaRecord, as_records

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

DATA = Path(__file__).parent / "data"
REF = str(DATA / "Alp_V_ref.fasta")


def _planted(seed, n):
    """Random background with Alp_V reference genes planted every 6 kb."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    genes = [rec.codes for rec in as_records(REF)]
    for i, pos in enumerate(range(1_000, n - 400, 6_000)):
        codes[pos : pos + genes[(5 * i + seed) % len(genes)].shape[0]] = genes[(5 * i + seed) % len(genes)]
    return codes


@pytest.fixture(scope="module")
def profile():
    return tstrobe.gen_strobe_ref_ws_cons(REF)


# --- extraction and the plain scan contract ---------------------------------


@pytest.mark.parametrize("s,w_min,w_max,q", [(2, 3, 5, 5), (2, 2, 6, 7), (3, 4, 8, 11)])
def test_strobe_codes_torch_match_jnp_and_numpy(s, w_min, w_max, q):
    codes = np.random.default_rng(s * 100 + q).integers(0, 4, 5_000, dtype=np.int8)
    want = np.asarray(strobe_2_mer_codes_jnp(jnp.asarray(codes), s, w_min, w_max, q))
    got = strobe_2_mer_codes_torch(torch.from_numpy(codes), s, w_min, w_max, q)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(strobe_2_mer_codes(codes, s, w_min, w_max, q), want)
    assert int(got.max()) >= 4 ** (2 * s) // 2  # the upper half of the alphabet is used


@pytest.mark.parametrize("n_steps", [0, 1, 2_500])
def test_strobe_scan_from_codes_matches_jax_and_sequential_oracle(n_steps):
    rng = np.random.default_rng(21 + n_steps)
    s, w_min, w_max, q, ws, r = 2, 3, 5, 5, 97, 11
    k = w_max + s - 1
    codes = rng.integers(0, 4, max(n_steps + ws + 1, ws), dtype=np.int8)
    sprof = rng.integers(0, 9, 4 ** (2 * s)).astype(np.int32)
    sc = strobe_2_mer_codes(codes, s, w_min, w_max, q)
    want = np.asarray(jax_strobe_scan(jnp.asarray(sc.astype(np.int32)), jnp.asarray(sprof), ws - k, r, n_steps))
    got = strobe_scan_from_codes(torch.from_numpy(sc.astype(np.int32)), torch.from_numpy(sprof), ws - k, r, n_steps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if n_steps:
        np.testing.assert_array_equal(want, strobe_scan_distances_np(codes, sprof, s, w_min, w_max, q, ws, r))


# --- K4 / K4r / K6 twins against the JAX package ----------------------------


@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("depth", [1, 14, 16, "w-1"])
def test_pair_depth_twins_match_jax_pair_ab(k, depth):
    """codes_pair_ab_kcodes (K4, K4r at depth w - 1) and pair_ab_from_kcodes
    (K6) equal _pair_ab_xla on rolling_kmer_codes_jnp; at k = 1 the codes
    span 0..255 (uint8, the strobe engine's) and the K codes are the codes."""
    rng = np.random.default_rng(7 * k)
    n, w = 6_000, 40 if k == 1 else 284
    depth = w - 1 if depth == "w-1" else depth
    if k == 1:
        codes = rng.integers(0, 256, n).astype(np.uint8)
    else:
        codes = rng.integers(0, 4, n, dtype=np.int8)
    codes[3_000:3_500] = codes[1_000:1_500]  # repeats, so pairs match
    codes[4_000:4_100] = 0  # a homopolymer, so pairs match at every distance
    nt = n - w - k - 50
    nkc = n - k + 1 - 20
    ab, kc = codes_pair_ab_kcodes(torch.from_numpy(codes), k, w, nt, nkc, depth)
    K = jscan.rolling_kmer_codes_jnp(jnp.asarray(codes.astype(np.int32)), k)
    want = np.asarray(jscan._pair_ab_xla(K, w, nt, depth))
    assert ab.dtype == kc.dtype == torch.int32 and ab.shape == (nt,) and kc.shape == (nkc,)
    np.testing.assert_array_equal(ab.numpy(), want)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(K)[:nkc])
    np.testing.assert_array_equal(pair_ab_from_kcodes(torch.tensor(np.asarray(K)), w, nt, depth).numpy(), want)
    assert int(ab.abs().sum()) > 0


@pytest.mark.parametrize("depth", [1, 16, None])
def test_lower_bounds_codes_match_jax(depth):
    """scan_window_lower_bounds_codes equals the JAX scan_window_lower_bounds
    (depth None: ws - k, the exact distances), on padded codes too."""
    rng = np.random.default_rng(3)
    k, ws, r = 5, 101, 9
    s = rng.integers(0, 12, 4**k).astype(np.int32)
    codes = rng.integers(0, 4, 4_000, dtype=np.int8)
    depth = ws - k if depth is None else depth
    want = np.asarray(jscan.scan_window_lower_bounds(jnp.asarray(codes), jnp.asarray(s), k, ws, r, depth))
    got = scan_window_lower_bounds_codes(torch.from_numpy(codes), torch.from_numpy(s), k, ws, r, depth)
    np.testing.assert_array_equal(got.numpy(), want)
    padded = torch.from_numpy(np.concatenate([codes, np.full(900, 3, np.int8)]))
    got = scan_window_lower_bounds_codes(padded, torch.from_numpy(s), k, ws, r, depth, nw=codes.shape[0] - ws + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    if depth == ws - k:
        np.testing.assert_array_equal(want, jscan.scan_window_distances_np(codes, s, k, ws, r))


# --- the span engine and the miner against the JAX package -------------------


def _jax_span_engine(profile, xstar):
    eng = jstrobe.StrobeSpanEngine(profile, xstar)
    eng.full_fetch_windows = 0
    return eng


@pytest.mark.parametrize("seed,thr", [(1, 30.0), (2, 33.5)])
def test_span_engine_streams_match_jax(profile, seed, thr):
    """StrobeSpanEngine's (dist0, stream) equal the JAX span engine's on a
    planted record; its strobe codes include many >= 128, which cross as
    uint8 (an int8 cast would turn them negative)."""
    codes = _planted(seed, 30_000)
    sc = strobe_2_mer_codes(codes, profile.s, profile.w_min, profile.w_max, profile.q)
    w = profile.windowsize - profile.k
    sc = sc[: codes.shape[0] - profile.windowsize - 1 + w]
    assert (sc >= 128).sum() > 1_000
    port = tstrobe.StrobeSpanEngine(profile, int(sc[w]), device="cpu")
    assert port.bound_depth is None and port.k == 1 and port.ws == w
    assert port.prepare_codes(sc).dtype == torch.uint8
    got = port.record_stream(sc, thr)
    want = _jax_span_engine(profile, int(sc[w])).record_stream(sc, thr)
    assert got[0] == want[0]
    assert got[1] == want[1] and len(got[1]) > 4
    # the device tensor input (the miner's device extraction) gives the same
    assert port.record_stream(torch.from_numpy(sc.astype(np.int32)), thr)[:2] == got[:2]


def test_span_engine_s3_int32_codes_match_jax():
    """s = 3: 4096 strobe codes cross as int32."""
    p = tstrobe.gen_strobe_ref_ws_cons(REF, s=3, w_min=3, w_max=6, q=7)
    jp = jstrobe.gen_strobe_ref_ws_cons(REF, s=3, w_min=3, w_max=6, q=7)
    codes = _planted(4, 20_000)
    sc = strobe_2_mer_codes(codes, p.s, p.w_min, p.w_max, p.q)
    w = p.windowsize - p.k
    sc = sc[: codes.shape[0] - p.windowsize - 1 + w]
    assert int(sc.max()) >= 256
    port = tstrobe.StrobeSpanEngine(p, int(sc[w]), device="cpu")
    assert port.prepare_codes(sc).dtype == torch.int32
    d = np.asarray(jax_strobe_scan(jnp.asarray(sc.astype(np.int32)), jnp.asarray(p.sum_kfv.astype(np.int32)), w, p.n_records, sc.shape[0] - w))
    thr = float(np.percentile(d / port.scale, 2.0))
    got = port.record_stream(sc, thr)
    assert got[:2] == _jax_span_engine(jp, int(sc[w])).record_stream(sc, thr)[:2]
    assert len(got[1]) > 4


def _strobe_outputs(out):
    hits, loci, alns, dists = out
    return [(h.description, h.seq) for h in hits], loci, [(a.score, a.cigar) for a in alns], dists


@pytest.mark.parametrize("fixture", ["Alp_V_locus.fasta", "Loci.fasta"])
def test_strobemer_find_genes_matches_jax(fixture):
    """Hit descriptions and sequences, loci, alignments and distances equal
    the JAX package's, byte for byte, on the fixture genomes."""
    genome = str(DATA / fixture)
    kw = dict(verbose=False, do_return_hit_loci=True, do_return_align=True, do_return_dists=True)
    got = _strobe_outputs(kt.strobemer_find_genes(genome, REF, device="cpu", **kw))
    want = _strobe_outputs(km.strobemer_find_genes(genome, REF, **kw))
    assert got[:3] == want[:3] and len(got[0]) > 0
    assert got[3].dtype == want[3].dtype and got[3].shape == want[3].shape
    np.testing.assert_array_equal(got[3], want[3])


def test_strobe_miner_edge_records_match_jax(profile):
    """A record shorter than ws (skipped without advancing GenomePos), one
    of ws and ws + 1 bp (the n_steps < 1 branch), a planted one; host and
    device extraction; the score filter."""
    ws = profile.windowsize
    planted = _planted(9, 8_000)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    gene = as_records(REF)[3].codes
    records = [
        FastaRecord("short", letters[planted[: ws - 1]].tobytes()),
        FastaRecord("exact", letters[gene[:ws]].tobytes()),
        FastaRecord("plus_one", letters[planted[1_000 : 1_001 + ws]].tobytes()),
        FastaRecord("planted", letters[planted].tobytes()),
    ]
    kw = dict(thr=30.0, get_hit_loci=True, do_return_dists=True, do_return_align=True)
    jax_records = [JaxFastaRecord(rec.description, rec.seq) for rec in records]
    want = jstrobe.strobe_mine_genome(jax_records, profile, **kw)
    for extract in (True, False):
        got = tstrobe.strobe_mine_genome(records, profile, device="cpu", device_extract=extract, **kw)
        assert [(h.description, h.seq) for h in got.hits] == [(h.description, h.seq) for h in want.hits]
        assert got.hit_loci == want.hit_loci and len(got.hits) > 1
        np.testing.assert_array_equal(got.dists, want.dists)
    for min_score in (1_300, 10**9):  # some hits filtered out, then all
        got = tstrobe.strobe_mine_genome(records, profile, thr=30.0, score_threshold=min_score, device="cpu")
        want = jstrobe.strobe_mine_genome(jax_records, profile, thr=30.0, score_threshold=min_score)
        assert [h.description for h in got.hits] == [h.description for h in want.hits]
    assert got.hits == []


def test_strobe_unported_options_raise(profile, mini_genome):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        kt.strobemer_find_genes(mini_genome, REF, verbose=False, device="cpu", checkpoint_path="x.ckpt")


def test_strobe_genome_dev_and_engine_cache_match_jax(profile):
    """Records already on the device (``genome_dev=``, as the bench hands
    them over, here longer than the records) and the caller's engine cache
    (``engine_cache=``, reused by a second call): the JAX package's hits
    for the same inputs, and no new engine on the second call."""
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    codes = [_planted(11, 30_000), _planted(12, 20_000)]
    records = [FastaRecord(f"r{i}", letters[c].tobytes()) for i, c in enumerate(codes)]
    jax_records = [JaxFastaRecord(rec.description, rec.seq) for rec in records]
    pad = np.zeros(1 << 12, dtype=np.int8)
    want = jstrobe.strobe_mine_genome(
        jax_records, profile, thr=30.0, get_hit_loci=True,
        genome_dev=[jnp.asarray(np.concatenate([c, np.zeros(1 << 16, dtype=np.int8)])) for c in codes],
        engine_cache={},
    )
    cache: dict = {}
    genome_dev = [torch.from_numpy(np.concatenate([c, pad])) for c in codes]
    engines = None
    for _call in range(2):
        got = tstrobe.strobe_mine_genome(
            records, profile, thr=30.0, get_hit_loci=True, genome_dev=genome_dev, engine_cache=cache, device="cpu",
        )
        assert [(h.description, h.seq) for h in got.hits] == [(h.description, h.seq) for h in want.hits]
        assert got.hit_loci == want.hit_loci and len(got.hits) > 2
        engines = engines or dict(cache)
    assert cache == engines and len(cache) >= 1


def test_strobe_profile_matches_jax(profile):
    want = jstrobe.gen_strobe_ref_ws_cons(REF)
    for field in ("n_records", "windowsize", "consensus", "s", "w_min", "w_max", "q", "k"):
        assert getattr(profile, field) == getattr(want, field)
    np.testing.assert_array_equal(profile.sum_kfv, want.sum_kfv)
    np.testing.assert_array_equal(profile.mean_kfv, want.mean_kfv)


def test_chip_smoke_strobe_oracle_matches_sequential_recurrence(profile):
    """chip_smoke.py's int64 host strobe oracle (sorted-key window counts)
    equals the reference recurrence run verbatim."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    codes = _planted(5, 12_000)
    sc = strobe_2_mer_codes(codes, profile.s, profile.w_min, profile.w_max, profile.q)
    w = profile.windowsize - profile.k
    n_steps = codes.shape[0] - profile.windowsize - 1
    got = cs.strobe_distances_i64(sc[: n_steps + w], profile.sum_kfv, w, profile.n_records)
    want = strobe_scan_distances_np(codes, profile.sum_kfv, profile.s, profile.w_min, profile.w_max,
                                    profile.q, profile.windowsize, profile.n_records)
    np.testing.assert_array_equal(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = tstrobe.strobe_mine_genome([FastaRecord("r", np.frombuffer(b"ACGT", np.uint8)[codes].tobytes())], profile,
                                         thr=30.0, device="cpu", device_extract=False, engine_factory=cs.HostStrobeOracle)
    port = tstrobe.strobe_mine_genome([FastaRecord("r", np.frombuffer(b"ACGT", np.uint8)[codes].tobytes())], profile,
                                      thr=30.0, device="cpu")
    assert [h.description for h in res.hits] == [h.description for h in port.hits] and len(port.hits) > 0
