"""The port's device aligner (``kmergma_tpu_torch.ops.align_device``) and
the alignment router against the JAX package (zero tolerance: integer
arithmetic).

On the CPU ``semiglobal_align_device(device="cpu")`` runs the plain twins
of A1 (``_forward_tl_plain``, ``_traceback_rle_plain``, and
``_align_cigar_plain``, which expands their runs into CIGAR runs); they are
held against the JAX ``semiglobal_align_device`` and ``semiglobal_align``
on the inputs of tests/test_alignment.py, and their TL and run outputs
against the JAX ``_forward_tl`` and ``_get_jit().run``.  A NumPy model of
A1's own arithmetic (``csrc/align_dp.cu``: bands of R rows a lane, one
column a step one step behind the lane above, strips with their buffers,
the 4-bit decisions packed 8 columns a word in shared or device memory,
the 3-state walk that writes the JAX runs and the CIGAR runs) is held
against the twins, on shapes shrunk so that short queries cross many
strips and at the kernel's own width.  The ``cuda`` tests run A1 on the
card; the file reaches the JAX package only through a fixture, so on a GPU
host without jax they run as
    python -m pytest --noconftest -m cuda tests/test_torch_align_device.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from kmergma_tpu_torch.models.miner import mine_genome
from kmergma_tpu_torch.ops import align as talign
from kmergma_tpu_torch.ops import align_device as tad
from kmergma_tpu_torch.ops.align import _NUC44, _seq_to_idx
from kmergma_tpu_torch.ops.reference import gen_ref_ws_cons

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

DATA = Path(__file__).resolve().parent / "data"
GAP_MODELS = [(-69, -1), (-5, -2), (-200, -1)]


@pytest.fixture(scope="module")
def jax_align():
    """The JAX package's aligners: (align_device, align) modules."""
    jad = pytest.importorskip("kmergma_tpu.ops.align_device")
    jal = pytest.importorskip("kmergma_tpu.ops.align")
    return jad, jal


def _fuzz_inputs():
    """tests/test_alignment.py's device fuzz: IUPAC N, mixed lengths."""
    rng = np.random.default_rng(11)
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 70))
    subjects = []
    for _ in range(19):
        n = int(rng.integers(50, 140))
        subjects.append("".join("ATGCN"[i] for i in rng.integers(0, 5, n)))
    return query, subjects


def _indel_mutants():
    """tests/test_alignment.py's indel mutants: substitutions, deletions,
    insertions and free flanks, multi-run CIGARs."""
    rng = np.random.default_rng(12)
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 120))
    subjects = []
    for _ in range(16):
        s = list(query)
        for _ in range(int(rng.integers(0, 12))):
            s[int(rng.integers(0, len(s)))] = "ATGC"[int(rng.integers(0, 4))]
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, len(s) - 5))
            del s[p : p + int(rng.integers(1, 5))]
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, len(s)))
            s[p:p] = ["ATGC"[int(rng.integers(0, 4))] for _ in range(int(rng.integers(1, 5)))]
        pad_l = "".join("ATGC"[i] for i in rng.integers(0, 4, int(rng.integers(0, 30))))
        pad_r = "".join("ATGC"[i] for i in rng.integers(0, 4, int(rng.integers(0, 30))))
        subjects.append(pad_l + "".join(s) + pad_r)
    return query, subjects


def _pairs(results) -> list:
    return [(r.score, r.cigar) for r in results]


@pytest.mark.parametrize("go,ge", GAP_MODELS)
def test_device_align_matches_jax_fuzz(jax_align, go, ge):
    jad, jal = jax_align
    query, subjects = _fuzz_inputs()
    got = _pairs(tad.semiglobal_align_device(query, subjects, go, ge, device="cpu"))
    assert got == _pairs(jad.semiglobal_align_device(query, subjects, go, ge))
    assert got == _pairs(jal.semiglobal_align(query, s, go, ge) for s in subjects)


def test_device_align_indel_mutants(jax_align):
    jad, jal = jax_align
    query, subjects = _indel_mutants()
    got = tad.semiglobal_align_device(query, subjects, -69, -1, device="cpu")
    assert _pairs(got) == _pairs(jad.semiglobal_align_device(query, subjects, -69, -1))
    assert _pairs(got) == _pairs(jal.semiglobal_align(query, s, -69, -1) for s in subjects)
    assert max(len(r.cigar_runs) for r in got) >= 5  # gaps inside, not only flanks


@pytest.mark.parametrize("go,ge", [(-69, -1), (-5, -1)])
def test_device_align_run_overflow(jax_align, monkeypatch, go, ge):
    """Hits with more runs than RLE_CAP run A1 again together on the same
    device, with the cap at the next power of two at or above their most
    runs, counted on the function, and give the exact AlignResults: the
    cap shrunk to 2 on tests/test_alignment.py's inputs, whose JAX runs at
    -69/-1 number 2 (none past the cap) and at -5/-1 more than 2 (all
    are); their CIGAR runs, = and X apart, number more than 2 in both, so
    the device aligner reruns every hit."""
    _jad, jal = jax_align
    monkeypatch.setattr(tad, "RLE_CAP", 2)
    rng = np.random.default_rng(13)
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 60))
    subjects = ["".join("ATGCN"[i] for i in rng.integers(0, 5, 90)) for _ in range(5)]
    _, rle, n_runs, _ = tad.align_dp(*_dp_inputs(query, subjects), go, ge)
    over = int((n_runs > 2).sum())
    assert rle.shape == (5, 2) and over == (0 if go == -69 else 5)
    a_sub, b_flat, lengths = _dp_inputs(query, subjects)
    _, cig, n_cig, _ = tad.align_cigar(a_sub, _query_idx(query), b_flat, lengths, go, ge)
    over_c = int((n_cig > 2).sum())
    assert cig.shape == (5, 2) and over_c == 5
    calls = []
    real = tad.align_cigar
    monkeypatch.setattr(tad, "align_cigar", lambda *a: calls.append((len(a[3]), a[2].device.type, a[6])) or real(*a))
    tad.semiglobal_align_device.overflowed = 0
    got = tad.semiglobal_align_device(query, subjects, go, ge, device="cpu")
    assert _pairs(got) == _pairs(jal.semiglobal_align(query, s, go, ge) for s in subjects)
    rerun = [(over_c, "cpu", 1 << (int(n_cig.max()) - 1).bit_length())]
    assert calls == [(5, "cpu", None)] + rerun and tad.semiglobal_align_device.overflowed == over_c


def _dp_inputs(query, subjects):
    a = _seq_to_idx(query)
    bs = [_seq_to_idx(s) for s in subjects]
    return (torch.from_numpy(_NUC44[a].astype(np.int32).reshape(-1, 15)),
            torch.from_numpy(np.concatenate([np.zeros(0, np.int64), *bs]).astype(np.int8)), [b.shape[0] for b in bs])


def _query_idx(query):
    return torch.from_numpy(_seq_to_idx(query).astype(np.int8))


@pytest.mark.parametrize("go,ge", GAP_MODELS)
def test_twin_tl_and_runs_match_jax(jax_align, go, ge):
    """The twin's TL and H_last equal the JAX _forward_tl's, and its
    scores, runs and endpoints the JAX _get_jit().run's, on one length."""
    import jax.numpy as jnp

    jad, _jal = jax_align
    query, subjects = _indel_mutants()
    n = min(len(s) for s in subjects)
    subjects = [s[:n] for s in subjects]
    a_sub, b_flat, lengths = _dp_inputs(query, subjects)
    bmat = b_flat.view(len(subjects), n).to(torch.int32)
    H_j, TL_j = jad._forward_tl(jnp.asarray(a_sub.numpy()), jnp.asarray(bmat.numpy()), jnp.int32(go), jnp.int32(ge))
    H_t, TL_t = tad._forward_tl_plain(a_sub, bmat, go, ge)
    np.testing.assert_array_equal(TL_t.numpy(), np.asarray(TL_j))
    np.testing.assert_array_equal(H_t.numpy(), np.asarray(H_j))
    want = jad._get_jit()(jnp.asarray(a_sub.numpy()), jnp.asarray(bmat.numpy()), m=a_sub.shape[0], n=n, go=go, ge=ge)
    for got, ref in zip(tad.align_dp(a_sub, b_flat, lengths, go, ge), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("inputs", ["fuzz", "indel"])
@pytest.mark.parametrize("go,ge", GAP_MODELS)
def test_cigar_twin_matches_decode_rle(jax_align, inputs, go, ge):
    """The CIGAR twin's runs, reversed, are the JAX package's
    ``_decode_rle`` expansion of the JAX runs and the JAX
    ``semiglobal_align_device``'s AlignResults, with the same scores and
    endpoints as ``align_dp``."""
    jad, _jal = jax_align
    query, subjects = _fuzz_inputs() if inputs == "fuzz" else _indel_mutants()
    a_sub, b_flat, lengths = _dp_inputs(query, subjects)
    scores, cig, n_cig, j0 = (x.numpy() for x in tad.align_cigar(a_sub, _query_idx(query), b_flat, lengths, go, ge))
    d_scores, rle, n_runs, d_j0 = (x.numpy() for x in tad.align_dp(a_sub, b_flat, lengths, go, ge))
    np.testing.assert_array_equal(scores, d_scores)
    np.testing.assert_array_equal(j0, d_j0)
    want = jad.semiglobal_align_device(query, subjects, go, ge)
    a = _seq_to_idx(query).astype(np.int32)
    for k, s in enumerate(subjects):
        runs = [(int(v) >> 2, "=XID"[int(v) & 3]) for v in cig[k, : n_cig[k]][::-1]]
        assert runs == jad._decode_rle(rle[k, : n_runs[k]], a.shape[0], len(s), a, _seq_to_idx(s).astype(np.int32))
        assert (int(scores[k]), runs) == (want[k].score, want[k].cigar_runs)
    assert not cig[n_cig[:, None] <= np.arange(cig.shape[1])[None, :]].any()  # slots past the count are 0


def test_cigar_twin_empty_query_and_subject(jax_align):
    """m = 0 and n = 0: the query against subjects with one empty, an empty
    query against subjects, and both empty, as the host aligners give them
    (an empty alignment has no run)."""
    _jad, jal = jax_align
    for query, subjects in (("ACGTACGT", ["", "ACG", ""]), ("", ["ACG", ""]), ("", [""])):
        got = tad.semiglobal_align_device(query, subjects, device="cpu")
        assert _pairs(got) == _pairs(jal.semiglobal_align(query, s) for s in subjects)
        a_sub, b_flat, lengths = _dp_inputs(query, subjects)
        _, cig, n_cig, j0 = tad.align_cigar(a_sub, _query_idx(query), b_flat, lengths, -69, -1)
        _, rle, n_runs, d_j0 = tad.align_dp(a_sub, b_flat, lengths, -69, -1)
        assert torch.equal(j0, d_j0) and all(int(n) == len(r.cigar_runs) for n, r in zip(n_cig, got))
    # both empty: no run, endpoint 0; the JAX runs keep their trailing-gap slot (3) uncounted
    assert (int(n_cig[0]), int(n_runs[0]), int(rle[0, 0]), int(j0[0])) == (0, 0, 3, 0)


# --- a NumPy model of A1's arithmetic (csrc/align_dp.cu) -------------------------

_NEG = -(1 << 30)


def _a1_model(a_sub, a_idx, b, go, ge, cap, lanes=32, r_max=16, smem=True):
    """One subject through A1's arithmetic: ``lanes`` lanes of R rows
    (``_rows_per_lane``), the query in strips of lanes x R rows with their
    buffers (separate, or after the decisions in one flat array as the
    device-memory layout has them), lane L on column t - L at step t with
    the row above from lane L - 1, E down the band and F along each row,
    the 4-bit decisions shifted into a word a row and stored every step at
    word x pitch + row, the endpoint, and the warp's walk: ``lanes`` cells
    of a run read at once, run lengths and = / X from their bit masks.
    Returns (rle row, cigar row), each [score, count, j0, runs x cap]."""
    m, n = a_sub.shape[0], b.shape[0]
    R = tad._rows_per_lane(m, lanes, r_max)
    strip_rows = lanes * R
    strips = -(-m // strip_rows)
    W = (n + 8) // 8
    pitch = (-(-m // R) * R) | 1
    goe = go + ge
    if smem:
        D = np.zeros(W * pitch, np.int64)
        bnd = np.zeros(4 * (n + 1), np.int64)
    else:  # one flat array: the decisions, then the strip buffers
        flat = np.zeros(W * pitch + (4 * (n + 1) if strips > 1 else 0), np.int64)
        D, bnd = flat, flat[W * pitch :]
    lane = np.arange(lanes)
    best, best_j = np.full(lanes, -(2**31), np.int64), np.full(lanes, -1, np.int64)
    for strip in range(strips):
        r0 = strip * strip_rows
        rows = min(strip_rows, m - r0)
        nl = -(-rows // R)
        last = strip == strips - 1
        prof = np.zeros((15, nl * R), np.int64)
        prof[:, :rows] = a_sub[r0 : r0 + rows].T
        live = lane < nl
        base = r0 + lane * R
        rm = m - 1 - base if last else np.full(lanes, -1)
        rd = bnd[((strip + 1) & 1) * 2 * (n + 1) :]
        wr = (strip & 1) * 2 * (n + 1)
        Hp, Fn = np.zeros((R, lanes), np.int64), np.full((R, lanes), _NEG, np.int64)
        acc = np.zeros((R, lanes), np.uint64)
        extf = np.zeros((R, lanes), bool)
        hd, hout, eout, hm = np.zeros(lanes, np.int64), np.zeros(lanes, np.int64), np.full(lanes, _NEG), np.zeros(lanes, np.int64)
        for t in range(n + nl):
            j = t - lane
            hin, ein = np.concatenate([[0], hout[:-1]]), np.concatenate([[_NEG], eout[:-1]])
            if 0 <= t <= n and strip > 0:
                hin[0], ein[0] = rd[t], rd[n + 1 + t]
            act = live & (j >= 0) & (j <= n)
            jc = np.clip(j, 0, n)
            nib = np.zeros((R, lanes), np.uint64)
            if np.any(act & (j == 0)):
                z = act & (j == 0)
                for r in range(R):
                    col = go + ge * (base + 1 + r)
                    Hp[r] = np.where(z, col, Hp[r])
                    Fn[r] = np.where(z, col + goe, Fn[r])
                    nib[r] = np.where(z & (base + 1 + r > 1), 4, nib[r])
                    hm = np.where(z & (rm == r), col, hm)
                extf = np.where(z, False, extf)
                hd = np.where(z, hin, hd)
                hout = np.where(z, go + ge * (base + R), hout)
                eout = np.where(z, go + ge * (base + R), eout)
            g1 = act & (j >= 1)
            if np.any(g1):
                c = np.where(g1, b[np.clip(jc - 1, 0, max(n - 1, 0))] if n else 0, 0)
                hu, eu, hdiag = hin.copy(), ein.copy(), hd.copy()
                hd = np.where(g1, hin, hd)
                for r in range(R):
                    sub = prof[c, np.clip(lane * R + r, 0, nl * R - 1)]
                    e_ext = eu + ge
                    e = np.maximum(hu + goe, e_ext)
                    dg = hdiag + sub
                    f = Fn[r]
                    h = np.maximum(np.maximum(dg, e), f)
                    f_ext = f + ge
                    f_next = np.maximum(np.maximum(dg, e) + goe, f_ext)
                    nib[r] = np.where(g1, (h == dg) * 1 + (h == f) * 2 + (e == e_ext) * 4 + extf[r] * 8, nib[r])
                    Fn[r] = np.where(g1, f_next, Fn[r])
                    extf[r] = np.where(g1, f_next == f_ext, extf[r])
                    hdiag = Hp[r].copy()
                    Hp[r] = np.where(g1, h, Hp[r])
                    hu, eu = h, e
                    hm = np.where(g1 & (rm == r), h, hm)
                hout, eout = np.where(g1, hu, hout), np.where(g1, eu, eout)
            shift = (4 * (7 - (jc & 7))).astype(np.uint64)
            for r in range(R):
                acc[r] = np.where(act, (acc[r] >> np.uint64(4)) | (nib[r] << np.uint64(28)), acc[r])
                for ln in np.flatnonzero(act):
                    D[(jc[ln] >> 3) * pitch + base[ln] + r] = int(acc[r][ln] >> shift[ln]) & 0xFFFFFFFF
            if not last and act[lanes - 1]:
                bnd[wr + jc[-1]], bnd[wr + n + 1 + jc[-1]] = hout[-1], eout[-1]
            upd = act & (rm >= 0) & (rm < R) & (hm >= best)
            best, best_j = np.where(upd, hm, best), np.where(upd, j, best_j)
    if m == 0:
        score, j0 = 0, n
    else:
        owner = ((m - 1) % strip_rows) // R
        score, j0 = int(best[owner]), int(best_j[owner])

    def bits(i, j):
        return (int(D[(j >> 3) * pitch + i - 1]) >> (4 * (j & 7))) & 15

    def ballot(ok):  # the lanes' bits of ``lanes`` cells, lane l at bit l
        return sum(1 << k for k in range(lanes) if ok(k))

    full = (1 << lanes) - 1
    rle, cig = np.zeros(3 + cap, np.int64), np.zeros(3 + cap, np.int64)
    lead = n - j0
    rle[3] = (lead << 2) | 3
    n_rle, n_cig, cop, clen = int(lead > 0), 0, 3, lead

    def put_rle(v):
        nonlocal n_rle
        rle[3 + min(n_rle, cap - 1)] = v
        n_rle += 1

    def cells(op, ln):
        nonlocal n_cig, cop, clen
        if op == cop:
            clen += ln
            return
        if clen > 0:
            cig[3 + min(n_cig, cap - 1)] = (clen << 2) | cop
            n_cig += 1
        cop, clen = op, ln

    def first_zero(mask):
        return next(k for k in range(lanes + 1) if k == lanes or not (mask >> k) & 1)

    i, j = m, j0
    while i > 0:
        d, ln = bits(i, j), 0
        if d & 1:
            while True:
                chain = ballot(lambda k: i - k > 0 and j - k > 0 and bits(i - k, j - k) & 1)
                eq = ballot(lambda k: i - k > 0 and j - k > 0 and a_idx[i - k - 1] == b[j - k - 1])
                k = lanes if chain == full else first_zero(chain)
                c = 0
                while c < k:
                    v = (eq >> c) & 1
                    same = ((~eq & full) if v else eq) >> c
                    run = min(((same & -same).bit_length() - 1) if same else lanes - c, k - c)
                    cells(0 if v else 1, run)
                    c += run
                i, j, ln = i - k, j - k, ln + k
                if k != lanes:
                    break
            put_rle(ln << 2)
        else:
            along = bool(d & 2)
            bit = 8 if along else 4
            while True:
                ext = ballot(lambda k: (i if along else i - k) > 0 and (j - k if along else j) >= 0
                             and bits(i if along else i - k, j - k if along else j) & bit)
                k = lanes if ext == full else first_zero(ext) + 1
                i, j, ln = (i, j - k, ln + k) if along else (i - k, j, ln + k)
                if ext != full:
                    break
            cells(3 if along else 2, ln)
            put_rle((ln << 2) | (3 if along else 2))
    if j > 0:
        cells(3, j)
    cells(-1, 0)
    rle[:3], cig[:3] = (score, n_rle, j0), (score, n_cig, j0)
    return rle, cig


def _model_subjects(rng, query, long_ones: bool):
    subjects = ["".join("ATGCN"[i] for i in rng.integers(0, 5, int(rng.integers(0, 60)))) for _ in range(4)]
    subjects += [query[5:25] + "".join("ATGC"[i] for i in rng.integers(0, 4, 15)), query, "A", "",
                 query[:12] + "GATTACA" + query[12:]]
    if long_ones:
        subjects += ["".join("ATGC"[i] for i in rng.integers(0, 4, 530))]
    return subjects


@pytest.mark.parametrize("lanes,r_max,smem", [(4, 2, True), (8, 1, False), (2, 4, False), (32, 16, True)])
@pytest.mark.parametrize("go,ge", [(-69, -1), (-5, -2)])
def test_a1_model_matches_twin(lanes, r_max, smem, go, ge):
    """A1's bands, skew, strips, decisions and walk equal the twins (the
    JAX runs of ``_align_dp_plain`` and the CIGAR runs of
    ``_align_cigar_plain``), the cap at 4 so that runs pass it: 2-8 lanes
    of 1-4 rows put a 30-letter query in 2-8 strips, each layout, and
    walk it in windows of 2-8 cells; the kernel's 32 lanes of up to 16
    rows hold it in one strip, with a subject of 530 letters, and a
    600-letter query in two strips of 16 rows a lane.  Subjects include an
    empty one, one letter and an insertion."""
    rng = np.random.default_rng(5)
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 30))
    cases = [(query, _model_subjects(rng, query, lanes == 32))]
    if lanes == 32:
        long_q = "".join("ATGC"[i] for i in rng.integers(0, 4, 600))
        cases.append((long_q, [long_q[100:150], long_q[550:] + "ACGT", ""]))
    if lanes == 2:
        cases.append(("", ["ACG", ""]))
    for q, subjects in cases:
        a_sub, b_flat, lengths = _dp_inputs(q, subjects)
        a_idx = _query_idx(q)
        rle = tad.align_dp(a_sub, b_flat, lengths, go, ge, 4)
        cig = tad.align_cigar(a_sub, a_idx, b_flat, lengths, go, ge, 4)
        offs = np.concatenate([[0], np.cumsum(lengths)])
        for bi in range(len(subjects)):
            b = b_flat.numpy()[offs[bi] : offs[bi + 1]].astype(np.int64)
            got_rle, got_cig = _a1_model(a_sub.numpy().astype(np.int64), a_idx.numpy(), b, go, ge, 4, lanes, r_max, smem)
            for got, (score, runs, count, j0) in ((got_rle, rle), (got_cig, cig)):
                assert tuple(got[:3]) == (score[bi], count[bi], j0[bi]), (q[:5], bi)
                np.testing.assert_array_equal(got[3:], runs[bi].numpy())


def test_launch_groups_keep_tl_in_budget():
    """A1's device-memory launches cut the batch where its decisions (4
    bits a cell, 8 columns a word, past one strip the strip buffers) would
    pass the budget; a subject alone above it takes a launch of its own."""
    lengths = [99, 100, 3, 299, 10]  # words of n + 1 columns: 13, 13, 1, 38, 2, a pitch of 3 rows
    assert [tad._global_words(2, n) for n in lengths] == [39, 39, 3, 114, 6]
    assert tad._launch_groups(lengths, 2, 4 * 81) == [(0, 3), (3, 4), (4, 5)]
    assert tad._launch_groups(lengths, 2, 1 << 20) == [(0, 5)]
    assert tad._launch_groups([5], 2, 1) == [(0, 1)]
    # past one strip (32 lanes x 16 rows) the two strip buffers of H and E follow the decisions
    assert tad._global_words(500, 10) == 513 * 2 and tad._global_words(600, 10) == 609 * 2 + 4 * 11


def test_smem_layout_and_budget():
    """The shared memory of A1's block as the kernel lays it out: the main
    shape (389-letter windows, 289-letter query) fits three blocks an H100
    SM (228 KB, 1 KB reserved a block) and the shared layout; a
    2,000-letter subject passes ``SMEM_BUDGET_BYTES`` and takes the
    device-memory layout, in a launch of its own."""
    assert [tad._rows_per_lane(m) for m in (30, 40, 289, 600)] == [1, 2, 10, 16]
    main = tad._smem_bytes(289, 389)
    assert main == 60 * 290 + 304 + 400 + 4 * 291 * 49 and 3 * (main + 1024) <= 228 * 1024
    assert main <= tad.SMEM_BUDGET_BYTES < tad._smem_bytes(289, 2000)
    assert list(tad._smem_bytes(289, np.array([389, 2000]))) == [main, tad._smem_bytes(289, 2000)]
    plan = tad._launch_plan([389, 2000, 0], 289)
    assert [(sel.tolist(), None if w is None else w.tolist()) for sel, w in plan] == [([0, 2], None), ([1], [0])]


# --- the router --------------------------------------------------------------------


def _router_calls(monkeypatch, query, subjects, device):
    """(results, devices the device aligner was called with)."""
    seen = []
    real = tad.semiglobal_align_device

    def spy(q, subs, go, ge, device="cuda"):
        seen.append(str(device))
        return real(q, subs, go, ge, device="cpu")

    monkeypatch.setattr(tad, "semiglobal_align_device", spy)
    return talign.align_hits_batch(query, subjects, -69, -1, device=device), seen


def test_router_forced_on(jax_align, monkeypatch):
    """KMERGMA_ALIGN_DEVICE=1 takes the device aligner on the caller's
    device, whatever the batch size and the native library."""
    _jad, jal = jax_align
    query, subjects = _indel_mutants()
    monkeypatch.setenv("KMERGMA_ALIGN_DEVICE", "1")
    got, seen = _router_calls(monkeypatch, query, subjects[:3], "cpu")
    assert seen == ["cpu"] and _pairs(got) == _pairs(jal.semiglobal_align(query, s, -69, -1) for s in subjects[:3])
    assert _router_calls(monkeypatch, query, subjects, "cuda")[1] == ["cuda"]


def test_router_forced_off(monkeypatch):
    """KMERGMA_ALIGN_DEVICE=0 never takes it, not even on a CUDA device
    without the native library."""
    query, subjects = _indel_mutants()
    monkeypatch.setenv("KMERGMA_ALIGN_DEVICE", "0")
    monkeypatch.setenv("KMERGMA_ALIGN_NATIVE", "0")
    got, seen = _router_calls(monkeypatch, query, subjects + subjects, "cuda")
    assert seen == [] and _pairs(got) == _pairs(talign.semiglobal_align_batch(query, subjects + subjects))


def _host_routes(monkeypatch) -> list:
    """The host batches' routes as they run: "native" where the threaded
    native DP took the batch, "numpy" where the NumPy wavefront did."""
    routes = []
    real = talign._align_batch_native

    def spy(*args):
        got = real(*args)
        routes.append("numpy" if got is None else "native")
        return got

    monkeypatch.setattr(talign, "_align_batch_native", spy)
    return routes


def test_router_unset(monkeypatch):
    """Unset: the device aligner on a CUDA device for 16 subjects or more;
    any other batch to the native DP where its library is present, else
    to the NumPy batch."""
    from kmergma_tpu_torch.utils.native import get_lib

    query, subjects = _indel_mutants()
    assert len(subjects) == 16 and get_lib() is not None  # the native DP is built here
    monkeypatch.delenv("KMERGMA_ALIGN_DEVICE", raising=False)
    monkeypatch.delenv("KMERGMA_ALIGN_NATIVE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # the spy runs the twins on the CPU
    routes = _host_routes(monkeypatch)
    want = _pairs(talign.semiglobal_align_batch(query, subjects))
    routes.clear()
    for device in ("cuda", "cuda:0"):
        got, seen = _router_calls(monkeypatch, query, subjects, device)
        assert seen == [device] and routes == [] and _pairs(got) == want
    got, seen = _router_calls(monkeypatch, query, subjects[:15], "cuda")
    assert seen == [] and routes == ["native"] and _pairs(got) == want[:15]
    got, seen = _router_calls(monkeypatch, query, subjects, "cpu")
    assert seen == [] and routes == ["native"] * 2 and _pairs(got) == want
    monkeypatch.setenv("KMERGMA_ALIGN_NATIVE", "0")
    got, seen = _router_calls(monkeypatch, query, subjects, "cpu")
    assert seen == [] and routes == ["native"] * 2 + ["numpy"] and _pairs(got) == want


@pytest.mark.parametrize("device,n,native,route", [
    ("cuda", 16, True, "a1"),
    ("cuda", 15, True, "native"),
    ("cpu", 16, True, "native"),
    ("cpu", 16, False, "numpy"),
])
def test_align_span_counts_a1_windows(monkeypatch, device, n, native, route):
    """Unset, each route runs in one ``align`` span that counts its
    windows; only the device aligner's span carries ``a1_windows``, equal
    to the batch size."""
    from kmergma_tpu_torch.utils import trace

    query, subjects = _indel_mutants()
    monkeypatch.delenv("KMERGMA_ALIGN_DEVICE", raising=False)
    monkeypatch.setenv("KMERGMA_ALIGN_NATIVE", "" if native else "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # the spy runs the twins on the CPU
    routes = _host_routes(monkeypatch)
    trace.reset()
    trace.enable()
    try:
        got, seen = _router_calls(monkeypatch, query, subjects[:n], device)
    finally:
        trace.disable()
    log = trace.log()
    trace.reset()
    assert (seen, routes) == (([device], []) if route == "a1" else ([], [route]))
    assert _pairs(got) == _pairs(talign.semiglobal_align_batch(query, subjects[:n]))
    want = {"windows": n, "a1_windows": n} if route == "a1" else {"windows": n}
    assert [(s["name"], s["counters"]) for s in log] == [("align", want)]


def test_router_unset_without_cuda(monkeypatch):
    """Unset, on a host without CUDA and without the native library, a
    caller that leaves the device at its default gets the NumPy batch."""
    query, subjects = _indel_mutants()
    monkeypatch.delenv("KMERGMA_ALIGN_DEVICE", raising=False)
    monkeypatch.setenv("KMERGMA_ALIGN_NATIVE", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert len(subjects) >= 16
    got = talign.align_hits_batch(query, subjects, -69, -1)
    assert _pairs(got) == _pairs(talign.semiglobal_align_batch(query, subjects))


def test_device_aligner_refuses_without_cuda(monkeypatch):
    query, subjects = _indel_mutants()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tad.semiglobal_align_device(query, subjects)
    with pytest.raises(ValueError, match="unsupported device"):
        tad.align_dp(*(x.to("meta") if torch.is_tensor(x) else x for x in _dp_inputs(query, subjects)), -69, -1)


def test_mine_genome_align_device_env(monkeypatch):
    """find_genes' miner under KMERGMA_ALIGN_DEVICE=1 (the twins on the
    CPU) gives the default run's hits, loci and alignments."""
    genome = str(DATA / "Alp_V_locus.fasta")
    profile = gen_ref_ws_cons(str(DATA / "Alp_V_ref.fasta"), 6)

    def run():
        res = mine_genome(genome, profile, thr=30, do_return_align=True, get_hit_loci=True, device="cpu")
        return [(h.description, h.seq) for h in res.hits], res.hit_loci, _pairs(res.alignments)

    monkeypatch.delenv("KMERGMA_ALIGN_DEVICE", raising=False)
    want = run()
    monkeypatch.setenv("KMERGMA_ALIGN_DEVICE", "1")
    calls = []
    real = tad.align_cigar
    monkeypatch.setattr(tad, "align_cigar", lambda *a: calls.append(len(a[3])) or real(*a))
    assert run() == want and len(want[0]) == 3 and calls == [3]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["find_genes", "strobemer_find_genes"])
def test_default_route_takes_a1_on_card(entry, monkeypatch):
    """On the card the default route sends a record's 16 hits or more to
    A1 (the Alp_V locus at threshold 40: 28 windows in one batch for
    find_genes, 32 for the strobe search), and the hits, loci and
    alignments equal those of KMERGMA_ALIGN_DEVICE=0, the host DP."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (A1 has no CPU mode)")
    import kmergma_tpu_torch as kt

    def run() -> tuple:
        tad.align_dp.launches = 0
        hits, loci, alns = getattr(kt, entry)(str(DATA / "Alp_V_locus.fasta"), str(DATA / "Alp_V_ref.fasta"),
                                              kmer_dist_thr=40, verbose=False, do_return_hit_loci=True,
                                              do_return_align=True, device="cuda")
        return ([(h.description, bytes(h.seq)) for h in hits], loci, _pairs(alns)), tad.align_dp.launches

    monkeypatch.delenv("KMERGMA_ALIGN_DEVICE", raising=False)
    got, launched = run()
    monkeypatch.setenv("KMERGMA_ALIGN_DEVICE", "0")
    want, host_launched = run()
    assert got == want and len(want[0]) >= 3 and launched > 0 and host_launched == 0


@pytest.mark.cuda
def test_a1_matches_twin_on_card():
    """A1 against its twins on the card: scores, JAX runs, run counts,
    endpoints, CIGAR runs and their counts of one query against subjects
    of mixed lengths (past 511 letters too), one launch each, and
    AlignResults equal to the host batch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (A1 has no CPU mode)")
    query, subjects = _indel_mutants()
    rng = np.random.default_rng(3)
    subjects += ["".join("ATGCN"[i] for i in rng.integers(0, 5, int(rng.integers(1, 700)))) for _ in range(40)]
    a_sub, b_flat, lengths = (x.cuda() if torch.is_tensor(x) else x for x in _dp_inputs(query, subjects))
    a_idx = _query_idx(query).cuda()
    tad.align_dp.launches = 0
    got = tad.align_dp(a_sub, b_flat, lengths, -69, -1)
    want = tad._align_dp_plain(a_sub, b_flat, lengths, -69, -1, tad.RLE_CAP)
    torch.cuda.synchronize()
    assert tad.align_dp.launches == 1
    got_cig = tad.align_cigar(a_sub, a_idx, b_flat, lengths, -69, -1)
    want_cig = tad._align_cigar_plain(a_sub, a_idx, b_flat, lengths, -69, -1, tad.RLE_CAP)
    torch.cuda.synchronize()
    assert tad.align_dp.launches == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(tad._rows(got_cig[0], tad.RLE_CAP), want_cig)
    assert _pairs(tad.semiglobal_align_device(query, subjects)) == _pairs(talign.semiglobal_align_batch(query, subjects))


@pytest.mark.cuda
def test_a1_overflow_rerun_on_card(monkeypatch):
    """With RLE_CAP shrunk to 2, the hits past it run A1 again on the card
    at the next power of two, and every AlignResult equals the host
    batch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (A1 has no CPU mode)")
    query, subjects = _indel_mutants()
    monkeypatch.setattr(tad, "RLE_CAP", 2)
    tad.align_dp.launches = 0
    tad.semiglobal_align_device.overflowed = 0
    got = tad.semiglobal_align_device(query, subjects, -5, -1)
    assert tad.semiglobal_align_device.overflowed > 0 and tad.align_dp.launches == 2
    assert _pairs(got) == _pairs(talign.semiglobal_align_batch(query, subjects, -5, -1))
