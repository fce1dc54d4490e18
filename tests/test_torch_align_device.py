"""The port's device aligner (``kmergma_tpu_torch.ops.align_device``) and
the alignment router against the JAX package (zero tolerance: integer
arithmetic).

On the CPU ``semiglobal_align_device(device="cpu")`` runs the plain twins
of A1 (``_forward_tl_plain``, ``_traceback_rle_plain``); they are held
against the JAX ``semiglobal_align_device`` and ``semiglobal_align`` on
the inputs of tests/test_alignment.py, and their TL and run outputs
against the JAX ``_forward_tl`` and ``_get_jit().run``.  A NumPy model of
A1's own arithmetic (``csrc/align_dp.cu``: 32 lanes of 16 columns a tile,
the warp max-scans, the carries across tiles, the packed decision masks,
the traceback from the padded TL rows) is held against the twins, on
tiles shrunk so that short subjects cross many of them and at the
kernel's own width.  The ``cuda`` test runs A1 on the card; the file
reaches the JAX package only through a fixture, so on a GPU host without
jax that test runs as
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
    cap shrunk to 2 on tests/test_alignment.py's inputs, whose alignments
    at -69/-1 have 2 runs (none overflows) and at -5/-1 more than 2 (all
    do)."""
    _jad, jal = jax_align
    monkeypatch.setattr(tad, "RLE_CAP", 2)
    rng = np.random.default_rng(13)
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 60))
    subjects = ["".join("ATGCN"[i] for i in rng.integers(0, 5, 90)) for _ in range(5)]
    _, rle, n_runs, _ = tad.align_dp(*_dp_inputs(query, subjects), go, ge)
    over = int((n_runs > 2).sum())
    assert rle.shape == (5, 2) and over == (0 if go == -69 else 5)
    calls = []
    real = tad.align_dp
    monkeypatch.setattr(tad, "align_dp", lambda *a: calls.append((len(a[2]), a[1].device.type, a[5])) or real(*a))
    tad.semiglobal_align_device.overflowed = 0
    got = tad.semiglobal_align_device(query, subjects, go, ge, device="cpu")
    assert _pairs(got) == _pairs(jal.semiglobal_align(query, s, go, ge) for s in subjects)
    rerun = [(over, "cpu", 1 << (int(n_runs.max()) - 1).bit_length())] if over else []
    assert calls == [(5, "cpu", None)] + rerun and tad.semiglobal_align_device.overflowed == over


def _dp_inputs(query, subjects):
    a = _seq_to_idx(query)
    bs = [_seq_to_idx(s) for s in subjects]
    return (torch.from_numpy(_NUC44[a].astype(np.int32).reshape(-1, 15)),
            torch.from_numpy(np.concatenate(bs).astype(np.int8)), [b.shape[0] for b in bs])


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


# --- a NumPy model of A1's arithmetic (csrc/align_dp.cu) -------------------------

_NEG = -(1 << 30)


def _a1_model(a_sub, b, go, ge, cap, lanes=32, cols=16):
    """One subject through A1's arithmetic: ``lanes`` lanes of ``cols``
    columns a tile (the kernel's 32 x 16), the previous row in the lanes'
    registers for one tile and in per-column scratch for more, the warp
    max-scans as prefix maxima over the lanes, the carries across tiles,
    TL in rows of n + 1 rounded up to 4, the endpoint reduce and lane 0's
    traceback.  Returns (score, rle, n_runs, j0)."""
    m, n = a_sub.shape[0], b.shape[0]
    tile = lanes * cols
    n1 = -(-(n + 1) // 4) * 4
    n_tiles = (n + tile) // tile
    wide = n_tiles > 1
    TL = np.zeros((m, n1), dtype=np.int64)
    shape = (lanes, cols)
    H, E, C, EL = np.zeros(shape, np.int64), np.full(shape, _NEG, np.int64), np.zeros(shape, np.int64), np.zeros(shape, np.int64)
    st = [np.zeros(n + 1, np.int64), np.full(n + 1, _NEG, np.int64), np.zeros(n + 1, np.int64), np.zeros(n + 1, np.int64)]

    def letters(t):
        j = t * tile + np.arange(tile).reshape(shape)
        return np.where((j >= 1) & (j <= n), b[np.clip(j - 1, 0, max(n - 1, 0))] if n else 0, 0)

    letter = letters(0)
    best, best_j = np.full(lanes, -(2**31), np.int64), np.full(lanes, -1, np.int64)
    for i in range(1, m + 1):
        col = go + ge * i
        carry_run, carry_h, carry_c, carry_f, carry_brk = _NEG, 0, 0, _NEG, -1
        for t in range(n_tiles):
            J = t * tile + np.arange(tile).reshape(shape)  # column of lane l, slot q
            live = J <= n
            if wide:
                letter = letters(t)
                for arr, row in zip((H, E, C, EL), st):
                    arr[live] = row[J[live]]
            hl = np.concatenate([[carry_h], H[:-1, -1]])
            cl = np.concatenate([[carry_c], C[:-1, -1]])
            carry_h, carry_c = H[-1, -1], C[-1, -1]
            G, dg = np.zeros(shape, np.int64), np.zeros(shape, np.int64)
            for q in range(cols):
                j = J[:, q]
                hleft = hl if q == 0 else H[:, q - 1]
                e = np.where(j == 0, col, np.maximum(H[:, q] + go + ge, E[:, q] + ge))
                dg[:, q] = np.where(j == 0, _NEG, hleft + a_sub[i - 1, letter[:, q]])
                G[:, q] = np.where(j == 0, col, np.maximum(dg[:, q], e))
                EL[:, q] = np.where((i > 1) & (e == E[:, q] + ge), EL[:, q] + 1, 1)
                E[:, q] = e
            base = np.where(J == 0, col, G - ge * J)
            agg = np.where(live, base, _NEG).max(axis=1)
            incl = np.maximum.accumulate(agg)
            run = np.maximum(np.concatenate([[_NEG], incl[:-1]]), carry_run)
            carry_run = max(carry_run, incl[-1])
            F = np.zeros(shape, np.int64)
            dm, fm, xm = np.zeros(shape, bool), np.zeros(shape, bool), np.zeros(shape, bool)
            c_left = cl
            for q in range(cols):
                j = J[:, q]
                F[:, q] = np.where(j == 0, _NEG, go + ge * j + run)
                h = np.where(j == 0, col, np.maximum(G[:, q], F[:, q]))
                run = np.maximum(run, base[:, q])
                dm[:, q] = (j > 0) & (h == dg[:, q])
                fm[:, q] = (j > 0) & (h == F[:, q])
                if q > 0:
                    xm[:, q] = (j > 1) & (F[:, q] == F[:, q - 1] + ge)
                c_old = C[:, q].copy()
                C[:, q] = np.where(dm[:, q], c_left + 1, 0)
                c_left = c_old
                H[:, q] = h
                if i == m:
                    up = (j <= n) & (h >= best)
                    best, best_j = np.where(up, h, best), np.where(up, j, best_j)
            fl_left = np.concatenate([[carry_f], F[:-1, -1]])
            carry_f = F[-1, -1]
            xm[:, 0] = (J[:, 0] > 1) & (F[:, 0] == fl_left + ge)
            lane_brk = np.where(~xm, J, -1).max(axis=1)
            bincl = np.maximum.accumulate(lane_brk)
            last_brk = np.maximum(np.concatenate([[-1], bincl[:-1]]), carry_brk)
            carry_brk = max(carry_brk, bincl[-1])
            for q in range(cols):
                j = J[:, q]
                last_brk = np.where(xm[:, q], last_brk, np.maximum(last_brk, j))
                v = np.where(dm[:, q], C[:, q] << 2, np.where(fm[:, q], ((j - last_brk + 1) << 2) | 3, (EL[:, q] << 2) | 2))
                keep = j < n1
                TL[i - 1, j[keep]] = v[keep]
            if wide:
                for arr, row in zip((H, E, C, EL), st):
                    row[J[live]] = arr[live]
    top = max(range(lanes), key=lambda ln: (best[ln], best_j[ln]))
    score, j0 = (0, n) if m == 0 else (int(best[top]), int(best_j[top]))
    out = np.zeros(cap, np.int64)
    out[0] = ((n - j0) << 2) | 3
    pos, i, j = int(n - j0 > 0), m, j0
    while i > 0 and j >= 0:
        v = int(TL[i - 1, j])
        out[min(pos, cap - 1)] = v
        i -= 0 if v & 3 == 3 else v >> 2
        j -= 0 if v & 3 == 2 else v >> 2
        pos += 1
    return score, out, pos, j0


@pytest.mark.parametrize("lanes,cols", [(4, 4), (2, 16), (32, 16)])
@pytest.mark.parametrize("go,ge", [(-69, -1), (-5, -2)])
def test_a1_model_matches_twin(lanes, cols, go, ge):
    """A1's lane and tile arithmetic equals the twins': tiles of 16 and 32
    columns (many tiles a subject, so every carry is crossed) and the
    kernel's 512, with subjects past one tile (the scratch route), an empty
    subject and one letter."""
    rng = np.random.default_rng(5)
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 30))
    subjects = ["".join("ATGCN"[i] for i in rng.integers(0, 5, int(rng.integers(0, 60)))) for _ in range(5)]
    subjects += [query[5:25] + "".join("ATGC"[i] for i in rng.integers(0, 4, 15)), query, "A", ""]
    if lanes == 32:
        subjects += ["".join("ATGC"[i] for i in rng.integers(0, 4, 530)), query * 20]
    a_sub, b_flat, lengths = _dp_inputs(query, subjects)
    scores, rle, n_runs, j0 = (x.numpy() for x in tad.align_dp(a_sub, b_flat, lengths, go, ge))
    offs = np.concatenate([[0], np.cumsum(lengths)])
    for bi in range(len(subjects)):
        b = b_flat.numpy()[offs[bi] : offs[bi + 1]].astype(np.int64)
        score, out, pos, end = _a1_model(a_sub.numpy().astype(np.int64), b, go, ge, tad.RLE_CAP, lanes, cols)
        assert (score, pos, end) == (scores[bi], n_runs[bi], j0[bi]), bi
        np.testing.assert_array_equal(out, rle[bi])


def test_launch_groups_keep_tl_in_budget():
    """A1's launches cut the batch where its TL would pass the budget; a
    subject alone above it takes a launch of its own."""
    lengths = [99, 100, 3, 299, 10]  # n + 1 rounded up to 4: 100, 104, 4, 300, 12
    assert tad._launch_groups(lengths, 2, 4 * 2 * 208) == [(0, 3), (3, 4), (4, 5)]
    assert tad._launch_groups(lengths, 2, 1 << 20) == [(0, 5)]
    assert tad._launch_groups([5], 2, 1) == [(0, 1)]


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


def test_router_unset(monkeypatch):
    """Unset: the native DP when present; without it the device aligner on
    a CUDA device for 16 subjects or more, else the NumPy batch."""
    query, subjects = _indel_mutants()
    monkeypatch.delenv("KMERGMA_ALIGN_DEVICE", raising=False)
    monkeypatch.delenv("KMERGMA_ALIGN_NATIVE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # the spy runs the twins on the CPU
    assert _router_calls(monkeypatch, query, subjects, "cuda")[1] == []  # the native DP is built here
    monkeypatch.setenv("KMERGMA_ALIGN_NATIVE", "0")
    assert _router_calls(monkeypatch, query, subjects, "cuda")[1] == ["cuda"]
    assert _router_calls(monkeypatch, query, subjects[:15], "cuda")[1] == []
    assert _router_calls(monkeypatch, query, subjects, "cpu")[1] == []


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
    real = tad.align_dp
    monkeypatch.setattr(tad, "align_dp", lambda *a: calls.append(len(a[2])) or real(*a))
    assert run() == want and len(want[0]) == 3 and calls == [3]


@pytest.mark.cuda
def test_a1_matches_twin_on_card():
    """A1 against its twins on the card: scores, runs, run counts and
    endpoints of one query against subjects of mixed lengths (one past a
    tile), and AlignResults equal to the host batch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (A1 has no CPU mode)")
    query, subjects = _indel_mutants()
    rng = np.random.default_rng(3)
    subjects += ["".join("ATGCN"[i] for i in rng.integers(0, 5, int(rng.integers(1, 700)))) for _ in range(40)]
    a_sub, b_flat, lengths = (x.cuda() if torch.is_tensor(x) else x for x in _dp_inputs(query, subjects))
    tad.align_dp.launches = 0
    got = tad.align_dp(a_sub, b_flat, lengths, -69, -1)
    want = tad._align_dp_plain(a_sub, b_flat, lengths, -69, -1, tad.RLE_CAP)
    torch.cuda.synchronize()
    assert tad.align_dp.launches == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
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
