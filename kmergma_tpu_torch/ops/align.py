"""Semi-global affine-gap alignment + CIGAR-range trimming.

Reimplements the hit-refinement layer (ref KmerGMA.jl src/Alignment.jl)
without BioAlignments: a Gotoh affine-gap DP, global in the query (the
consensus) with free end gaps in the subject (the buffered hit window),
scored with the full IUPAC EDNAFULL (NUC.4.4) matrix that BioAlignments'
``AffineGapScoreModel(EDNAFULL, ...)`` uses (ref Alignment.jl:37,
GenomeMiner.jl:28).

Traceback conventions (endpoint choice, move precedence at score ties,
gap-extend vs gap-open preference) are calibrated against the reference
suite's pinned alignments (reference test-KmerGMA.jl:128-152 and the golden
hit MatchPos strings) - BioAlignments' tie-breaking is observable behaviour,
not documented API, so the pinned outcomes are the spec.

Hits are rare (~10 per half-megabase), so this path is correctness-critical,
not throughput-critical (SURVEY.md section 7 item 5); the DP is a NumPy
row-vectorised wavefront on host, or the threaded native library's.  The
device aligner (``ops/align_device.py``, kernel A1 on the card) takes a
card's batches of 16 hits or more through ``align_hits_batch``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import trace

# ---------------------------------------------------------------------------
# EDNAFULL / NUC.4.4 over the 15 IUPAC letters (order as in the EMBOSS file).
# ---------------------------------------------------------------------------

_IUPAC = "ATGCSWRYKMBVHDN"
_NUC44 = np.array(
    [
        # A   T   G   C   S   W   R   Y   K   M   B   V   H   D   N
        [5, -4, -4, -4, -4, 1, 1, -4, -4, 1, -4, -1, -1, -1, -2],  # A
        [-4, 5, -4, -4, -4, 1, -4, 1, 1, -4, -1, -4, -1, -1, -2],  # T
        [-4, -4, 5, -4, 1, -4, 1, -4, 1, -4, -1, -1, -4, -1, -2],  # G
        [-4, -4, -4, 5, 1, -4, -4, 1, -4, 1, -1, -1, -1, -4, -2],  # C
        [-4, -4, 1, 1, -1, -4, -2, -2, -2, -2, -1, -1, -3, -3, -1],  # S
        [1, 1, -4, -4, -4, -1, -2, -2, -2, -2, -3, -3, -1, -1, -1],  # W
        [1, -4, 1, -4, -2, -2, -1, -4, -2, -2, -3, -1, -3, -1, -1],  # R
        [-4, 1, -4, 1, -2, -2, -4, -1, -2, -2, -1, -3, -1, -3, -1],  # Y
        [-4, 1, 1, -4, -2, -2, -2, -2, -1, -4, -1, -3, -3, -1, -1],  # K
        [1, -4, -4, 1, -2, -2, -2, -2, -4, -1, -3, -1, -1, -3, -1],  # M
        [-4, -1, -1, -1, -1, -3, -3, -1, -1, -3, -1, -2, -2, -2, -1],  # B
        [-1, -4, -1, -1, -1, -3, -1, -3, -3, -1, -2, -1, -2, -2, -1],  # V
        [-1, -1, -4, -1, -3, -1, -3, -1, -3, -1, -2, -2, -1, -2, -1],  # H
        [-1, -1, -1, -4, -3, -1, -1, -3, -1, -3, -2, -2, -2, -1, -1],  # D
        [-2, -2, -2, -2, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],  # N
    ],
    dtype=np.int64,
)

_CHAR_TO_IDX = np.full(256, -1, dtype=np.int64)
for _i, _c in enumerate(_IUPAC):
    _CHAR_TO_IDX[ord(_c)] = _i
    _CHAR_TO_IDX[ord(_c.lower())] = _i
# U behaves as T
_CHAR_TO_IDX[ord("U")] = _CHAR_TO_IDX[ord("u")] = _IUPAC.index("T")

NEG_INF = np.int64(-(2**40))


def _seq_to_idx(seq: "str | bytes") -> np.ndarray:
    raw = np.frombuffer(seq.encode() if isinstance(seq, str) else bytes(seq), dtype=np.uint8)
    idx = _CHAR_TO_IDX[raw]
    if idx.size and idx.min() < 0:
        bad = chr(int(raw[np.argmax(idx < 0)]))
        raise ValueError(f"invalid IUPAC character {bad!r}")
    return idx


@dataclass
class AlignResult:
    """Pairwise semi-global result: score + CIGAR runs over the subject."""

    score: int
    cigar_runs: list[tuple[int, str]]  # [(count, op)], ops in {'=','X','I','D'}

    @property
    def cigar(self) -> str:
        return "".join(f"{c}{op}" for c, op in self.cigar_runs)


def semiglobal_align(
    query: "str | bytes",
    subject: "str | bytes",
    gap_open: int = -69,
    gap_extend: int = -1,
) -> AlignResult:
    """Align ``query`` globally within ``subject`` (free end gaps in subject).

    Gap of length L costs gap_open + L * gap_extend, matching BioAlignments'
    AffineGapScoreModel convention.
    """
    a = _seq_to_idx(query)
    b = _seq_to_idx(subject)
    m, n = a.shape[0], b.shape[0]
    go, ge = np.int64(gap_open), np.int64(gap_extend)

    sub = _NUC44[a][:, b]  # (m, n) substitution scores

    # DP rows over i; vectorised in j.  H[i,j]: best score of a[:i] vs b[:j]
    # with free leading b-gap.  E: last op consumes a ('I').  F: last op
    # consumes b ('D').
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    F = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    H[0, :] = 0  # free leading subject gap
    for i in range(1, m + 1):
        H[i, 0] = E[i, 0] = go + ge * i

    jj = np.arange(1, n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        E[i, 1:] = np.maximum(H[i - 1, 1:] + go + ge, E[i - 1, 1:] + ge)
        diag = H[i - 1, :-1] + sub[i - 1]
        G = np.maximum(diag, E[i, 1:])
        # F via running max: F[i,j] = go + ge*j + max_{j'<j}(max(G,H)[j'] - ge*j')
        # (substituting G for H inside the max never loses the optimum).
        base = np.empty(n + 1, dtype=np.int64)
        base[0] = H[i, 0] - 0  # j'=0 term: H[i,0] - ge*0
        base[1:] = G - ge * jj
        run = np.maximum.accumulate(base[:-1])
        F[i, 1:] = go + ge * jj + run
        H[i, 1:] = np.maximum(G, F[i, 1:])

    return _traceback(a, b, sub, H, E, F, go, ge)


def semiglobal_align_batch(
    query: "str | bytes",
    subjects: "list[str | bytes]",
    gap_open: int = -69,
    gap_extend: int = -1,
) -> "list[AlignResult]":
    """Batched ``semiglobal_align``: one query against many subjects.

    Bit-identical results (fuzz-pinned in tests/test_alignment.py), but the
    row-wavefront forward DP is vectorised ACROSS the batch as well as along
    j, so aligning H hits costs ~one DP's worth of NumPy dispatch overhead
    instead of H (the hit-dense measurement that motivated this: ~3 ms per
    hit x 100 hits of pure per-call overhead).  Subjects are grouped by
    length internally (buffered hit windows share one length except at
    record edges); the per-hit traceback stays sequential - it is O(m+n)
    per hit, not O(m*n).  Runs in an ``align`` span (utils/trace.py).
    """
    if not subjects:
        return []
    with trace.span("align") as sp:
        sp.add(windows=len(subjects))
        return _semiglobal_align_batch(query, subjects, gap_open, gap_extend)


def _semiglobal_align_batch(query, subjects, gap_open: int, gap_extend: int) -> "list[AlignResult]":
    a = _seq_to_idx(query)
    bs = [_seq_to_idx(s) for s in subjects]
    m = a.shape[0]
    native = _align_batch_native(a, bs, gap_open, gap_extend)
    if native is not None:
        return native
    go, ge = np.int64(gap_open), np.int64(gap_extend)
    out: list[AlignResult | None] = [None] * len(subjects)

    by_len: dict[int, list[int]] = {}
    for i, b in enumerate(bs):
        by_len.setdefault(b.shape[0], []).append(i)

    # The batched pass is MEMORY-BANDWIDTH bound (per-hit DP matrices fit
    # the cache; batched ones do not), so it stores only H and E (F rows are
    # recomputed lazily during traceback from H/E - _LazyFRows), allocates
    # with np.empty (every interior cell is overwritten), and narrows to
    # int16 whenever the score bounds allow.  All reachable DP values are
    # exact small integers in every width, so results are bit-identical.
    max_n = max(by_len)
    bound = abs(gap_open) + abs(gap_extend) * (m + max_n + 2) + 5 * m
    dt = np.int16 if 2 * bound + 64 < 2**14 else np.int32
    neg = np.array(-(2**14) if dt == np.int16 else -(2**30), dtype=dt)
    go_d, ge_d = np.array(gap_open, dtype=dt), np.array(gap_extend, dtype=dt)
    for n, idxs in by_len.items():
        # bound the live (m+1, B, n+1) DP tensors; rows lead the layout so
        # every update touches contiguous (B, n+1) slabs
        itemsize = np.dtype(dt).itemsize
        max_b = max(1, (64 << 20) // ((2 * itemsize + 1) * (m + 1) * (n + 1)))
        for lo in range(0, len(idxs), max_b):
            chunk = idxs[lo : lo + max_b]
            bmat = np.stack([bs[i] for i in chunk])  # (B, n)
            B = bmat.shape[0]
            H = np.empty((m + 1, B, n + 1), dtype=dt)
            E = np.empty((m + 1, B, n + 1), dtype=dt)
            H[0] = 0
            E[0] = neg
            col = go_d + ge_d * np.arange(1, m + 1, dtype=dt)
            H[1:, :, 0] = E[1:, :, 0] = col[:, None]
            jj = np.arange(1, n + 1, dtype=dt)
            gejj = ge_d * jj
            base = np.empty((B, n + 1), dtype=dt)
            frow = np.empty((B, n), dtype=dt)
            sub_rows = _NUC44.astype(dt)[a][:, bmat]  # (m, B, n)
            for i in range(1, m + 1):
                np.maximum(H[i - 1, :, 1:] + (go_d + ge_d), E[i - 1, :, 1:] + ge_d, out=E[i, :, 1:])
                diag = H[i - 1, :, :-1] + sub_rows[i - 1]
                G = np.maximum(diag, E[i, :, 1:])
                base[:, 0] = H[i, :, 0]
                np.subtract(G, gejj, out=base[:, 1:])
                run = np.maximum.accumulate(base[:, :-1], axis=1)
                np.add(go_d + gejj, run, out=frow)
                np.maximum(G, frow, out=H[i, :, 1:])
            for bi, i_orig in enumerate(chunk):
                b = bs[i_orig]
                sub = _NUC44[a][:, b]
                # narrow strided views, not copies: _traceback makes O(m+n)
                # scalar reads (NumPy promotes mixed-width comparisons), so
                # upcasting whole matrices per hit would re-dominate
                Hb = H[:, bi, :]
                Eb = E[:, bi, :]
                out[i_orig] = _traceback(
                    a, b, sub, Hb, Eb,
                    _LazyFRows(Hb, Eb, sub, go, ge, n),
                    go, ge,
                )
    return out  # type: ignore[return-value]


def _align_batch_native(a: np.ndarray, bs: "list[np.ndarray]", gap_open: int, gap_extend: int):
    """Threaded C++ batch DP (native/fastaio.cpp semiglobal_batch) - an
    exact port of semiglobal_align + _traceback, fuzz-pinned bit-identical.
    Returns None (pure-Python fallback) when the toolchain/library is
    unavailable or KMERGMA_ALIGN_NATIVE=0."""
    import os

    if os.environ.get("KMERGMA_ALIGN_NATIVE", "") == "0":
        return None
    from ..utils.native import semiglobal_batch_native

    got = semiglobal_batch_native(a, bs, _NUC44.astype(np.int32), gap_open, gap_extend)
    if got is None:
        return None
    scores, ops_flat, ops_off, n_ops = got
    out: list[AlignResult] = []
    for i in range(len(bs)):
        rev = ops_flat[int(ops_off[i]) : int(ops_off[i]) + int(n_ops[i])]
        runs: list[tuple[int, str]] = []
        for op_code in rev[::-1]:
            op = "=XID"[int(op_code)]
            if runs and runs[-1][1] == op:
                runs[-1] = (runs[-1][0] + 1, op)
            else:
                runs.append((1, op))
        out.append(AlignResult(score=int(scores[i]), cigar_runs=runs))
    return out


def align_hits_batch(
    query: "str | bytes",
    subjects: "list[str | bytes]",
    gap_open: int = -69,
    gap_extend: int = -1,
    *,
    device: "str | torch.device" = "cuda",
) -> "list[AlignResult]":
    """Batch-align a record's hits, bit-identical on every route.

    ``KMERGMA_ALIGN_DEVICE=1`` forces the device aligner
    (``ops/align_device.semiglobal_align_device``, A1) on ``device``, the
    caller's (on the CPU its plain twins); ``=0`` forbids it.  Unset, A1
    runs when ``device`` is a CUDA device, CUDA is present and there are
    at least 16 subjects; otherwise ``semiglobal_align_batch`` (the
    threaded native host DP where its library is present, else the NumPy
    batch wavefront).  Either route runs in one ``align`` span
    (utils/trace.py); A1's also counts its subjects as ``a1_windows``."""
    if not subjects:
        return []
    import os

    force = os.environ.get("KMERGMA_ALIGN_DEVICE", "")
    if force == "":
        use_device = torch.device(device).type == "cuda" and torch.cuda.is_available() and len(subjects) >= 16
    else:
        use_device = force == "1"
    if use_device:
        from .align_device import semiglobal_align_device

        with trace.span("align") as sp:
            sp.add(windows=len(subjects), a1_windows=len(subjects))
            return semiglobal_align_device(query, subjects, gap_open, gap_extend, device=device)
    return semiglobal_align_batch(query, subjects, gap_open, gap_extend)


class _LazyFRows:
    """F rows of the affine DP, recomputed on demand from stored H/E.

    ``F[i][j]`` reproduces the forward pass's F values exactly: row i
    depends only on H[i-1], E[i] and H[i, 0] (the running-max formulation in
    semiglobal_align), so it never needs the full F matrix - the batched
    aligner drops a third of its DP memory traffic this way.  Rows are
    cached (a traceback revisits one row many times while in state 'F').
    """

    def __init__(self, H, E, sub, go, ge, n):
        self._H, self._E, self._sub = H, E, sub
        self._go, self._ge, self._n = np.int64(go), np.int64(ge), n
        self._rows: dict[int, np.ndarray] = {}

    def __getitem__(self, i: int) -> np.ndarray:
        row = self._rows.get(i)
        if row is None:
            n, go, ge = self._n, self._go, self._ge
            jj = np.arange(1, n + 1, dtype=np.int64)
            diag = self._H[i - 1, :-1].astype(np.int64) + self._sub[i - 1]
            G = np.maximum(diag, self._E[i, 1:])
            base = np.empty(n + 1, dtype=np.int64)
            base[0] = self._H[i, 0]
            base[1:] = G - ge * jj
            run = np.maximum.accumulate(base[:-1])
            row = np.empty(n + 1, dtype=np.int64)
            row[0] = NEG_INF
            row[1:] = go + ge * jj + run
            self._rows[i] = row
        return row


def _traceback(a, b, sub, H, E, F, go, ge) -> AlignResult:
    """Reconstruct the alignment path.

    Calibrated conventions (pinned by the reference-suite golden alignments):
      * endpoint: the LAST column attaining the max of H[m, :],
      * at H-ties: match/mismatch preferred over 'D' over 'I',
      * inside a gap: prefer extending over opening at ties.
    """
    m, n = a.shape[0], b.shape[0]
    score = int(H[m].max())
    j = int(n - np.argmax(H[m][::-1]))  # last argmax
    i = m

    ops: list[str] = []  # built in reverse
    ops.extend("D" * (n - j))  # free trailing subject gap
    state = "H"
    while i > 0:
        if state == "H":
            if j > 0 and H[i, j] == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                ops.append("=" if a[i - 1] == b[j - 1] else "X")
                i -= 1
                j -= 1
            elif j > 0 and H[i, j] == F[i][j]:
                state = "F"
            elif H[i, j] == E[i, j]:
                state = "E"
            else:  # pragma: no cover - DP invariant
                raise AssertionError("traceback: inconsistent H cell")
        elif state == "F":
            ops.append("D")
            if j > 1 and F[i][j] == F[i][j - 1] + ge:
                j -= 1  # extend
            else:
                j -= 1
                state = "H"
        else:  # state == "E"
            ops.append("I")
            if i > 1 and E[i, j] == E[i - 1, j] + ge:
                i -= 1  # extend
            else:
                i -= 1
                state = "H"
    ops.extend("D" * j)  # free leading subject gap

    runs: list[tuple[int, str]] = []
    for op in reversed(ops):
        if runs and runs[-1][1] == op:
            runs[-1] = (runs[-1][0] + 1, op)
        else:
            runs.append((1, op))
    return AlignResult(score=score, cigar_runs=runs)


def cigar_to_unitrange(result: AlignResult) -> tuple[int, int]:
    """The reference's CIGAR -> subject-range trimming
    (ref Alignment.jl:13-30): range over the subject is
    (first_run_count + 1) .. (sum of counts of all runs except the last) -
    the final trailing run is intentionally dropped, trimming the flanking
    free gap of the semi-global alignment (pinned by reference
    test-KmerGMA.jl:130-136)."""
    runs = result.cigar_runs
    if len(runs) <= 1:
        return (1, 0)
    lower = runs[0][0]
    num_sum = sum(c for c, _ in runs[:-1])
    return (lower + 1, num_sum)


def align_unitrange(
    seq: "str | bytes",
    start: int,
    stop: int,
    consensus: "str | bytes",
    windowsize: int,
    seq_len: int,
    gap_open: int = -69,
    gap_extend: int = -1,
    collector: "list | None" = None,
) -> tuple[int, int]:
    """Refine a buffered hit range by aligning the consensus into it and
    remapping the trimmed CIGAR range into sequence coordinates, clamped to
    [1, seq_len] (ref Alignment.jl:33-52).  ``start``/``stop`` are 1-based
    inclusive."""
    subject = seq[start - 1 : stop]
    query = consensus[:windowsize]
    res = semiglobal_align(query, subject, gap_open, gap_extend)
    if collector is not None:
        collector.append(res)
    lo, hi = cigar_to_unitrange(res)
    return (max(1, start + lo - 1), min(start + hi - 1, seq_len))
