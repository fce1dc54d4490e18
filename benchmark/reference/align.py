"""Semi-global affine-gap alignment and the CIGAR range that trims a hit.

Frozen copy of kmergma_tpu_torch/ops/align.py (``_NUC44``,
``semiglobal_align``, ``_traceback``, ``cigar_to_unitrange``) at commit
643846b: a Gotoh DP, global in the query (the consensus) with free end
gaps in the subject (the buffered hit window), scored with EDNAFULL as
BioAlignments' ``AffineGapScoreModel(EDNAFULL, ...)`` is in KmerGMA.jl
src/Alignment.jl; the traceback's tie rules are the ones pinned by the
upstream's golden alignments (test-KmerGMA.jl:128-152).
"""

from __future__ import annotations

import numpy as np
import torch

_IUPAC = "ATGCSWRYKMBVHDN"
_NUC44 = np.array(
    [
        [5, -4, -4, -4, -4, 1, 1, -4, -4, 1, -4, -1, -1, -1, -2],
        [-4, 5, -4, -4, -4, 1, -4, 1, 1, -4, -1, -4, -1, -1, -2],
        [-4, -4, 5, -4, 1, -4, 1, -4, 1, -4, -1, -1, -4, -1, -2],
        [-4, -4, -4, 5, 1, -4, -4, 1, -4, 1, -1, -1, -1, -4, -2],
        [-4, -4, 1, 1, -1, -4, -2, -2, -2, -2, -1, -1, -3, -3, -1],
        [1, 1, -4, -4, -4, -1, -2, -2, -2, -2, -3, -3, -1, -1, -1],
        [1, -4, 1, -4, -2, -2, -1, -4, -2, -2, -3, -1, -3, -1, -1],
        [-4, 1, -4, 1, -2, -2, -4, -1, -2, -2, -1, -3, -1, -3, -1],
        [-4, 1, 1, -4, -2, -2, -2, -2, -1, -4, -1, -3, -3, -1, -1],
        [1, -4, -4, 1, -2, -2, -2, -2, -4, -1, -3, -1, -1, -3, -1],
        [-4, -1, -1, -1, -1, -3, -3, -1, -1, -3, -1, -2, -2, -2, -1],
        [-1, -4, -1, -1, -1, -3, -1, -3, -3, -1, -2, -1, -2, -2, -1],
        [-1, -1, -4, -1, -3, -1, -3, -1, -3, -1, -2, -2, -1, -2, -1],
        [-1, -1, -1, -4, -3, -1, -1, -3, -1, -3, -2, -2, -2, -1, -1],
        [-2, -2, -2, -2, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    ],
    dtype=np.int64,
)

_CHAR_TO_IDX = np.full(256, -1, dtype=np.int64)
for _i, _c in enumerate(_IUPAC):
    _CHAR_TO_IDX[ord(_c)] = _i
    _CHAR_TO_IDX[ord(_c.lower())] = _i
_CHAR_TO_IDX[ord("U")] = _CHAR_TO_IDX[ord("u")] = _IUPAC.index("T")

NEG_INF = np.int64(-(2**40))


def _seq_to_idx(seq: "str | bytes") -> np.ndarray:
    raw = np.frombuffer(seq.encode() if isinstance(seq, str) else bytes(seq), dtype=np.uint8)
    idx = _CHAR_TO_IDX[raw]
    if idx.size and idx.min() < 0:
        raise ValueError(f"invalid IUPAC character {chr(int(raw[np.argmax(idx < 0)]))!r}")
    return idx


def semiglobal_align(query: "str | bytes", subject: "str | bytes", gap_open: int, gap_extend: int) -> list[tuple[int, str]]:
    """CIGAR runs [(count, op)] over ops '=', 'X', 'I', 'D' of ``query``
    aligned globally within ``subject``; a gap of length L costs
    gap_open + L * gap_extend."""
    a = _seq_to_idx(query)
    b = _seq_to_idx(subject)
    m, n = a.shape[0], b.shape[0]
    go, ge = np.int64(gap_open), np.int64(gap_extend)
    sub = _NUC44[a][:, b]
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    F = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    for i in range(1, m + 1):
        H[i, 0] = E[i, 0] = go + ge * i
    jj = np.arange(1, n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        E[i, 1:] = np.maximum(H[i - 1, 1:] + go + ge, E[i - 1, 1:] + ge)
        G = np.maximum(H[i - 1, :-1] + sub[i - 1], E[i, 1:])
        base = np.empty(n + 1, dtype=np.int64)
        base[0] = H[i, 0]
        base[1:] = G - ge * jj
        F[i, 1:] = go + ge * jj + np.maximum.accumulate(base[:-1])
        H[i, 1:] = np.maximum(G, F[i, 1:])
    return _traceback(a, b, sub, H, E, F, ge)


def semiglobal_align_many(pairs: list[tuple[str, str]], gap_open: int, gap_extend: int, device="cpu", batch: int = 64) -> list[list[tuple[int, str]]]:
    """``semiglobal_align`` of each (query, subject), written for the
    benchmark: the forward DP of up to ``batch`` pairs at a time in int32
    torch on ``device``, vectorised across them, then ``_traceback`` of each
    on the host.  Queries are padded below and subjects to the right, which
    leaves every cell of a pair's own (m + 1) x (n + 1) corner as it is,
    since a cell depends only on cells above and to its left."""
    out = []
    dev = torch.device(device)
    go, ge = int(gap_open), int(gap_extend)
    neg = -(2**30)
    for lo in range(0, len(pairs), batch):
        chunk = pairs[lo : lo + batch]
        qs = [_seq_to_idx(q) for q, _ in chunk]
        ss = [_seq_to_idx(t) for _, t in chunk]
        m, n, nb = max(q.size for q in qs), max(t.size for t in ss), len(chunk)
        a = np.full((nb, m), 14, dtype=np.int64)
        b = np.full((nb, n), 14, dtype=np.int64)
        for i, (q, t) in enumerate(zip(qs, ss)):
            a[i, : q.size] = q
            b[i, : t.size] = t
        sub_np = np.ascontiguousarray(_NUC44[a[:, :, None], b[:, None, :]].transpose(1, 0, 2))  # (m, nb, n)
        sub = torch.as_tensor(sub_np, dtype=torch.int32, device=dev)
        H = torch.zeros((m + 1, nb, n + 1), dtype=torch.int32, device=dev)
        E = torch.full((m + 1, nb, n + 1), neg, dtype=torch.int32, device=dev)
        F = torch.full((m + 1, nb, n + 1), neg, dtype=torch.int32, device=dev)
        col = go + ge * torch.arange(1, m + 1, dtype=torch.int32, device=dev)
        H[1:, :, 0] = col[:, None]
        E[1:, :, 0] = col[:, None]
        gejj = ge * torch.arange(1, n + 1, dtype=torch.int32, device=dev)
        base = torch.empty((nb, n + 1), dtype=torch.int32, device=dev)
        for i in range(1, m + 1):
            E[i, :, 1:] = torch.maximum(H[i - 1, :, 1:] + (go + ge), E[i - 1, :, 1:] + ge)
            G = torch.maximum(H[i - 1, :, :-1] + sub[i - 1], E[i, :, 1:])
            base[:, 0] = H[i, :, 0]
            base[:, 1:] = G - gejj
            F[i, :, 1:] = go + gejj + torch.cummax(base[:, :-1], dim=1).values
            H[i, :, 1:] = torch.maximum(G, F[i, :, 1:])
        Hh, Eh, Fh = (x.cpu().numpy() for x in (H, E, F))
        for k, (q, t) in enumerate(zip(qs, ss)):
            mq, nt = q.size, t.size
            out.append(_traceback(q, t, sub_np[:mq, k, :nt], Hh[: mq + 1, k, : nt + 1],
                                  Eh[: mq + 1, k, : nt + 1], Fh[: mq + 1, k, : nt + 1], ge))
    return out


def _traceback(a, b, sub, H, E, F, ge) -> list[tuple[int, str]]:
    """The last column attaining max H[m, :]; at H ties match or mismatch
    before 'D' before 'I'; inside a gap, extend before open."""
    m, n = a.shape[0], b.shape[0]
    j = int(n - np.argmax(H[m][::-1]))
    i = m
    ops: list[str] = ["D"] * (n - j)
    state = "H"
    while i > 0:
        if state == "H":
            if j > 0 and H[i, j] == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                ops.append("=" if a[i - 1] == b[j - 1] else "X")
                i -= 1
                j -= 1
            elif j > 0 and H[i, j] == F[i, j]:
                state = "F"
            elif H[i, j] == E[i, j]:
                state = "E"
            else:
                raise AssertionError("traceback: inconsistent H cell")
        elif state == "F":
            ops.append("D")
            if not (j > 1 and F[i, j] == F[i, j - 1] + ge):
                state = "H"
            j -= 1
        else:
            ops.append("I")
            if not (i > 1 and E[i, j] == E[i - 1, j] + ge):
                state = "H"
            i -= 1
    ops.extend("D" * j)
    runs: list[tuple[int, str]] = []
    for op in reversed(ops):
        if runs and runs[-1][1] == op:
            runs[-1] = (runs[-1][0] + 1, op)
        else:
            runs.append((1, op))
    return runs


def cigar_to_unitrange(runs: list[tuple[int, str]]) -> tuple[int, int]:
    """(first run's count + 1, sum of every run's count but the last):
    the subject range without the flanking free gaps (Alignment.jl:13-30)."""
    if len(runs) <= 1:
        return (1, 0)
    return (runs[0][0] + 1, sum(c for c, _ in runs[:-1]))
