"""The device aligner (counterpart of ``kmergma_tpu.ops.align_device``):
a batched semi-global affine-gap DP and traceback, bit-identical to
``ops/align.semiglobal_align``.

The JAX package's forward pass is an int32 row recurrence (running-max F)
that also computes, for every cell, the decision the traceback would take
there and the length of that decision's run:

  * C[i,j]  - maximal diagonal chain: diag_ok ? 1 + C[i-1,j-1] : 0,
  * FL[i,j] - subject-gap run:  ext_f ? FL[i,j-1] + 1 : 1,
  * EL[i,j] - query-gap run:    ext_e ? EL[i-1,j] + 1 : 1,

packed as TL[i,j] = (runlen << 2) | op.  Its traceback jumps a whole run
per step from the endpoint, the LAST column attaining the maximum of H[m]
(match > D > I at ties, extend over open inside gaps, as ``_traceback``),
and writes the runs (traceback order) into ``RLE_CAP`` slots; the host
expands diagonal runs into =/X per cell (its ``_decode_rle``).  The plain twins
here (``_forward_tl_plain``, ``_traceback_rle_plain``, ``_align_dp_plain``)
are that computation in torch; ``_align_cigar_plain`` expands their runs
into CIGAR runs.  All of it is integer arithmetic, so the device and the
host agree exactly.

A1, the hand-written CUDA kernel of ``csrc/align_dp.cu``, keeps 4 decision
bits a cell instead of TL (diag_ok, f_ok, ext_e, ext_f: the same path, a
run being a chain of them) and walks them cell by cell, so one launch gives
both the JAX runs (``align_dp``) and the final CIGAR runs with = / X
(``align_cigar``).  Either wrapper launches A1 on CUDA tensors and runs the
plain twins on CPU tensors; any other device raises.

Source note (A1).  Replaces the jitted XLA of
``kmergma_tpu/ops/align_device.py`` (``_forward_tl``, ``_traceback_rle_one``,
``_get_jit().run``); the JAX package has no Pallas kernel for it.  As torch
ops the DP would be some 25 launches a query row.  A1 takes one warp a
subject; each lane owns a band of query rows and walks the subject's
columns one step behind the lane above it, E down the band and F along
each row in registers, the decisions of the subject in shared memory (a
subject whose block would need more than ``SMEM_BUDGET_BYTES`` keeps them
in device memory, in launches of at most ``TL_BUDGET_BYTES``).  It is
bound by its integer operations; what it moves is the letters and the runs.
"""

from __future__ import annotations

import numpy as np
import torch

from .align import _NUC44, AlignResult, _seq_to_idx
from .scan import resolve_device

_OPS = "=XID"
_OP_CHARS = np.array(list(_OPS))
NEG = -(2**30)
#: runs a hit keeps on the first A1 pass; hits with more run A1 again
#: together, at the next power of two at or above their most runs
RLE_CAP = 256
#: a subject whose A1 block would need more shared memory than this keeps
#: its decisions in device memory (two blocks of this size share an SM)
SMEM_BUDGET_BYTES = 112 << 10
#: A1's decisions in device memory per launch (4 bits a cell): the
#: subjects past ``SMEM_BUDGET_BYTES`` are cut into launches within it
TL_BUDGET_BYTES = 512 << 20
#: A1's lanes, the most query rows a lane owns, and the profile's letters
_LANES, _R_MAX, _LETTERS = 32, 16, 15


def _rows_per_lane(m: int, lanes: int = _LANES, r_max: int = _R_MAX) -> int:
    """A1's band: ceil(m / lanes) rows a lane, rounded up to 1 or an even
    count, at most ``r_max`` (longer queries go in strips of lanes x R)."""
    need = -(-m // lanes)
    return 1 if need <= 1 else min(r_max, need + (need & 1))


def _r16(x):
    return (x + 15) // 16 * 16


def _layout(m: int):
    """(rows a lane, strips, profile stride, decision row pitch) of A1 for a
    query of ``m`` letters, as ``layout()`` in ``csrc/align_dp.cu``."""
    r = _rows_per_lane(m)
    strips = -(-m // (_LANES * r))
    first = min(m, _LANES * r)
    return r, strips, (-(-first // r) * r + 1) & ~1, (-(-m // r) * r) | 1


def _smem_bytes(m: int, n) -> "int | np.ndarray":
    """Dynamic shared memory of A1's block for a subject of ``n`` letters
    (an int or an array): the strip's query profile int32[15][stride], the
    two sequences' letters, two strip buffers of H and E past one strip,
    and the decisions, uint32[ceil((n + 1) / 8)][pitch]."""
    _r, strips, stride, pitch = _layout(m)
    n = np.asarray(n, dtype=np.int64)
    out = 4 * _LETTERS * stride + _r16(m) + _r16(n) + (16 * (n + 1) if strips > 1 else 0) + 4 * pitch * ((n + 8) // 8)
    return out if out.ndim else int(out)


def _global_words(m: int, n: int) -> int:
    """32-bit words of A1's device-memory layout for a subject of ``n``
    letters: the decisions, 8 cells a word, then the strip buffers."""
    _r, strips, _stride, pitch = _layout(m)
    return pitch * ((n + 8) // 8) + (4 * (n + 1) if strips > 1 else 0)


def _forward_tl_plain(a_sub: torch.Tensor, bmat: torch.Tensor, go: int, ge: int):
    """The forward DP emitting the packed traceback run matrix (the JAX
    ``_forward_tl``, vectorised over the batch).

    a_sub: int32[m, 15], the NUC44 rows of the query letters; bmat:
    int32[B, n] subject letter indices.  Returns (H_last int32[B, n+1], TL
    int32[m, B, n+1]), the JAX layout."""
    m = a_sub.shape[0]
    B, n = bmat.shape
    dev = bmat.device
    i32 = torch.int32
    subs = a_sub[:, bmat.long()]  # (m, B, n): a gather, where the TPU took a one-hot product
    jj = torch.arange(1, n + 1, dtype=i32, device=dev)[None, :]
    jpos = torch.arange(n + 1, dtype=i32, device=dev)[None, :]
    neg = torch.full((B, 1), NEG, dtype=i32, device=dev)
    zero = torch.zeros((B, 1), dtype=i32, device=dev)
    H = torch.zeros((B, n + 1), dtype=i32, device=dev)
    E = torch.full((B, n + 1), NEG, dtype=i32, device=dev)
    C = torch.zeros((B, n + 1), dtype=i32, device=dev)
    EL = torch.zeros((B, n + 1), dtype=i32, device=dev)
    TL = torch.empty((m, B, n + 1), dtype=i32, device=dev)
    for i in range(1, m + 1):
        col = torch.full((B, 1), go + ge * i, dtype=i32, device=dev)
        sub_i = subs[i - 1]
        E_i1 = torch.maximum(H[:, 1:] + (go + ge), E[:, 1:] + ge)
        G = torch.maximum(H[:, :-1] + sub_i, E_i1)
        base = torch.cat([col, G - ge * jj], dim=1)
        run = torch.cummax(base[:, :-1], dim=1).values
        F_i1 = (go + ge * jj) + run
        H_i = torch.cat([col, torch.maximum(G, F_i1)], dim=1)
        E_i = torch.cat([col, E_i1], dim=1)
        F_i = torch.cat([neg, F_i1], dim=1)
        # the traceback's decisions and run lengths at every cell of row i
        diag_ok = (jpos > 0) & (H_i == torch.cat([neg, H[:, :-1]], dim=1) + torch.cat([zero, sub_i], dim=1))
        f_ok = (jpos > 0) & (H_i == F_i)
        C_i = torch.where(diag_ok, torch.cat([zero, C[:, :-1]], dim=1) + 1, 0)
        EL_i = torch.where(E_i == E + ge, EL + 1, 1) if i > 1 else torch.ones_like(EL)
        ext_f = (jpos > 1) & (F_i == torch.cat([neg, F_i[:, :-1]], dim=1) + ge)
        last_brk = torch.cummax(torch.where(ext_f, -1, jpos), dim=1).values
        FL_i = jpos - last_brk + 1
        TL[i - 1] = torch.where(diag_ok, C_i << 2, torch.where(f_ok, (FL_i << 2) | 3, (EL_i << 2) | 2))
        H, E, C, EL = H_i, E_i, C_i, EL_i
    return H, TL


def _traceback_rle_plain(TL: torch.Tensor, j0: torch.Tensor, m: int, n: int, cap: int):
    """The run-length traceback of every subject from the packed TL matrix
    (the JAX ``_traceback_rle_one``, vectorised over the batch).

    TL: int32[m, B, n+1]; j0: int32[B] endpoints.  Returns (rle
    int32[B, cap], n_runs int32[B]): entries are (len << 2) | op in
    traceback order, entry 0 the trailing free subject gap; a run past the
    cap overwrites the last slot, and n_runs counts every run."""
    B = j0.shape[0]
    dev = j0.device
    lead = (n - j0).to(torch.int32)
    rle = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    rle[:, 0] = (lead << 2) | 3
    pos = (lead > 0).to(torch.int32)
    i = torch.full((B,), m, dtype=torch.int32, device=dev)
    j = j0.to(torch.int32).clone()
    rows = torch.arange(B, device=dev)
    while True:
        act = i > 0
        if not bool(act.any()):
            break
        v = TL[(i - 1).clamp(min=0).long(), rows, j.long()]
        t, op = v >> 2, v & 3
        live = rows[act]
        rle[live, pos[act].clamp(max=cap - 1).long()] = v[act]
        i = torch.where(act, i - torch.where(op == 3, 0, t), i)
        j = torch.where(act, j - torch.where(op == 2, 0, t), j)
        pos = torch.where(act, pos + 1, pos)
    return rle, pos


def _align_dp_plain(a_sub: torch.Tensor, b_flat: torch.Tensor, lengths: list, go: int, ge: int, cap: int):
    """The plain twin of A1: subjects grouped by length, each group
    through ``_forward_tl_plain`` and ``_traceback_rle_plain`` (as the JAX
    ``_get_jit().run``).  Returns (scores, rle, n_runs, j0) as ``align_dp``."""
    dev = b_flat.device
    B = len(lengths)
    m = a_sub.shape[0]
    offs = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    rle = torch.empty((B, cap), dtype=torch.int32, device=dev)
    n_runs = torch.empty(B, dtype=torch.int32, device=dev)
    j0 = torch.empty(B, dtype=torch.int32, device=dev)
    by_len: dict[int, list[int]] = {}
    for i, n in enumerate(lengths):
        by_len.setdefault(int(n), []).append(i)
    for n, idxs in by_len.items():
        sel = torch.as_tensor(idxs, device=dev)
        starts = torch.as_tensor(offs[idxs], device=dev)
        bmat = b_flat[starts[:, None] + torch.arange(n, device=dev)[None, :]].to(torch.int32)
        H_last, TL = _forward_tl_plain(a_sub, bmat, go, ge)
        # the endpoint: the LAST column attaining the maximum
        j_end = (n - torch.argmax(H_last.flip(1), dim=1)).to(torch.int32)
        r, nr = _traceback_rle_plain(TL, j_end, m, n, cap)
        scores[sel] = H_last.max(dim=1).values
        rle[sel], n_runs[sel], j0[sel] = r, nr, j_end
    return scores, rle, n_runs, j0


def _launch_groups(lengths: list, m: int, budget: int) -> list:
    """A1's device-memory launches: consecutive ranges [lo, hi) of subjects
    whose decisions (4 bits a cell, ``_global_words``) stay within
    ``budget`` bytes; a subject alone above it takes a launch of its own."""
    groups, lo, used = [], 0, 0
    for i, n in enumerate(lengths):
        need = 4 * _global_words(m, int(n))
        if i > lo and used + need > budget:
            groups.append((lo, i))
            lo, used = i, 0
        used += need
    groups.append((lo, len(lengths)))
    return groups


def _check_inputs(what: str, a_sub: torch.Tensor, b_flat: torch.Tensor, lengths: list, cap: int) -> None:
    if a_sub.dim() != 2 or a_sub.shape[1] != 15 or a_sub.dtype != torch.int32:
        raise ValueError(f"{what} wants int32[m, 15] NUC44 rows, got {a_sub.dtype}{tuple(a_sub.shape)}")
    if b_flat.dim() != 1 or b_flat.dtype != torch.int8 or b_flat.shape[0] != sum(lengths) or min(lengths, default=0) < 0:
        raise ValueError(f"{what} wants int8[{sum(lengths)}] subject letters, got {b_flat.dtype}{tuple(b_flat.shape)}")
    if cap < 1 or a_sub.device != b_flat.device:
        raise ValueError(f"{what}: RLE_CAP {cap}, query on {a_sub.device}, subjects on {b_flat.device}")
    if b_flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {b_flat.device}")


def _launch_plan(lengths: list, m: int) -> list:
    """A1's launches for subjects of these lengths against a query of m
    letters: [(subjects, word offsets or None)].  Subjects whose block fits
    ``SMEM_BUDGET_BYTES`` go in one launch with their decisions in shared
    memory (offsets None), the rest in launches of at most
    ``TL_BUDGET_BYTES`` of decisions in device memory, each subject at its
    word offset there."""
    lens = np.asarray(lengths, dtype=np.int64)
    fits = _smem_bytes(m, lens) <= SMEM_BUDGET_BYTES
    small, big = np.flatnonzero(fits), np.flatnonzero(~fits)
    plan = [(small, None)] if small.size else []
    for lo, hi in _launch_groups(lens[big].tolist(), m, TL_BUDGET_BYTES) if big.size else []:
        sel = big[lo:hi]
        words = np.array([_global_words(m, int(n)) for n in lens[sel]], dtype=np.int64)
        plan.append((sel, np.cumsum(words) - words))
    return plan


def _launch_a1(a_sub, a_idx, b_flat, lengths: list, go: int, ge: int, cap: int, rle: bool, cigar: bool):
    """A1 on the card, launched as ``_launch_plan`` says: (rle rows, cigar
    rows), each int32[B, 3 + cap] (score, run count, endpoint, then the
    runs) or None where not asked."""
    from .._kernels import check, load

    lib = load()
    dev = b_flat.device
    B, m = len(lengths), a_sub.shape[0]
    outs = [torch.empty((B, 3 + cap), dtype=torch.int32, device=dev) if want else None for want in (rle, cigar)]
    if B == 0:
        return outs
    lens = np.asarray(lengths, dtype=np.int64)
    plan = _launch_plan(lengths, m)
    # one int64 upload: the subject offsets, then each launch's subjects (and word offsets)
    parts = [np.concatenate([[0], np.cumsum(lens)])]
    for sel, woff in plan:
        parts += [sel] if woff is None else [sel, woff]
    # pinned, so the copy queues behind the card's work instead of waiting for it
    flat = torch.from_numpy(np.concatenate(parts).astype(np.int64)).pin_memory().to(dev, non_blocking=True)
    dec_words = max((int(woff[-1]) + _global_words(m, int(lens[sel[-1]])) for sel, woff in plan if woff is not None),
                    default=0)
    dec = torch.empty(dec_words, dtype=torch.int32, device=dev) if dec_words else None
    a_sub, b_flat = a_sub.contiguous(), b_flat.contiguous()
    a_idx = a_idx.contiguous() if a_idx is not None else None
    at = B + 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for sel, woff in plan:
            sel_ptr = flat[at:].data_ptr()
            at += sel.size
            woff_ptr = 0
            if woff is not None:
                woff_ptr = flat[at:].data_ptr()
                at += sel.size
            check(
                lib.kmg_align_dp(
                    a_sub.data_ptr(), 0 if a_idx is None else a_idx.data_ptr(), m, b_flat.data_ptr(), flat.data_ptr(),
                    sel_ptr, woff_ptr, sel.size, int(lens[sel].max()), int(go), int(ge), cap,
                    0 if dec is None else dec.data_ptr(), *(0 if o is None else o.data_ptr() for o in outs), stream,
                ),
                "align_dp",
            )
            align_dp.launches += 1
    return outs


def align_dp(a_sub: torch.Tensor, b_flat: torch.Tensor, lengths: list, go: int, ge: int, cap: "int | None" = None):
    """Scores, run-length tracebacks and endpoints of one query against a
    batch of subjects: what the JAX ``_get_jit().run`` gives.

    a_sub: int32[m, 15], the NUC44 rows of the query letters; b_flat:
    int8[sum(lengths)], the subjects' letter indices end to end; lengths:
    the subjects' lengths; cap: the runs kept a subject (``RLE_CAP`` when
    None).  Returns (scores int32[B], rle int32[B, cap], n_runs int32[B],
    j0 int32[B]).  Launches A1 on CUDA tensors (once, or more past
    ``SMEM_BUDGET_BYTES``; counted on ``align_dp.launches``) and runs the
    plain twin on CPU tensors."""
    cap = RLE_CAP if cap is None else int(cap)
    lengths = [int(n) for n in lengths]
    _check_inputs("align_dp", a_sub, b_flat, lengths, cap)
    if b_flat.device.type == "cpu":
        return _align_dp_plain(a_sub, b_flat, lengths, go, ge, cap)
    rows, _ = _launch_a1(a_sub, None, b_flat, lengths, go, ge, cap, rle=True, cigar=False)
    return rows[:, 0], rows[:, 3:], rows[:, 1], rows[:, 2]


#: A1 launches (by ``align_dp`` or ``align_cigar``) since the count was last set to 0
align_dp.launches = 0


def align_cigar(a_sub: torch.Tensor, a_idx: torch.Tensor, b_flat: torch.Tensor, lengths: list, go: int, ge: int,
                cap: "int | None" = None):
    """Scores, CIGAR runs and endpoints of one query against a batch of
    subjects, from one A1 launch.

    As ``align_dp``, with a_idx int8[m], the query's letter indices (a
    diagonal cell is = where its two letters are equal, else X).  Returns
    (scores int32[B], cigar int32[B, cap], n_cigar int32[B], j0 int32[B]):
    the runs as (len << 2) | op, op indexing "=XID", in traceback order
    (reverse them for the alignment's order), the free end gaps included,
    merged wherever two runs of one op meet; a run past the cap overwrites
    the last slot, and n_cigar counts every run.  The four are views of
    one int32[B, 3 + cap] tensor (``_rows``), so one copy brings them to
    the host.  Launches A1 on CUDA tensors and runs ``_align_cigar_plain``
    on CPU tensors."""
    cap = RLE_CAP if cap is None else int(cap)
    lengths = [int(n) for n in lengths]
    _check_inputs("align_cigar", a_sub, b_flat, lengths, cap)
    if a_idx.dim() != 1 or a_idx.dtype != torch.int8 or a_idx.shape[0] != a_sub.shape[0] or a_idx.device != b_flat.device:
        raise ValueError(f"align_cigar wants int8[{a_sub.shape[0]}] query letters on {b_flat.device}, got "
                         f"{a_idx.dtype}{tuple(a_idx.shape)} on {a_idx.device}")
    if b_flat.device.type == "cpu":
        rows = _align_cigar_plain(a_sub, a_idx, b_flat, lengths, go, ge, cap)
    else:
        _, rows = _launch_a1(a_sub, a_idx, b_flat, lengths, go, ge, cap, rle=False, cigar=True)
    return rows[:, 0], rows[:, 3:], rows[:, 1], rows[:, 2]


def _rows(scores: torch.Tensor, cap: int) -> torch.Tensor:
    """The int32[B, 3 + cap] tensor whose first column is ``scores`` (the
    outputs of ``align_cigar`` are its views)."""
    return scores.as_strided((scores.shape[0], 3 + cap), (3 + cap, 1))


def _cigar_codes(entries, m: int, n: int, a_np, b_np) -> np.ndarray:
    """The CIGAR runs of one subject's RLE entries as (len << 2) | op
    ("=XID"), in traceback order: the JAX package's ``_decode_rle``
    emitting codes."""
    cells = []
    i, j = m, n
    for v in entries:
        t, op = int(v) >> 2, int(v) & 3
        if op == 0:
            cells.append(np.where(a_np[i - t : i] == b_np[j - t : j], 0, 1)[::-1])
            i, j = i - t, j - t
        elif op == 3:
            cells.append(np.full(t, 3))
            j -= t
        else:
            cells.append(np.full(t, 2))
            i -= t
    cells.append(np.full(j, 3))  # leading free subject gap
    full = np.concatenate(cells).astype(np.int64)
    if not full.size:
        return full
    starts = np.flatnonzero(np.diff(full, prepend=-1))
    lens = np.diff(np.append(starts, full.size))
    return (lens << 2) | full[starts]


def _align_cigar_plain(a_sub, a_idx, b_flat, lengths: list, go: int, ge: int, cap: int) -> torch.Tensor:
    """The plain twin of A1's CIGAR output: ``_align_dp_plain`` with room
    for every run (each moves i or j), each subject's runs expanded by
    ``_cigar_codes`` and kept as A1 keeps them.  Returns the int32[B, 3 +
    cap] rows (score, run count, endpoint, runs)."""
    B, m = len(lengths), a_sub.shape[0]
    rows = np.zeros((B, 3 + cap), dtype=np.int32)
    if B:
        full_cap = m + max(lengths) + 1
        scores, rle, n_runs, j0 = (x.cpu().numpy() for x in _align_dp_plain(a_sub, b_flat, lengths, go, ge, full_cap))
        a_np, b_np = a_idx.cpu().numpy(), b_flat.cpu().numpy()
        offs = np.concatenate([[0], np.cumsum(lengths)])
        for k, n in enumerate(lengths):
            codes = _cigar_codes(rle[k, : n_runs[k]], m, n, a_np, b_np[offs[k] : offs[k + 1]])
            kept = codes[:cap].copy()
            if codes.size > cap:
                kept[-1] = codes[-1]
            rows[k, :3] = scores[k], codes.size, j0[k]
            rows[k, 3 : 3 + kept.size] = kept
    return torch.from_numpy(rows).to(b_flat.device)


def _letters(query: "str | bytes", subjects: list):
    """(query letters, all subjects' letters end to end, lengths): one
    translation over the joined bytes."""
    raw = [s.encode() if isinstance(s, str) else bytes(s) for s in subjects]
    return _seq_to_idx(query), _seq_to_idx(b"".join(raw)), [len(r) for r in raw]


def _to_device(a: np.ndarray, b_flat: np.ndarray, dev):
    """A1's inputs on ``dev``: (a_sub int32[m, 15], a_idx int8[m], b_flat int8)."""
    a_sub = torch.as_tensor(_NUC44[a].astype(np.int32).reshape(-1, 15), device=dev)
    return a_sub, torch.as_tensor(a.astype(np.int8), device=dev), torch.as_tensor(b_flat.astype(np.int8), device=dev)


def _results(rows: np.ndarray) -> list:
    """AlignResults from the host copy of ``align_cigar``'s rows (reversed
    into the alignment's order); None for a row whose runs passed the cap."""
    cap = rows.shape[1] - 3
    counts = rows[:, 1].astype(np.int64)
    ok = counts <= cap
    n = np.where(ok, counts, 0)
    ends = np.cumsum(n)
    k = np.repeat(np.arange(rows.shape[0]), n)
    # each row's runs from the last written to the first
    col = 2 + np.repeat(ends, n) - np.arange(ends[-1] if n.size else 0)
    codes = rows[k, col]
    runs = list(zip((codes >> 2).tolist(), _OP_CHARS[codes & 3].tolist()))
    starts = ends - n
    return [AlignResult(score=int(rows[i, 0]), cigar_runs=runs[starts[i] : ends[i]]) if ok[i] else None
            for i in range(rows.shape[0])]


def semiglobal_align_device(
    query: "str | bytes",
    subjects: "list[str | bytes]",
    gap_open: int = -69,
    gap_extend: int = -1,
    *,
    device: "str | torch.device" = "cuda",
) -> "list[AlignResult]":
    """Device-batched ``semiglobal_align``, bit-identical results.

    Runs A1 (``align_cigar``) on ``device`` (the card unless the caller
    asks for the CPU, where the plain twins run; a CUDA device without CUDA
    raises) and builds the AlignResults from its CIGAR runs.  Hits with
    more than ``RLE_CAP`` CIGAR runs run A1 again together, on the same
    device, with room for the most runs among them (the JAX package sends
    them to the host DP instead); they are counted on
    ``semiglobal_align_device.overflowed``."""
    if not subjects:
        return []
    dev = resolve_device(device)
    a, b_flat, lengths = _letters(query, subjects)
    a_sub, a_idx, b_dev = _to_device(a, b_flat, dev)
    offs = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    out: list[AlignResult | None] = [None] * len(subjects)
    todo, cap = list(range(len(subjects))), None
    while todo:
        if len(todo) < len(subjects):
            b_dev = torch.as_tensor(np.concatenate([b_flat[offs[i] : offs[i + 1]] for i in todo]).astype(np.int8),
                                    device=dev)
        scores, cigar, _n, _j0 = align_cigar(a_sub, a_idx, b_dev, [lengths[i] for i in todo], gap_open, gap_extend, cap)
        rows = _rows(scores, cigar.shape[1]).cpu().numpy()
        over = []
        for k, res in enumerate(_results(rows)):
            if res is None:
                over.append(k)
            else:
                out[todo[k]] = res
        if over:
            # the run-count overflow: one more A1 pass with room for every run
            semiglobal_align_device.overflowed += len(over)
            cap = 1 << (int(rows[over, 1].max()) - 1).bit_length()
        todo = [todo[k] for k in over]
    return out  # type: ignore[return-value]


#: hits that ran A1 a second time for a run count past ``RLE_CAP`` since
#: the count was last set to 0
semiglobal_align_device.overflowed = 0
