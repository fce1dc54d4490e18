"""The device aligner (counterpart of ``kmergma_tpu.ops.align_device``):
a batched semi-global affine-gap DP whose traceback takes one step per
CIGAR run, bit-identical to ``ops/align.semiglobal_align``.

The forward pass is the JAX package's int32 row recurrence (running-max
F), and it also computes, for every cell, the decision the traceback would
take there and the length of that decision's run:

  * C[i,j]  - maximal diagonal chain: diag_ok ? 1 + C[i-1,j-1] : 0,
  * FL[i,j] - subject-gap run:  ext_f ? FL[i,j-1] + 1 : 1,
  * EL[i,j] - query-gap run:    ext_e ? EL[i-1,j] + 1 : 1,

packed as TL[i,j] = (runlen << 2) | op.  The traceback then jumps a whole
run per step from the endpoint, the LAST column attaining the maximum of
H[m] (match > D > I at ties, extend over open inside gaps, as
``_traceback``), and writes the runs (traceback order) into ``RLE_CAP``
slots.  The host expands diagonal runs into =/X per cell (``_decode_rle``).
All of it is integer arithmetic, so the device and the host agree exactly.

``align_dp`` launches A1, the hand-written CUDA kernel of
``csrc/align_dp.cu``, on CUDA tensors and runs the plain PyTorch twins
(``_forward_tl_plain`` and ``_traceback_rle_plain``, the JAX scan and
while loop) on CPU tensors; any other device raises.

Source note (A1).  Replaces the jitted XLA of
``kmergma_tpu/ops/align_device.py`` (``_forward_tl``, ``_traceback_rle_one``,
``_get_jit().run``); the JAX package has no Pallas kernel for it.  As torch
ops the DP would be some 25 launches a query row.  A1 takes one CUDA block
(one warp) a subject and walks the query rows in it; each lane keeps 16
columns of the previous row's H, E, C and EL in registers (a subject of up
to 511 letters is one tile of 512 columns; longer ones walk the tiles with
the rows in device scratch), and F's running maximum and FL's last break
are warp max-scans by shuffle.  Every cell's TL goes to device memory once
and is read back only along the path: those bytes bound it on an H100.
One launch takes subjects of every length; the batch is cut so that TL
stays within ``TL_BUDGET_BYTES``.
"""

from __future__ import annotations

import numpy as np
import torch

from .align import _NUC44, AlignResult, _seq_to_idx
from .scan import resolve_device

_OPS = "=XID"
NEG = -(2**30)
#: CIGAR runs a hit keeps on the first A1 pass; hits with more run A1
#: again together, at the next power of two at or above their most runs
RLE_CAP = 256
#: A1's traceback matrix per launch: the batch is cut into launches that
#: stay within it (about 1,100 windows of 389 x 290)
TL_BUDGET_BYTES = 512 << 20
#: A1's tile: 32 lanes of 16 columns
_TILE_COLS = 512


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
    """A1's launches: consecutive ranges [lo, hi) of subjects whose TL (m
    rows of n + 1 columns, rounded up to 4, int32) stays within ``budget``
    bytes; a subject alone above it takes a launch of its own."""
    groups, lo, used = [], 0, 0
    for i, n in enumerate(lengths):
        need = 4 * m * (-(-(int(n) + 1) // 4) * 4)
        if i > lo and used + need > budget:
            groups.append((lo, i))
            lo, used = i, 0
        used += need
    groups.append((lo, len(lengths)))
    return groups


def align_dp(a_sub: torch.Tensor, b_flat: torch.Tensor, lengths: list, go: int, ge: int, cap: "int | None" = None):
    """Scores, run-length tracebacks and endpoints of one query against a
    batch of subjects: what the JAX ``_get_jit().run`` gives.

    a_sub: int32[m, 15], the NUC44 rows of the query letters; b_flat:
    int8[sum(lengths)], the subjects' letter indices end to end; lengths:
    the subjects' lengths; cap: the runs kept a subject (``RLE_CAP`` when
    None).  Returns (scores int32[B], rle int32[B, cap], n_runs int32[B],
    j0 int32[B]).  Launches A1 on CUDA tensors, once per
    ``TL_BUDGET_BYTES`` of traceback matrix, and runs the plain twin on CPU
    tensors."""
    cap = RLE_CAP if cap is None else int(cap)
    lengths = [int(n) for n in lengths]
    if a_sub.dim() != 2 or a_sub.shape[1] != 15 or a_sub.dtype != torch.int32:
        raise ValueError(f"align_dp wants int32[m, 15] NUC44 rows, got {a_sub.dtype}{tuple(a_sub.shape)}")
    if b_flat.dim() != 1 or b_flat.dtype != torch.int8 or b_flat.shape[0] != sum(lengths) or min(lengths, default=0) < 0:
        raise ValueError(f"align_dp wants int8[{sum(lengths)}] subject letters, got {b_flat.dtype}{tuple(b_flat.shape)}")
    if cap < 1 or a_sub.device != b_flat.device:
        raise ValueError(f"align_dp: RLE_CAP {cap}, query on {a_sub.device}, subjects on {b_flat.device}")
    if b_flat.device.type == "cpu":
        return _align_dp_plain(a_sub, b_flat, lengths, go, ge, cap)
    if b_flat.device.type != "cuda":
        raise ValueError(f"align_dp: unsupported device {b_flat.device}")
    from .._kernels import check, load

    lib = load()
    dev = b_flat.device
    B, m = len(lengths), a_sub.shape[0]
    a_sub, b_flat = a_sub.contiguous(), b_flat.contiguous()
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    rle = torch.empty((B, cap), dtype=torch.int32, device=dev)
    n_runs = torch.empty(B, dtype=torch.int32, device=dev)
    j0 = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return scores, rle, n_runs, j0
    b_off = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    cols = np.array([-(-(n + 1) // 4) * 4 for n in lengths], dtype=np.int64)
    groups = _launch_groups(lengths, m, TL_BUDGET_BYTES)
    tl = torch.empty(max(m * int(cols[lo:hi].sum()) for lo, hi in groups), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi in groups:
            col_off = np.concatenate([[0], np.cumsum(cols[lo:hi])])
            offs = torch.from_numpy(np.stack([b_off[lo : hi + 1], col_off])).to(dev)
            # rows of the subjects longer than one tile live in device scratch
            wide = max(lengths[lo:hi]) + 1 > _TILE_COLS
            scratch = torch.empty(4 * int(col_off[-1]), dtype=torch.int32, device=dev) if wide else None
            check(
                lib.kmg_align_dp(
                    a_sub.data_ptr(), m, b_flat.data_ptr(), offs[0].data_ptr(), offs[1].data_ptr(), hi - lo,
                    int(go), int(ge), cap, tl.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                    scores[lo:].data_ptr(), rle[lo:].data_ptr(), n_runs[lo:].data_ptr(), j0[lo:].data_ptr(), stream,
                ),
                "align_dp",
            )
            align_dp.launches += 1
    return scores, rle, n_runs, j0


#: A1 launches since the count was last set to 0
align_dp.launches = 0


def _decode_rle(entries, m, n, a_np, b_np):
    """Expand device RLE runs (traceback order) into AlignResult cigar
    runs: per-cell codes in traceback order plus the leading free-gap Ds,
    reversed and merged.  The walk starts at (m, n); the trailing free-gap
    run (entry 0 when j0 < n) is an ordinary D run that brings j to the
    alignment endpoint."""
    cells = []
    i, j = m, n
    for v in entries:
        t, op = int(v) >> 2, int(v) & 3
        if op == 0:
            eq = (a_np[i - t : i] == b_np[j - t : j])[::-1]
            cells.append(np.where(eq, 0, 1).astype(np.int8))
            i -= t
            j -= t
        elif op == 3:
            cells.append(np.full(t, 3, dtype=np.int8))
            j -= t
        else:
            cells.append(np.full(t, 2, dtype=np.int8))
            i -= t
    cells.append(np.full(j, 3, dtype=np.int8))  # leading free subject gap
    full = np.concatenate(cells) if cells else np.zeros(0, dtype=np.int8)
    runs: list[tuple[int, str]] = []
    for op_code in full[::-1]:
        op = _OPS[int(op_code)]
        if runs and runs[-1][1] == op:
            runs[-1] = (runs[-1][0] + 1, op)
        else:
            runs.append((1, op))
    return runs


def semiglobal_align_device(
    query: "str | bytes",
    subjects: "list[str | bytes]",
    gap_open: int = -69,
    gap_extend: int = -1,
    device: "str | torch.device" = "cuda",
) -> "list[AlignResult]":
    """Device-batched ``semiglobal_align``, bit-identical results.

    Runs A1 on ``device`` (the card unless the caller asks for the CPU,
    where the plain twins run; a CUDA device without CUDA raises).  Hits
    whose traceback has more than ``RLE_CAP`` runs run A1 again together,
    on the same device, with room for the most runs among them (the JAX
    package sends them to the host DP instead); they are counted on
    ``semiglobal_align_device.overflowed``."""
    if not subjects:
        return []
    dev = resolve_device(device)
    a = _seq_to_idx(query)
    bs = [_seq_to_idx(s) for s in subjects]
    m = a.shape[0]
    a_np = a.astype(np.int32)
    a_sub = torch.as_tensor(_NUC44[a].astype(np.int32).reshape(m, 15), device=dev)
    out: list[AlignResult | None] = [None] * len(subjects)
    todo, cap = list(range(len(subjects))), None
    while todo:
        b_flat = torch.as_tensor(np.concatenate([bs[i] for i in todo]).astype(np.int8), device=dev)
        dp = align_dp(a_sub, b_flat, [bs[i].shape[0] for i in todo], gap_open, gap_extend, cap)
        scores, rle, n_runs, _j0 = (x.cpu().numpy() for x in dp)
        over = [k for k in range(len(todo)) if n_runs[k] > rle.shape[1]]
        for k, i in enumerate(todo):
            if n_runs[k] <= rle.shape[1]:
                runs = _decode_rle(rle[k, : int(n_runs[k])], m, bs[i].shape[0], a_np, bs[i].astype(np.int32))
                out[i] = AlignResult(score=int(scores[k]), cigar_runs=runs)
        if over:
            # the run-count overflow: one more A1 pass with room for every run
            semiglobal_align_device.overflowed += len(over)
            cap = 1 << (int(n_runs[over].max()) - 1).bit_length()
        todo = [todo[k] for k in over]
    return out  # type: ignore[return-value]


#: hits that ran A1 a second time for a run count past ``RLE_CAP`` since
#: the count was last set to 0
semiglobal_align_device.overflowed = 0
