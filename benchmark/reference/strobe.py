"""KmerGMA's randstrobe search, ``Strobemer_findGenes`` (KmerGMA.jl v0.5.2
src/StrobemerGMA/StrobeGenomeMiner.jl:119-158), worked out again from the
FASTA file and the reference set, with the interface of ``kmergma.py``:
``find_hits_many(entry, kwargs, genome_paths, ref_path, device, precision)``
and ``windowsizes(entry, kwargs, ref_path)``.

Written for the benchmark from the upstream's code, not from the program:

- the randstrobe at each position (``get_strobe_2_mer``, Strobemers.jl:45-65):
  the first strobe is the s-mer at the position, the second the s-mer at
  the 1-based offset j in [w_min, w_max] whose score (u(first) + u(second))
  mod q is at most ``min_score``, tried in order of j.  ``min_score``
  starts at ``2 << 63``, which Julia's Int64 wraps to 0, so only a score of
  0 takes it, the last such j wins, and w_min stands where none does.  The
  2s-mer's code is u(first) 4^s + u(second), ``as_UInt`` of its letters;
- the reference spectrum (StrobeRefGen.jl:4-43): the strobemer counts of
  every reference summed, over the number of references r, with the
  windowsize ws and consensus that ``gen_ref_ws_cons`` gives (``prep.py``);
- the count vector c that ``StrobeGMA!`` carries (StrobeGenomeMiner.jl:
  48-90): it starts as the counts of the record's strobemers at positions
  0 .. ws - k, one more than its rolling width w = ws - k; step i, for
  1 <= i <= n - ws - 1, takes out the strobemer l at position i - 1 and puts
  in the one e at i - 1 + w (the upstream's right anchor, one short of the
  window's end), and where l != e adds to the scaled distance
  ||r c - S||^2 its change 2 r^2 (c[e] - c[l] + 1) - 2 r (S[e] - S[l]).  So
  x*, the strobemer at position w, stays counted twice: before step i,
  c[x] is the count of x at positions [i - 1, i - 1 + w) plus [x == x*].
  Those counts are read from one sort of the keys (code, position), as
  ``distances.py`` reads k-mer counts, and the deltas are summed in order
  in int64, so ``precision="exact"`` gives the distances the program must
  reproduce; a distance is D / (2 k r^2) with k = w_max + s - 1;
- the minima machine (``kmergma.replay_single`` with the raw step index as
  the CMI, StrobeGenomeMiner.jl:75), the alignment of each hit's buffered
  window to the consensus under the miner's score model (gap open -69,
  extend -5, StrobeGenomeMiner.jl:17), the drop of a hit whose score is
  below ``align_score_thr`` (``process_hit!``, Alignment.jl:83-111), the trim
  and the formatting.

``precision="float32"`` is the control: the upstream's running distance
carried in float32 (each step's change over the scale in float32, added
one step at a time), the precision below the float64 of exact integers
that the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from .align import _NUC44, _seq_to_idx, cigar_to_unitrange, semiglobal_align_many
from .fasta import encode, read_fasta
from .kmergma import fmt_dist, replay_single
from .prep import gen_ref_ws_cons

#: the keyword arguments of the entry point and the API's defaults
#: (StrobeGenomeMiner.jl:119-124)
DEFAULTS = {
    "strobemer_find_genes": {
        "s": 2, "w_min": 3, "w_max": 5, "q": 5, "kmer_dist_thr": 30, "buffer": 50, "do_align": True,
        "align_score_thr": 0, "verbose": True,
    },
}
#: the miner's score model (StrobeGenomeMiner.jl:17)
GAP_OPEN, GAP_EXTEND = -69, -5
#: positions a block of the extraction, and steps a block of the recurrence
BLOCK = 1 << 24


def _options(entry: str, kwargs: dict) -> dict:
    if entry not in DEFAULTS:
        raise ValueError(f"the reference has no entry point {entry!r}")
    unknown = set(kwargs) - set(DEFAULTS[entry])
    if unknown:
        raise ValueError(f"the reference does not take {sorted(unknown)} for {entry}")
    return {**DEFAULTS[entry], **kwargs}


def strobe_codes(codes: torch.Tensor, s: int, w_min: int, w_max: int, q: int) -> torch.Tensor:
    """int64 code of the randstrobe at each position 0 .. n - k (k = w_max
    + s - 1) of the 2-bit codes ``codes``, on their device, a block of
    ``BLOCK`` positions at a time."""
    k = w_max + s - 1
    n = codes.shape[0]
    m = n - k + 1
    out = torch.empty(max(m, 0), dtype=torch.int64, device=codes.device)
    for a in range(0, max(m, 0), BLOCK):
        b = min(a + BLOCK, m)
        part = codes[a : b + k - 1].to(torch.int64)
        nu = part.shape[0] - s + 1
        u = torch.zeros(nu, dtype=torch.int64, device=codes.device)
        for t in range(s):
            u = u * 4 + part[t : t + nu]
        first = u[: b - a]
        pick = torch.full_like(first, w_min)
        for j in range(w_min, w_max + 1):
            zero = (first + u[j - 1 : j - 1 + b - a]) % q == 0
            pick = torch.where(zero, j, pick)
        second = u[torch.arange(b - a, device=codes.device) + pick - 1]
        out[a:b] = first * 4**s + second
    return out


def strobe_spectrum(seqs: list[bytes], s: int, w_min: int, w_max: int, q: int) -> np.ndarray:
    """int64[4^(2s)]: the strobemer counts of every sequence, summed."""
    total = np.zeros(4 ** (2 * s), dtype=np.int64)
    for seq in seqs:
        sc = strobe_codes(torch.as_tensor(encode(seq)), s, w_min, w_max, q)
        total += np.bincount(sc.numpy(), minlength=total.size)
    return total


def record_stream(sc: torch.Tensor, spectrum: torch.Tensor, r: int, w: int, n_steps: int, thr: float, scale: float, precision: str = "exact") -> tuple[float, list[tuple[int, float]]]:
    """(dist0, stream) of one record's strobe codes ``sc`` (int64, on the
    device that ``spectrum``, int64[4^(2s)], is on): the stream holds
    (i, distance) for every step 1 <= i <= n_steps whose distance lies
    below ``thr`` or right after one that does, the steps that can move
    the minima machine."""
    dev = sc.device
    nk = sc.numel()
    c0 = torch.bincount(sc[: w + 1], minlength=spectrum.numel())
    d0 = int(((r * c0 - spectrum) ** 2).sum())
    dist0 = d0 / scale if precision == "exact" else float(np.float32(d0 / scale))
    if n_steps < 1:
        return dist0, []
    xstar = sc[w]
    keys = sc * nk + torch.arange(nk, device=dev)
    sorted_keys, perm = torch.sort(keys)
    del keys
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(nk, device=dev)
    del perm
    carry = d0 if precision == "exact" else np.float32(dist0)
    prev_below = dist0 < thr
    idx_parts, val_parts = [], []
    for a in range(1, n_steps + 1, BLOCK):
        b = min(a + BLOCK, n_steps + 1)
        i = torch.arange(a, b, device=dev)
        l_pos, e_pos = i - 1, i - 1 + w
        l, e = sc[l_pos], sc[e_pos]
        c_e = rank[e_pos] - torch.searchsorted(sorted_keys, e * nk + l_pos) + (e == xstar)
        c_l = torch.searchsorted(sorted_keys, l * nk + e_pos) - rank[l_pos] + (l == xstar)
        delta = 2 * r * r * (c_e - c_l + 1) - 2 * r * (spectrum[e] - spectrum[l])
        delta = torch.where(l != e, delta, 0)
        if precision == "exact":
            d_int = torch.cumsum(delta, 0) + carry
            carry = int(d_int[-1])
            d = d_int.to(torch.float64) / scale
        else:
            steps = delta.cpu().numpy().astype(np.float32) / np.float32(scale)
            d32 = np.cumsum(np.concatenate(([carry], steps)), dtype=np.float32)[1:]
            carry = d32[-1]
            d = torch.as_tensor(d32.astype(np.float64), device=dev)
        below = d < thr
        keep = below.clone()
        keep[1:] |= below[:-1]
        keep[0] |= prev_below
        prev_below = bool(below[-1])
        at = torch.nonzero(keep).flatten()
        idx_parts.append((at + a).cpu().numpy())
        val_parts.append(d[at].cpu().numpy())
    idx = np.concatenate(idx_parts)
    val = np.concatenate(val_parts)
    return dist0, list(zip(idx.tolist(), val.tolist()))


def alignment_score(query: str, subject: str, runs: list[tuple[int, str]], gap_open: int, gap_extend: int) -> int:
    """The score of the alignment that ``runs`` spell, as BioAlignments
    gives it for a semi-global alignment: EDNAFULL for each aligned pair,
    ``gap_open + L * gap_extend`` for each gap of L letters, and nothing
    for the subject's letters before the query starts or after it ends
    (the first and the last run, where they are 'D')."""
    a, b = _seq_to_idx(query), _seq_to_idx(subject)
    i = j = 0
    score = 0
    for n, (count, op) in enumerate(runs):
        if op in "=X":
            score += int(_NUC44[a[i : i + count], b[j : j + count]].sum())
            i += count
            j += count
        elif op == "I":
            score += gap_open + count * gap_extend
            i += count
        else:
            if 0 < n < len(runs) - 1:
                score += gap_open + count * gap_extend
            j += count
    return score


def _strobe(records, o, spectrum, r, ws, consensus, device, precision):
    """The hit records of one genome; a generator that yields the (query,
    subject) pairs it needs aligned and is sent their CIGAR runs."""
    s, w_min, w_max, q = o["s"], o["w_min"], o["w_max"], o["q"]
    k = w_max + s - 1
    w = ws - k
    scale = 2.0 * k * r * r
    thr = float(o["kmer_dist_thr"])
    query = consensus[:ws]
    out = []
    genome_pos = 0
    for desc, seq in records:
        n = len(seq)
        if n < ws:
            continue  # the upstream's `continue` skips GenomePos too
        sc = strobe_codes(torch.as_tensor(encode(seq), device=device), s, w_min, w_max, q)
        dist0, stream = record_stream(sc, spectrum, r, w, n - ws - 1, thr, scale, precision)
        del sc
        raw = replay_single(stream, dist0, thr, 1, ws, n, o["buffer"])  # k = 1: the CMI is the step index
        ident = desc.split(None, 1)[0] if desc else ""
        if o["do_align"] and raw:
            windows = [seq[start - 1 : stop].decode("ascii").upper() for _, start, stop in raw]
            runs = yield [(query, win) for win in windows]
        for h, (dist, start, stop) in enumerate(raw):
            if o["do_align"]:
                if alignment_score(query, windows[h], runs[h], GAP_OPEN, GAP_EXTEND) < o["align_score_thr"]:
                    continue
                lo, hi = cigar_to_unitrange(runs[h])
                start, stop = max(1, start + lo - 1), min(start + hi - 1, n)
            out.append((
                f"{ident} | dist = {fmt_dist(dist)} | MatchPos = {start}:{stop}"
                f" | GenomePos = {genome_pos} | Len = {stop - start + 1}",
                seq[start - 1 : stop].upper(),
            ))
        genome_pos += n
    return out


def find_hits(entry: str, kwargs: dict, genome_path, ref_path, device="cpu", precision: str = "exact") -> list[tuple[str, bytes]]:
    """(description, sequence) of every hit record that ``entry`` of the
    program returns for these arguments, in order."""
    return find_hits_many(entry, kwargs, [genome_path], ref_path, device, precision)[0]


def find_hits_many(entry: str, kwargs: dict, genome_paths: list, ref_path, device="cpu", precision: str = "exact") -> list[list[tuple[str, bytes]]]:
    """``find_hits`` of each genome: the reference's spectrum once, and the
    alignments of all genomes batched (``semiglobal_align_many``)."""
    o = _options(entry, kwargs)
    refs = read_fasta(ref_path)
    base, _ = gen_ref_ws_cons(refs, 1)
    spectrum = strobe_spectrum([seq for _, seq in refs], o["s"], o["w_min"], o["w_max"], o["q"])
    spec_dev = torch.as_tensor(spectrum, device=torch.device(device))
    gens = [_strobe(read_fasta(path), o, spec_dev, len(refs), base.windowsize, base.consensus, torch.device(device), precision)
            for path in genome_paths]
    results: list = [None] * len(gens)
    pending: dict[int, list] = {}

    def advance(i: int, sent) -> None:
        try:
            pending[i] = gens[i].send(sent)
        except StopIteration as stop:
            results[i] = stop.value
            pending.pop(i, None)

    for i in range(len(gens)):
        advance(i, None)
    while pending:
        order = list(pending)
        flat = [pair for i in order for pair in pending[i]]
        runs = semiglobal_align_many(flat, GAP_OPEN, GAP_EXTEND, device)
        at = 0
        for i in order:
            n = len(pending[i])
            advance(i, runs[at : at + n])
            at += n
    return results


def windowsizes(entry: str, kwargs: dict, ref_path) -> list[int]:
    """The windowsize of the one profile that ``entry`` scans with."""
    _options(entry, kwargs)
    return [gen_ref_ws_cons(read_fasta(ref_path), 1)[0].windowsize]
