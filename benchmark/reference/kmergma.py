"""KmerGMA's hit records, worked out again from the FASTA file and the
reference set: ``find_hits(entry, kwargs, genome_path, ref_path)``.

The two miners' sequential logic is a frozen copy, at commit 643846b, of
kmergma_tpu_torch/models/state_machine.py (``replay_single_seq``,
``replay_omn``), models/miner.py and models/omn_miner.py (the record loop,
the alignment trim and the hit formatting), which follow KmerGMA.jl
src/GenomeMiner.jl:57-104 and src/OmnGenomeMiner.jl:61-157 line for line.
Only the windows below a threshold and the window after each can move the
machines' state (the others fail both branches), so the distance scan of
``distances.RecordScan`` hands them just those.
"""

from __future__ import annotations

from .align import cigar_to_unitrange, semiglobal_align_many
from .distances import RecordScan
from .fasta import encode, read_fasta
from .prep import cluster_profiles, estimate_optimal_thresholds, gen_ref_ws_cons

#: the keyword arguments of each entry point and the API's defaults
#: (KmerGMA.jl src/API.jl:60-104 and :161-226)
DEFAULTS = {
    "find_genes": {
        "k": 6, "kmer_dist_thr": 0, "buffer": 50, "do_align": True, "gap_open_score": -69,
        "gap_extend_score": -1, "verbose": True, "kmer_dist_threshold_buffer": 8.0,
    },
    "find_genes_cluster_mode": {
        "cluster_cutoffs": None, "k": 6, "kmer_dist_thrs": None, "buffer": 100, "do_align": True,
        "gap_open_score": -200, "gap_extend_score": -1, "verbose": True, "kmer_dist_threshold_buffer": 7.0,
    },
}


def fmt_dist(x: float) -> str:
    """Julia's ``string(round(x, digits=2))``."""
    return repr(round(float(x), 2))


def replay_single(stream, dist0: float, thr: float, k: int, ws: int, seq_len: int, buff: int) -> list[tuple[float, int, int]]:
    """(dist, start, stop) of each hit of the single-profile minima machine."""
    hits = []
    currminim = dist0
    cmi, stop, goal_ind = 2, True, 0
    for j, d in stream:
        if d < thr:
            if d < currminim:
                currminim = d
                cmi = j + k - 1
                stop = False
        elif not stop:
            stop = True
            cmi += 1
            if cmi > goal_ind:
                goal_ind = cmi + ws - 1
                hits.append((currminim, max(cmi - buff, 1), min(cmi + ws - 1 + buff, seq_len)))
                currminim = d
    return hits


def replay_omn(streams, dist0s, thrs):
    """The cluster machine: every cluster's stream merged in (window,
    cluster) order.  A generator: it yields (cluster, cmi, dist) at each
    rising edge and is sent whether that hit was taken, which alone resets
    the cluster's running minimum."""
    m = len(streams)
    curr_mins, cmis, stops = list(dist0s), [1] * m, [True] * m
    merged = sorted((i, ind, d) for ind in range(m) for i, d in streams[ind])
    for i, ind, d in merged:
        if d < thrs[ind]:
            if d < curr_mins[ind]:
                curr_mins[ind] = d
                cmis[ind] = i
                stops[ind] = False
        elif not stops[ind]:
            stops[ind] = True
            if (yield (ind, cmis[ind], curr_mins[ind])):
                curr_mins[ind] = d


def _options(entry: str, kwargs: dict) -> dict:
    if entry not in DEFAULTS:
        raise ValueError(f"the reference has no entry point {entry!r}")
    unknown = set(kwargs) - set(DEFAULTS[entry])
    if unknown:
        raise ValueError(f"the reference does not take {sorted(unknown)} for {entry}")
    return {**DEFAULTS[entry], **kwargs}


def _cutoffs(o: dict) -> list:
    return o["cluster_cutoffs"] if o["cluster_cutoffs"] is not None else [7, 12, 20, 25]


def find_hits(entry: str, kwargs: dict, genome_path, ref_path, device="cpu", precision: str = "exact") -> list[tuple[str, bytes]]:
    """(description, sequence) of every hit record that ``entry`` of the
    program returns for these arguments, in order."""
    return find_hits_many(entry, kwargs, [genome_path], ref_path, device, precision)[0]


def find_hits_many(entry: str, kwargs: dict, genome_paths: list, ref_path, device="cpu", precision: str = "exact") -> list[list[tuple[str, bytes]]]:
    """``find_hits`` of each genome: the preparation once, and the
    alignments of all genomes batched (``semiglobal_align_many``), each
    genome's miner a generator that yields the (query, subject) pairs it
    needs aligned and is sent their CIGAR runs."""
    o = _options(entry, kwargs)
    refs = read_fasta(ref_path)
    k = o["k"]
    if entry == "find_genes":
        profiles = [gen_ref_ws_cons(refs, k)[0]]
        thrs = [o["kmer_dist_thr"] or estimate_optimal_thresholds(profiles, o["kmer_dist_threshold_buffer"])[0]]
        miner = _single
    else:
        profiles = cluster_profiles(refs, k, _cutoffs(o))
        thrs = o["kmer_dist_thrs"]
        if thrs is None or (len(thrs) and thrs[0] == 0):
            thrs = estimate_optimal_thresholds(profiles, o["kmer_dist_threshold_buffer"])
        miner = _cluster
    thrs = [float(t) for t in thrs]
    gens = [miner(read_fasta(path), profiles, thrs, o, device, precision) for path in genome_paths]
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
        runs = semiglobal_align_many(flat, o["gap_open_score"], o["gap_extend_score"], device) if flat else []
        at = 0
        for i in order:
            n = len(pending[i])
            advance(i, runs[at : at + n])
            at += n
    return results


def windowsizes(entry: str, kwargs: dict, ref_path) -> list[int]:
    """The windowsize of each profile that ``entry`` scans with."""
    o = _options(entry, kwargs)
    refs = read_fasta(ref_path)
    if entry == "find_genes":
        return [gen_ref_ws_cons(refs, o["k"])[0].windowsize]
    return [p.windowsize for p in cluster_profiles(refs, o["k"], _cutoffs(o))]


def _single(records, profiles, thrs, o, device, precision):
    k, (profile,), (thr,) = o["k"], profiles, thrs
    ws = profile.windowsize
    query = profile.consensus[:ws]
    out = []
    genome_pos = 0
    for desc, seq in records:
        n = len(seq)
        if n < ws:
            continue  # the upstream's `continue` skips GenomePos too
        scan = RecordScan(encode(seq), k, device)
        ((dist0, stream),) = scan.streams([(profile.sum_kfv, profile.n_records, ws)], [thr], [n - ws], precision)
        del scan
        ident = desc.split(None, 1)[0] if desc else ""
        raw = replay_single(stream, dist0, thr, k, ws, n, o["buffer"])
        if o["do_align"] and raw:
            runs = yield [(query, seq[start - 1 : stop].decode("ascii").upper()) for _, start, stop in raw]
        for h, (dist, start, stop) in enumerate(raw):
            if o["do_align"]:
                lo, hi = cigar_to_unitrange(runs[h])
                start, stop = max(1, start + lo - 1), min(start + hi - 1, n)
            out.append((
                f"{ident} | dist = {fmt_dist(dist)} | MatchPos = {start}:{stop}"
                f" | GenomePos = {genome_pos} | Len = {stop - start + 1}",
                seq[start - 1 : stop].upper(),
            ))
        genome_pos += n
    return out


def _cluster(records, profiles, thrs, o, device, precision):
    k = o["k"]
    wss = [p.windowsize for p in profiles]
    maxws, buff = max(wss), o["buffer"]
    out = []
    genome_pos = 0
    for desc, seq in records:
        n = len(seq)
        imax = n - maxws - k + 2
        if imax < 1:
            genome_pos += n
            continue
        scan = RecordScan(encode(seq), k, device)
        pairs = scan.streams([(p.sum_kfv, p.n_records, p.windowsize) for p in profiles], thrs,
                             [min(n - w, imax) for w in wss], precision)
        del scan
        ident = desc.split(None, 1)[0] if desc else ""
        prev = (0, 0)
        machine = replay_omn([s for _, s in pairs], [d for d, _ in pairs], thrs)
        taken = None
        while True:
            try:
                c, cmi, dist = machine.send(taken)
            except StopIteration:
                break
            taken = False
            if prev[0] <= cmi <= prev[1]:
                continue
            rng = (max(cmi - buff, 1), min(cmi + wss[c] - 1 + buff, n))
            if o["do_align"]:
                lo, hi = rng
                (runs,) = yield [(profiles[c].consensus, seq[lo - 1 : hi].decode("ascii").upper())]
                alo, ahi = cigar_to_unitrange(runs)
                rng = (max(1, lo + alo - 1), min(lo + ahi - 1, n))
            if not (rng[1] < prev[0] or rng[0] > prev[1]):
                continue
            out.append((
                f"{ident} | Dist = {fmt_dist(dist)} | KFV = {c + 1} | MatchPos = {rng[0]}:{rng[1]}"
                f" | GenomePos = {genome_pos} | Len = {rng[1] - rng[0] + 1}",
                seq[rng[0] - 1 : rng[1]].upper(),
            ))
            prev = rng
            taken = True
        genome_pos += n
    return out
