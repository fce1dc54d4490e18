"""One-pass multi-profile (cluster) scan in PyTorch (counterpart of
``kmergma_tpu.ops.scan_cluster``).

Cluster mode scans every record against m cluster profiles.  What does not
depend on the profile is shared: one host-to-device copy per record, the K
codes, and the depth-limited pair counts, which depend only on the window
width, so clusters are grouped by windowsize (the Alp_V set at k = 6: six
clusters, three groups).  Per record the engine builds the m activity
bitmaps by one of two routes:

  * records with at least ``fused_min_windows`` windows in the largest
    cluster, in a set whose clusters share one pair depth of at most
    ``MAX_BITMAP_DEPTH`` (``shared_depth``): K3, the fused multi-cluster
    bitmap kernel (``ops/scan_cluster_fused.py``); the first such record
    of an engine also runs K8, which checks K3's table staging and raises
    on a mismatch;
  * shorter records, and every record of any other set: the split pass
    (``_cluster_record_bitmaps``), whose pair counts come from K5
    (``ops/scan_kernels.codes_pair_multi``) in one launch for up to 32
    windowsize groups at a shared depth of at most ``MAX_BITMAP_DEPTH``,
    or else from K4 (``codes_pair_ab_kcodes``: group 0's pair deltas and
    all K codes) and K6 (``pair_ab_from_kcodes``: every other group's at
    its own depth), which count in int32 at any depth: a set that mixes
    depths (a cluster whose windowsize is below k + ``bound_depth``
    clamps its depth to ws - k; exact mode, where each group's depth is
    its ws - k), or shares one past ``MAX_BITMAP_DEPTH``.

K3 and K8 take at most ``MAX_CLUSTERS`` (32) profiles a call, so the
engine runs them on consecutive groups of that many clusters, in cluster
order, and joins the groups' bitmaps: the engine takes any number of
clusters, as the JAX one does.  Both give each cluster the bitmap of its
own single-profile K1 pass.  Then
the single-profile planned pass runs per cluster (device region plan, K2
exact region recompute, device run reduce, ``scan._planned_streams``),
with one device-to-host copy for all m, and each stream stops at the
cluster loop's bound (see ``record_streams``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from .reference import RefProfile
from .scan import (
    MAX_BITMAP_DEPTH,
    ScanEngine,
    _check_record_len,
    _cumsum32,
    _k1_halo,
    _planned_streams,
    _window_pairs,
    pad_to_device,
    profile_lookup_multi,
    profiles_to_torch,
    rolling_kmer_codes,
)
from .scan_cluster_fused import MAX_CLUSTERS


def _first_bounds(kcodes: torch.Tensor, g_all: torch.Tensor, s2: torch.Tensor, groups: tuple, k: int) -> torch.Tensor:
    """Every cluster's first-window lower bound L[0] = r^2 (w + 2 P̂_0) -
    2 r G_0 + ||S||^2 (int32[m], as ``scan._lower_bound_base``), from the K
    codes and the lookups g_all[c, i] = S_c[K[i]] of a record."""
    l0 = torch.empty(g_all.shape[0], dtype=torch.int32, device=g_all.device)
    for ws, depth, idxs, rs in groups:
        w = ws - k + 1
        sel = list(idxs)
        r = torch.tensor(rs, dtype=torch.int64, device=g_all.device)
        p0 = _window_pairs(kcodes, w, depth)  # shared by the group
        g0 = g_all[sel, :w].sum(dim=1, dtype=torch.int64)
        l0[sel] = (r * r * (w + 2 * p0) - 2 * r * g0 + s2[sel]).to(torch.int32)
    return l0


def _cluster_record_bitmaps(codes_dev: torch.Tensor, n_valids: torch.Tensor, s_stack: torch.Tensor, thr_ints: torch.Tensor, *, k: int, span: int, block: int, groups: tuple) -> torch.Tensor:
    """The split pass over a whole record as one span of ``span`` windows
    (the record's, rounded up to the region grid): bool[m, span // block],
    cluster-major.  The JAX pass cuts long records into spans; here one
    span always holds the record.

    groups: (ws, depth, cluster indices, r per cluster) per windowsize;
    thr_ints / n_valids: int32[m] conservative thresholds and window
    counts on the device.  The K codes and every group's pair deltas come
    from one K5 call for every 32 groups when the groups share one depth
    of at most ``MAX_BITMAP_DEPTH`` (one call for any set of up to 32
    windowsizes), else from K4 (group 0, with all K codes) and K6 (each
    other group at its own depth); the pair kernels read zeros past the
    end of ``codes_dev``.  All m lookups come from one gather; each
    group's clusters then run their delta, prefix sum, threshold,
    validity mask and block any() together."""
    from .scan_kernels import MAX_PAIR_GROUPS, codes_pair_ab_kcodes, codes_pair_multi, pair_ab_from_kcodes

    s2 = (s_stack.to(torch.int64) ** 2).sum(dim=1)
    pos = torch.arange(span, dtype=torch.int64, device=codes_dev.device)
    nt = span - 1
    max_w = max(g[0] for g in groups) - k + 1
    nkc = span + max_w - 1
    if _shared_depth(groups) is not None:
        # K5 takes at most MAX_PAIR_GROUPS windowsizes a call: a set with
        # more takes one call for each run of that many, in group order
        abs_ = []
        for g0 in range(0, len(groups), MAX_PAIR_GROUPS):
            ws_chunk = tuple(g[0] for g in groups[g0 : g0 + MAX_PAIR_GROUPS])
            ab_multi, kc = codes_pair_multi(codes_dev, k, ws_chunk, nt, nkc, groups[0][1])
            abs_ += list(ab_multi)
            if g0 == 0:
                kcodes = kc
    else:
        ab0, kcodes = codes_pair_ab_kcodes(codes_dev, k, groups[0][0] - k + 1, nt, nkc, groups[0][1])
        abs_ = [ab0] + [
            pair_ab_from_kcodes(kcodes[: span + ws - k], ws - k + 1, nt, depth) for ws, depth, _i, _r in groups[1:]
        ]
    g_all = profile_lookup_multi(kcodes, s_stack)  # (m, span + max_w - 1)
    l0 = _first_bounds(kcodes, g_all, s2, groups, k)
    bitmaps: list = [None] * s_stack.shape[0]
    for gi, (ws, _depth, idxs, rs) in enumerate(groups):
        w = ws - k + 1
        sel = list(idxs)
        g_g = g_all[sel]
        r = torch.tensor(rs, dtype=torch.int32, device=g_all.device)[:, None]
        delta = (2 * r * r) * abs_[gi][None, :] + (2 * r) * (g_g[:, :nt] - g_g[:, w : w + nt])
        l0_g = l0[sel][:, None]
        bounds = torch.cat([l0_g, l0_g + _cumsum32(delta, dim=1)], dim=1)
        below = (bounds < thr_ints[sel][:, None]) & (pos[None, :] < n_valids[sel][:, None])
        bm = below.view(len(sel), span // block, block).any(dim=2)
        for j, ci in enumerate(idxs):
            bitmaps[ci] = bm[j]
    return torch.stack(bitmaps)


def _shared_depth(groups: tuple) -> int | None:
    """The one pair depth of every windowsize group, where they share one
    of at most ``MAX_BITMAP_DEPTH`` (the depth K3 and K5 take), else None."""
    depths = {g[1] for g in groups}
    depth = next(iter(depths))
    return depth if len(depths) == 1 and depth <= MAX_BITMAP_DEPTH else None


class ClusterScanEngine:
    """Scans whole records against m cluster profiles on ``device`` (the
    card unless the caller asks for the CPU).

    Holds one ``ScanEngine`` per cluster, which supply the thresholds, the
    scale, the planned pass after the bitmap and the whole-record
    distances; the cluster engine replaces their m bitmap passes with one
    (``record_streams``).  Every cluster's bound takes ``bound_depth`` (16
    by default, any depth, or None for exact mode, the depth ws - k of its
    group), as the JAX engine's do; a cluster whose window is shorter than
    k + ``bound_depth`` clamps its pair depth to ws - k.  A set whose
    clusters do not share one depth of at most ``MAX_BITMAP_DEPTH`` takes
    the split pass on every record.  This engine scans every record in one
    pass, as the JAX one does: ``chunk_windows`` only sets the miner's
    prefetch limit and the sharded engine's span."""

    def __init__(self, profiles: list[RefProfile], k: int, chunk_windows: int | None = None, *, bound_depth: int | None = 16, device: "str | torch.device" = "cuda"):
        if not profiles:
            raise ValueError("cluster mode takes at least one profile")
        self.k = k
        self.engines = [
            ScanEngine(p.sum_kfv, k=k, ws=p.windowsize, r=p.n_records, device=device, chunk_windows=chunk_windows,
                       bound_depth=bound_depth)
            for p in profiles
        ]
        e0 = self.engines[0]
        self.device, self.chunk = e0.device, e0.chunk
        self.block, self.fused_t = e0.block, e0.fused_t
        self.max_ws = max(e.ws for e in self.engines)
        self.s_stack, self.specs = profiles_to_torch(profiles, self.device)
        by_key: dict[tuple[int, int], list[int]] = {}
        for ci, e in enumerate(self.engines):
            # exact mode (depth None) counts the pairs at depth ws - k,
            # where the lower bound equals the distance
            depth = e.ws - k if e.bound_depth is None else e.bound_depth
            by_key.setdefault((e.ws, depth), []).append(ci)
        #: (ws, pair depth, cluster indices, r per cluster) per windowsize
        #: group, in the JAX engine's order
        self.groups = tuple(
            (ws, depth, tuple(cis), tuple(self.engines[ci].r for ci in cis))
            for (ws, depth), cis in sorted(by_key.items())
        )
        #: whether the clusters share one pair depth
        self.one_depth = len({g[1] for g in self.groups}) == 1
        #: the one depth K3 and K5 run at, or None where the set mixes
        #: depths or shares one past MAX_BITMAP_DEPTH (then no K3, and the
        #: split pass takes K4 and K6)
        self.shared_depth = _shared_depth(self.groups)
        #: records whose largest cluster has at least this many windows go
        #: through K3 where ``shared_depth`` is set; shorter ones, and every
        #: record of any other set, through the split pass (tests change it)
        self.fused_min_windows = 1 << 16
        #: K3's and K8's calls: consecutive clusters, at most MAX_CLUSTERS each
        self.k3_groups = tuple(
            slice(c0, min(c0 + MAX_CLUSTERS, len(profiles))) for c0 in range(0, len(profiles), MAX_CLUSTERS)
        )
        self._lookup_checked = False

    def _split_span(self, nw_max: int) -> int:
        """Windows of the split pass's one span: the record's, rounded up
        to the region grid."""
        rspan = self.engines[0].rspan
        return -(-nw_max // rspan) * rspan

    def takes_whole(self, n: int) -> bool:
        """Whether the miner copies a record of ``n`` bp to the device while
        the record before it is scanned: up to 2 x ``chunk_windows`` bp."""
        return n <= 2 * self.chunk

    def prepare_codes(self, codes: "np.ndarray | torch.Tensor") -> torch.Tensor:
        """The record's int8 codes on the device, zero-padded for the widest
        cluster: for K3's tiles and halo, the split pass's span and its pair
        kernel's tiles (K5's, or K4's without a ``shared_depth``), and
        region rows near the record end (``scan.pad_to_device``)."""
        n = codes.shape[0]
        _check_record_len(n)
        return pad_to_device(codes, self._padded_len(n), np.int8, self.device)

    def _padded_len(self, n: int) -> int:
        """Codes the passes read for a record of ``n`` bp (``prepare_codes``)."""
        from .scan_kernels import _pair_depth_need, _pair_multi_need

        nw_max = max(1, n - min(e.ws for e in self.engines) + 1)
        max_w = self.max_ws - self.k + 1
        n_tiles = -(-nw_max // self.fused_t)
        span = self._split_span(nw_max)
        if self.shared_depth is not None:
            split_need = _pair_multi_need(tuple(g[0] for g in self.groups), span - 1, span + max_w - 1)[1]
        else:
            w0 = self.groups[0][0] - self.k + 1
            split_need = _pair_depth_need(self.k, w0, span - 1, span + max_w - 1)[1]
        return max(n + self.engines[0].rspan + 1, n_tiles * self.fused_t + _k1_halo(max_w), split_need)

    def record_streams(self, codes: "np.ndarray | torch.Tensor", thrs: list[float], codes_dev: "torch.Tensor | None" = None, seg_tracker=None) -> list[tuple[float, list[tuple[int, float]]]]:
        """Scan one record against every cluster; return one (dist0, stream)
        per cluster, the contract ``replay_omn`` consumes.  ``codes`` is a
        numpy array or an int8 tensor on the engine's device; ``codes_dev``
        the record as ``prepare_codes`` gave it, when the miner prefetched
        it.  ``seg_tracker`` is taken and not used: this engine does not
        segment a record, as the JAX one does not (the sharded engine
        does).

        Each stream is the single-profile engine's minimal stream cut at the
        cluster loop's bound: the loop scans windows i <= imax = n - max(ws)
        - k + 2 only (KmerGMA.jl OmnGenomeMiner.jl:89), so cluster c's last
        stream index is min(nw_c - 1, imax)."""
        if len(thrs) != len(self.engines):
            raise ValueError(f"{len(self.engines)} clusters but {len(thrs)} thresholds")
        n = codes.shape[0]
        _check_record_len(n)
        nws = [n - e.ws + 1 for e in self.engines]
        if min(nws) < 1:
            raise ValueError("record shorter than a cluster windowsize")
        prep = self.prepare_codes(codes) if codes_dev is None else codes_dev
        thr_ints = [int(e._thr_int(t)) for e, t in zip(self.engines, thrs)]
        bitmaps = self._bitmaps(prep, nws, thr_ints)
        imax = n - self.max_ws - self.k + 2
        mis = [min(nw - 1, imax) for nw in nws]
        return _planned_streams(self.engines, prep, list(bitmaps), nws, list(thrs), mis)

    def _bitmaps(self, prep: torch.Tensor, nws: list[int], thr_ints: list[int], s_stack: "torch.Tensor | None" = None, fits_out: list | None = None) -> torch.Tensor:
        """The m bitmaps of the record in ``prep``, by its route: K3 when
        the set has a ``shared_depth`` and the largest cluster has at least
        ``fused_min_windows`` windows, else the split pass.  ``s_stack`` is
        the profile stack on ``prep``'s device (the engine's by default);
        ``fits_out`` defers K3's int32 check to the caller.  Runs in a
        ``bitmap`` span (utils/trace.py)."""
        with trace.span("bitmap") as sp:
            sp.add(profiles=len(nws), windows=sum(nws))
            if self.shared_depth is not None and max(nws) >= self.fused_min_windows:
                return self._fused_bitmaps(prep, nws, thr_ints, s_stack, fits_out)
            return self._split_bitmaps(prep, nws, thr_ints, s_stack)

    def _split_bitmaps(self, prep: torch.Tensor, nws: list[int], thr_ints: list[int], s_stack: "torch.Tensor | None" = None) -> torch.Tensor:
        """The split pass (K5, or K4 and K6): bool[m, n_blocks]."""
        span = self._split_span(max(nws))
        nws_t = torch.tensor(nws, dtype=torch.int32, device=prep.device)
        thr_t = torch.tensor(thr_ints, dtype=torch.int32, device=prep.device)
        return _cluster_record_bitmaps(
            prep, nws_t, self.s_stack if s_stack is None else s_stack, thr_t,
            k=self.k, span=span, block=self.block, groups=self.groups,
        )

    def _fused_bitmaps(self, prep: torch.Tensor, nws: list[int], thr_ints: list[int], s_stack: "torch.Tensor | None" = None, fits_out: list | None = None) -> torch.Tensor:
        """K3 over the whole record at ``shared_depth``: bool[m, n_tiles *
        t // block], one K3 call for each of ``k3_groups`` (its own bounds,
        thresholds and window counts, every group at the record's
        n_tiles), the groups' bitmaps joined in cluster order; with
        ``fits_out`` each call appends its own int32 check.  The engine's first K3 record runs K8
        on every group first and raises on a mismatch."""
        from .scan_cluster_fused import fused_cluster_record_bitmaps, lookup_roundtrip

        s_stack = self.s_stack if s_stack is None else s_stack
        t = self.fused_t
        if not self._lookup_checked:
            for g in self.k3_groups:
                widths = [ws - self.k + 1 for ws, _r in self.specs[g]]
                got = lookup_roundtrip(self.s_stack[g], t=t, w_min=min(widths), w_max=max(widths))
                with trace.span("fetch") as sp:  # the host reads the comparison back
                    sp.add(bytes=1)
                    same = torch.equal(got, self.s_stack[g])
                if not same:
                    raise RuntimeError("K8: a profile table entry came back wrong through K3's lookup")
            self._lookup_checked = True
        head = rolling_kmer_codes(prep[: self.max_ws], self.k)
        s2 = (s_stack.to(torch.int64) ** 2).sum(dim=1)
        l0s = _first_bounds(head, profile_lookup_multi(head, s_stack), s2, self.groups, self.k)
        n_tiles = -(-max(nws) // t)
        bms = [
            fused_cluster_record_bitmaps(
                prep, s_stack[g], thrs=thr_ints[g], l0s=l0s[g], nws=nws[g],
                k=self.k, specs=self.specs[g], depth=self.shared_depth, t=t, block=self.block,
                n_tiles=n_tiles, fits_out=fits_out,
            )
            for g in self.k3_groups
        ]
        return (bms[0] if len(bms) == 1 else torch.cat(bms)).bool()
