"""Every window's k-mer distance to a profile, exactly, in plain torch.

Written for the benchmark, by another algorithm than the program's: the
scaled distance of window i is D(i) = ||R c_i - S||^2, with c_i the k-mer
counts of the window's W = ws - k + 1 k-mers, S the summed spectrum of the
R reference records, and ``dist = D / (2 k R^2)`` in float64 (KmerGMA.jl
src/GenomeMiner.jl:42-77 carries the same quantity as a float).  D(0) is
summed from a bincount, then

    D(i+1) - D(i) = 0                                      if e == l
                  = 2 R^2 (c_i[e] - c_i[l] + 1) - 2 R (S[e] - S[l])  else,

with l the k-mer leaving (at position i) and e the one entering (at
i + W).  c_i[x], the occurrences of x among positions [i, i + W), is read
from one sort of the keys (k-mer, position): the rank of a position's own
key and one ``searchsorted`` a term.  Integer sums in int64 are exact, so
``precision="exact"`` gives the distances the program must reproduce.

``precision="float32"`` is the control: the upstream's own running
distance (GenomeMiner.jl adds each step's change to a Float64) carried in
float32 instead, the precision below the float64 that the configuration
states: each step's delta over the scale in float32, added one step at a
time by NumPy's sequential ``cumsum`` in float32.
"""

from __future__ import annotations

import numpy as np
import torch

#: windows a chunk of the recurrence handles; bounds the temporaries
CHUNK = 1 << 24


def kmer_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    m = codes.numel() - k + 1
    out = torch.zeros(m, dtype=torch.int64, device=codes.device)
    for t in range(k):
        out += codes[t : t + m].to(torch.int64) << (2 * (k - 1 - t))
    return out


class RecordScan:
    """The k-mer order of one record, shared by every profile scanned over it."""

    def __init__(self, codes: np.ndarray, k: int, device):
        self.n = codes.shape[0]
        self.k = k
        self.device = torch.device(device)
        self.kc = kmer_codes(torch.as_tensor(codes, device=self.device), k)
        nk = self.kc.numel()
        self.nk = nk
        keys = self.kc * nk + torch.arange(nk, device=self.device)
        self.sorted_keys, perm = torch.sort(keys)
        del keys
        self.rank = torch.empty_like(perm)
        self.rank[perm] = torch.arange(nk, device=self.device)
        del perm

    def _count_diff(self, a: int, b: int, w: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(c_i[e] - c_i[l] + 1, e, l) for steps i in [a, b)."""
        i = torch.arange(a, b, device=self.device)
        e = self.kc[a + w : b + w]
        l = self.kc[a:b]
        c_e = self.rank[a + w : b + w] - torch.searchsorted(self.sorted_keys, e * self.nk + i)
        c_l = torch.searchsorted(self.sorted_keys, l * self.nk + i + w) - self.rank[a:b]
        return c_e - c_l + 1, e, l

    def streams(self, profiles: list[tuple[np.ndarray, int, int]], thrs: list[float], last: list[int], precision: str = "exact") -> list[tuple[float, list[tuple[int, float]]]]:
        """(dist0, stream) per profile (summed spectrum S, records R,
        windowsize ws): the stream holds (i, dist) for every window
        1 <= i <= last that lies below the threshold or right after one that
        does, the windows that can move the minima state machine."""
        out: list = [None] * len(profiles)
        for ws in sorted({p[2] for p in profiles}):
            group = [j for j, p in enumerate(profiles) if p[2] == ws]
            w = ws - self.k + 1
            nw = self.n - ws + 1
            states = []
            for j in group:
                s_np, r, _ = profiles[j]
                s = torch.as_tensor(np.asarray(s_np, dtype=np.int64), device=self.device)
                c0 = torch.bincount(self.kc[:w], minlength=s.numel())
                d0 = int(((r * c0 - s) ** 2).sum())
                scale = 2.0 * self.k * r * r
                carry = d0 if precision == "exact" else np.float32(d0 / scale)
                states.append({"s": s, "r": r, "scale": scale, "carry": carry, "prev_below": d0 / scale < thrs[j],
                               "dist0": float(d0 / scale) if precision == "exact" else float(carry), "idx": [], "val": []})
            for a in range(0, nw - 1, CHUNK):
                b = min(a + CHUNK, nw - 1)
                diff, e, l = self._count_diff(a, b, w)
                same = e == l
                for j, st in zip(group, states):
                    r, s = st["r"], st["s"]
                    delta = 2 * r * r * diff - 2 * r * (s[e] - s[l])
                    delta[same] = 0
                    if precision == "exact":
                        d_int = torch.cumsum(delta, 0) + st["carry"]
                        st["carry"] = int(d_int[-1])
                        d = d_int.to(torch.float64) / st["scale"]
                    else:
                        steps = delta.cpu().numpy().astype(np.float32) / np.float32(st["scale"])
                        d32 = np.cumsum(np.concatenate(([st["carry"]], steps)), dtype=np.float32)[1:]
                        st["carry"] = d32[-1]
                        d = torch.as_tensor(d32.astype(np.float64), device=self.device)
                    below = d < thrs[j]
                    keep = below.clone()
                    keep[1:] |= below[:-1]
                    keep[0] |= st["prev_below"]
                    st["prev_below"] = bool(below[-1])
                    hit = torch.nonzero(keep).flatten()
                    hit = hit[hit + a + 1 <= last[j]]
                    st["idx"].append((hit + a + 1).cpu().numpy())
                    st["val"].append(d[hit].cpu().numpy())
            for j, st in zip(group, states):
                idx = np.concatenate(st["idx"]) if st["idx"] else np.zeros(0, np.int64)
                val = np.concatenate(st["val"]) if st["val"] else np.zeros(0)
                out[j] = (st["dist0"], list(zip(idx.tolist(), val.tolist())))
        return out
