"""Reference-set preprocessing: mean k-mer profiles, windowsizes, consensus,
clustering (ref KmerGMA.jl src/ReferenceGeneration.jl).

Float arithmetic is replicated operation-for-operation so the golden vectors
pin bit-identically:
  * ``gen_ref_ws_cons`` multiplies by the reciprocal ``1/len``
    (ReferenceGeneration.jl:35-40),
  * ``cluster_ref_api`` divides by the cluster size
    (ReferenceGeneration.jl:118-119).

Beyond the reference's float mean profile, each result also carries the exact
*integer* summed spectrum and the record count - the scan engine works in
scaled integers (profile denominator R) so window distances are exact
rationals, sidestepping the reference's float64 accumulation drift
(SURVEY.md section 7, hard part 2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.fasta import PathOrRecords, as_records
from .consensus import Profile
from .kmers import kmer_count_into, kmer_dist


@dataclass
class RefProfile:
    """One scan profile: everything needed to mine against one reference set."""

    mean_kfv: np.ndarray  # float64[4^k], the reference's RV
    sum_kfv: np.ndarray  # int64[4^k], exact integer sum over the set
    n_records: int  # denominator R of the mean
    windowsize: int
    consensus: str  # full-length consensus (not truncated)
    k: int

    @property
    def consensus_ws(self) -> str:
        """Consensus truncated to the windowsize, as used at alignment time
        (ref Alignment.jl:42 views consensus[1:windowsize])."""
        return self.consensus[: self.windowsize]


def gen_ref_ws_cons(source: PathOrRecords, k: int, get_maxlen: bool = False):
    """Mean KFV, mean-length windowsize and consensus of a reference set
    (ref ReferenceGeneration.jl:4-41).

    Returns ``(RefProfile, maxlen?)`` - the RefProfile's fields unpack to the
    reference's ``(RV, windowsize, consensus)`` triple.
    """
    if not 1 <= k <= 14:
        raise ValueError(f"k = {k} is out of range (need 1 <= k <= 14; 4^k spectrum bins)")
    records = as_records(source)
    if not records:
        raise ValueError("reference set is empty")

    sums = np.zeros(4**k, dtype=np.float64)
    profile = Profile(1)
    n, cum_nts, maxlen = 0, 0, 0
    for rec in records:
        n += 1
        cur_len = len(rec)
        cum_nts += cur_len
        maxlen = max(maxlen, cur_len)
        kmer_count_into(rec.codes, k, sums)
        profile.lengthen(cur_len)
        profile.add(rec.codes)

    inv = 1.0 / n
    mean_kfv = sums * inv
    windowsize = int(np.round(cum_nts * inv))
    ref = RefProfile(
        mean_kfv=mean_kfv,
        sum_kfv=sums.astype(np.int64),
        n_records=n,
        windowsize=windowsize,
        consensus=profile.consensus_str(),
        k=k,
    )
    if get_maxlen:
        return ref, maxlen
    return ref


def get_cluster_index(value: float, cutoffs: list) -> int:
    """1-based bucket of ``value`` among ``cutoffs`` (ref ReferenceGeneration.jl:50-57)."""
    ans = 1
    for num in cutoffs:
        if value <= num:
            return ans
        ans += 1
    return ans


@dataclass
class ClusterRefs:
    profiles: list[RefProfile]  # one per cluster (possibly including the global average)
    invalid: list[bool]  # True marks an empty cluster
    dists: list[float] | None = None  # per-record distance to the mean profile

    # Reference-shaped accessors -------------------------------------------
    @property
    def kfvs(self) -> list[np.ndarray]:
        return [p.mean_kfv for p in self.profiles]

    @property
    def windowsizes(self) -> list[int]:
        return [p.windowsize for p in self.profiles]

    @property
    def consensus_seqs(self) -> list[str]:
        return [p.consensus for p in self.profiles]


def cluster_ref_api(
    source: PathOrRecords,
    k: int,
    cutoffs: list | None = None,
    get_dists: bool = False,
    include_avg: bool = True,
) -> ClusterRefs:
    """Two-pass clustering of the reference set by distance to the mean
    profile (ref ReferenceGeneration.jl:75-138).

    Pass 1 computes the global mean profile; pass 2 buckets each record by
    its k-mer distance to that mean (``get_cluster_index``) and accumulates
    per-cluster spectra, lengths and consensus profiles.  Cluster consensus
    sequences are truncated to the cluster windowsize
    (ReferenceGeneration.jl:120); the appended global-average cluster keeps
    its full consensus (ReferenceGeneration.jl:127-132).
    """
    if cutoffs is None:
        cutoffs = [7, 12, 20, 25]
    records = as_records(source)
    avg, maxlen = gen_ref_ws_cons(records, k, get_maxlen=True)

    m = len(cutoffs) + 1
    sums = [np.zeros(4**k, dtype=np.float64) for _ in range(m)]
    ws_sums = [0] * m
    lens = [0] * m
    profiles = [Profile(maxlen) for _ in range(m)]
    dists: list[float] = []

    for rec in records:
        d = kmer_dist(rec.codes, avg.mean_kfv, k)
        ci = get_cluster_index(d, cutoffs) - 1
        dists.append(d)
        profiles[ci].add(rec.codes)
        ws_sums[ci] += len(rec)
        lens[ci] += 1
        kmer_count_into(rec.codes, k, sums[ci])

    out_profiles: list[RefProfile] = []
    invalid: list[bool] = []
    for i in range(m):
        if lens[i] != 0:
            ws = int(np.round(ws_sums[i] / lens[i]))
            out_profiles.append(
                RefProfile(
                    mean_kfv=sums[i] / lens[i],
                    sum_kfv=sums[i].astype(np.int64),
                    n_records=lens[i],
                    windowsize=ws,
                    consensus=profiles[i].consensus_str()[:ws],
                    k=k,
                )
            )
            invalid.append(False)
        else:
            out_profiles.append(
                RefProfile(
                    mean_kfv=sums[i],
                    sum_kfv=sums[i].astype(np.int64),
                    n_records=0,
                    windowsize=0,
                    consensus="",
                    k=k,
                )
            )
            invalid.append(True)

    if include_avg:
        out_profiles.append(avg)
        invalid.append(False)

    return ClusterRefs(out_profiles, invalid, dists if get_dists else None)


def eliminate_null_params(clusters: ClusterRefs) -> ClusterRefs:
    """Drop empty clusters (ref ReferenceGeneration.jl:152-168)."""
    keep = [p for p, inv in zip(clusters.profiles, clusters.invalid) if not inv]
    return ClusterRefs(keep, [False] * len(keep), clusters.dists)
