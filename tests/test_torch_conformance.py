"""A seeded conformance sweep of the three search APIs: the port on the CPU
against the JAX package, byte for byte.

Each case writes a FASTA made from its seed with numpy: one record shorter
than the windowsize and one to three records of 2 kb to 60 kb, holding
copies of Alp_V references with 0-20 substitutions, a 40 bp run of N, and
one record in lowercase.  The seed also draws the call's options: k and a
fixed or estimated threshold for ``find_genes``, k for
``find_genes_cluster_mode`` (cutoffs [7, 12, 20, 25]), s for
``strobemer_find_genes``, the buffer, ``do_align`` and the return flags.
Both packages get the same file and options; every returned value must be
equal: hit descriptions and sequences, loci, alignments and distances."""

import warnings
from pathlib import Path

import numpy as np
import pytest

import kmergma_tpu as jk
import kmergma_tpu_torch as kt

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REF = Path(__file__).parent / "data" / "Alp_V_ref.fasta"
ACGT = np.frombuffer(b"ACGT", np.uint8)
#: below the shortest windowsize of any option drawn here
SHORT = 280
#: each API's five seeds, from a first seed whose five draws between them
#: take every value of each option (``test_the_sweep_covers_the_options``)
APIS = {"find_genes": 30, "find_genes_cluster_mode": 100, "strobemer_find_genes": 150}
CASES = [(api, first + i) for api, first in APIS.items() for i in range(5)]


def _genes() -> list[bytes]:
    genes, cur = [], []
    for line in REF.read_text().splitlines():
        if line.startswith(">"):
            if cur:
                genes.append("".join(cur).upper().encode())
            cur = []
        else:
            cur.append(line.strip())
    genes.append("".join(cur).upper().encode())
    return genes


GENES = _genes()


def _write_fasta(path: Path, rng: np.random.Generator) -> None:
    """The seeded genome: a short record, 1-3 records with planted genes, a
    run of N in one of them, one of them in lowercase; shuffled."""
    records = [("short below the window", ACGT[rng.integers(0, 4, int(rng.integers(50, SHORT)))].tobytes())]
    for i in range(int(rng.integers(1, 4))):
        seq = ACGT[rng.integers(0, 4, int(rng.integers(2_000, 60_001)))]
        for _ in range(int(rng.integers(1, 4))):
            gene = np.frombuffer(GENES[int(rng.integers(len(GENES)))], np.uint8).copy()
            subs = rng.choice(len(gene), int(rng.integers(0, 21)), replace=False)
            gene[subs] = ACGT[(np.searchsorted(ACGT, gene[subs]) + rng.integers(1, 4, len(subs))) % 4]
            at = int(rng.integers(0, len(seq) - len(gene)))
            seq[at : at + len(gene)] = gene
        records.append((f"contig {i} | planted", seq.tobytes()))
    j = int(rng.integers(1, len(records)))
    at = int(rng.integers(0, len(records[j][1]) - 40))
    records[j] = (records[j][0], records[j][1][:at] + b"N" * 40 + records[j][1][at + 40 :])
    j = int(rng.integers(1, len(records)))
    records[j] = (records[j][0], records[j][1].lower())
    with open(path, "w") as f:
        for i in rng.permutation(len(records)):
            desc, seq = records[i]
            f.write(f">{desc}\n")
            f.writelines(seq[a : a + 70].decode() + "\n" for a in range(0, len(seq), 70))


def _options(api: str, rng: np.random.Generator) -> dict:
    kw = dict(verbose=False, buffer=int(rng.choice([0, 50, 100])), do_align=bool(rng.integers(4) > 0),
              do_return_hit_loci=bool(rng.integers(2)), do_return_align=bool(rng.integers(2)),
              do_return_dists=bool(rng.integers(4) == 0))
    if api == "find_genes":
        kw.update(k=int(rng.integers(4, 8)), kmer_dist_thr=float(rng.choice([0, 20, 30, 40])))
    elif api == "find_genes_cluster_mode":
        kw.update(k=int(rng.integers(5, 7)), cluster_cutoffs=[7, 12, 20, 25])
    else:
        kw.update(s=int(rng.integers(2, 4)))
    return kw


def _plain(x):
    """A value both packages' results reduce to: arrays to their dtype,
    shape and bytes, dataclasses (hits, alignments) to their fields."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "__dataclass_fields__"):
        return type(x).__name__, {f: _plain(getattr(x, f)) for f in x.__dataclass_fields__ if not f.startswith("_")}
    return x


@pytest.mark.parametrize("api", APIS)
def test_the_sweep_covers_the_options(api):
    """Between them, an API's seeds draw each return flag and ``do_align``
    both ways and every buffer, and ``find_genes``'s k 4-7 with an
    estimated and a fixed threshold, the cluster mode's k 5 and 6, and the
    strobe API's s 2 and 3."""
    drawn = [_options(api, np.random.default_rng(seed)) for a, seed in CASES if a == api]
    for flag in ("do_align", "do_return_hit_loci", "do_return_align", "do_return_dists"):
        assert {kw[flag] for kw in drawn} == {False, True}, flag
    assert {kw["buffer"] for kw in drawn} == {0, 50, 100}
    if api == "find_genes":
        assert {kw["k"] for kw in drawn} == {4, 5, 6, 7}
        assert {kw["kmer_dist_thr"] == 0 for kw in drawn} == {False, True}
    elif api == "find_genes_cluster_mode":
        assert {kw["k"] for kw in drawn} == {5, 6}
    else:
        assert {kw["s"] for kw in drawn} == {2, 3}


@pytest.mark.parametrize("api,seed", CASES, ids=[f"{a}-{s}" for a, s in CASES])
def test_api_matches_jax(tmp_path, api, seed):
    """The port's API on the CPU returns the JAX API's outputs on the
    seed's genome and options."""
    rng = np.random.default_rng(seed)
    kw = _options(api, rng)
    genome = tmp_path / "genome.fasta"
    _write_fasta(genome, rng)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # low k, thresholds above the estimate
        want = getattr(jk, api)(str(genome), str(REF), **kw)
        got = getattr(kt, api)(str(genome), str(REF), device="cpu", **kw)
    n_out = 1 + kw["do_return_hit_loci"] + kw["do_return_align"] + kw["do_return_dists"]
    assert len(got) == len(want) == n_out
    assert [(h.description, h.seq) for h in got[0]] == [(h.description, h.seq) for h in want[0]]
    assert _plain(got) == _plain(want)
    assert len(want[0]) > 0  # the planted genes are found
