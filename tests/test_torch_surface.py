"""Every public name of the JAX package resolves on ``kmergma_tpu_torch``.

The names are read from ``kmergma_tpu/__init__.py`` with ``ast`` (its
module-level imports and the names its ``__getattr__`` serves), not by
importing it.  Each resolves on the port, and where it is a pure host
function, constant or class, it gives the JAX package's result on a fixture."""

import ast
from pathlib import Path

import numpy as np
import pytest

import kmergma_tpu_torch as kt

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
REF = str(DATA / "Alp_V_ref.fasta")


def _jax_public_names() -> list[str]:
    tree = ast.parse((ROOT / "kmergma_tpu" / "__init__.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Compare) and isinstance(sub.left, ast.Name) and sub.left.id == "name":
                    for c in ast.walk(sub.comparators[0]):
                        if isinstance(c, ast.Constant) and isinstance(c.value, str):
                            names.append(c.value)
    return sorted(set(names))


NAMES = _jax_public_names()
SEQ = "ATGCATGCCGTANNACGT"
_CODES = np.random.default_rng(5).integers(0, 4, 400, dtype=np.int8)
_SEEDED = "".join("ACGT"[c] for c in _CODES)


def _same(a, b) -> bool:
    """Equal results, through arrays, dataclasses and tuples."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "__dataclass_fields__"):
        return type(a).__name__ == type(b).__name__ and all(
            _same(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[x], b[x]) for x in a)
    return a == b


# pure host names: the arguments of one call on a fixture (a callable of the
# module, so the fixture's paths and arrays are made when the case runs)
CALLS = {
    "NT_BITS": None,
    "HUMAN_RSSV": None,
    "HUMAN_RSSD": None,
    "encode_seq": lambda: (SEQ,),
    "decode_seq": lambda: (_CODES,),
    "get_k": lambda: (4,),
    "kmer_count": lambda: (_SEEDED, 4),
    "kmer_dist": lambda: (_SEEDED[:200], _SEEDED[200:], 3),
    "as_kmer": lambda: (2024, 6),
    "as_uint": lambda: ("ACGTTGCA",),
    "gen_ref_ws_cons": lambda: (REF, 6),
    "cluster_ref_api": lambda: (REF, 6),
    "get_cluster_index": lambda: (37.5, [7, 12, 20, 25]),
    "estimate_optimal_threshold": lambda: (np.linspace(0.0, 2.0, 4**3), 120),
    "estimate_optimal_thresholds": lambda: ([np.linspace(0.0, 2.0, 4**3), np.linspace(1.0, 0.0, 4**3)], [120, 90]),
    "kmer_pair_count": lambda: (_SEEDED[:120], 3),
    "as_index": lambda: (17, 40, 3),
    "initialize_kmers": lambda: (SEQ, 5),
    "get_strobe_2_mer": lambda: ("ATCTCTGTTT",),
    "randstrobe_score": lambda: ("ATGC", "GTGT", 7),
    "ungapped_strobe_2_mer_count": lambda: (_SEEDED, 2),
    "align_rss": lambda: (("ATGCATGC" + "CACAGTG" + "ACGT" * 3 + "ACAAAAACC" + "ATGC"),),
    "rss_dist": lambda: ("CACAGTGAAAAAAAAAAAAACAAAAACA",),
    "is_rss": lambda: (("ATGCATGC" + "CACAGTG" + "ACGT" * 3 + "ACAAAAACC" + "ATGC"),),
    "fasta_id_to_cumulative_len_dict": lambda: (str(DATA / "Loci.fasta"),),
    "mutate_seq": lambda: (_SEEDED, 0.3, 42),
    "substitution_distance_sweep": lambda: (np.bincount(
        (_CODES[:-2].astype(np.int64) << 4) + (_CODES[1:-1] << 2) + _CODES[2:], minlength=64).astype(np.float64),
        _CODES[:150], 2, 0.25),
    "strobemer_distance_sweep": lambda: (_CODES[:150], 2, 3, 5, 5, 2, 0.25),
}


def test_the_case_list_is_the_jax_surface():
    assert len(NAMES) == 38
    assert {"find_genes", "Profile", "kmer_pair_count", "is_rss", "mutation_plot", "NT_BITS"} <= set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_public_name_resolves_and_matches_jax(name):
    import importlib

    got = getattr(kt, name)
    assert got is not None
    jax_pkg = importlib.import_module("kmergma_tpu")
    want = getattr(jax_pkg, name)
    if callable(want):  # the port's own function or class, under the same name
        assert got is not want and got.__module__.startswith("kmergma_tpu_torch.")
        assert got.__name__ == want.__name__
    if name == "Profile":
        a, b = got(3), want(3)
        for p in (a, b):
            p.lengthen(len(_SEEDED[:90]))
            p.add(_CODES[:90])
            p.add(_CODES[50:140])
        assert a.consensus_str() == b.consensus_str()
    elif name == "eliminate_null_params":
        args = (REF, 6)
        assert _same(got(kt.cluster_ref_api(*args)), want(jax_pkg.cluster_ref_api(*args)))
    elif name in CALLS:
        make = CALLS[name]
        if make is None:
            assert got == want
        else:
            args = make()
            assert _same(got(*args), want(*args)), name
