"""The port's throughput harness (kmergma_tpu_torch.bench) against the JAX
harness (the root bench.py) on the CPU, with the same inputs through both:
K7's plain route against the Pallas kernel in interpret mode and against
numpy, the synthetic genome and its planted genes, and a whole run at
about 2 Mbp per row, whose hit-dense hits equal the JAX engine's.  Zero
tolerance: the codes are integers and the distances integer ratios."""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmergma_tpu.models.state_machine import replay_single as jax_replay_single
from kmergma_tpu.ops import scan as jscan
from kmergma_tpu.ops.reference import gen_ref_ws_cons as jax_gen_ref_ws_cons
from kmergma_tpu.utils.fasta import as_records as jax_as_records
from kmergma_tpu_torch import bench as tbench
from kmergma_tpu_torch.utils.fasta import as_records

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as jbench  # noqa: E402  (the root harness)


def _jax_harness_keys() -> tuple:
    """The keys of the JAX harness's JSON line, in the order its source
    sets them: the ``result = {...}`` literal, then each ``result[...] =``."""
    tree = ast.parse(inspect.getsource(jbench))
    keys = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == "result" and isinstance(node.value, ast.Dict):
                keys += [(node.lineno, key.value) for key in node.value.keys]
            elif isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name) and tgt.value.id == "result":
                keys.append((node.lineno, tgt.slice.value))
    return tuple(key for _line, key in sorted(keys, key=lambda x: x[0]))


def _hash_codes_np(pos, seed):
    """The JAX harness's XLA hash (bench.py hash_codes) in numpy uint32."""
    with np.errstate(over="ignore"):
        x = pos.astype(np.uint32) * np.uint32(0x9E3779B9) + np.uint32(seed & 0xFFFFFFFF)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        return ((x >> np.uint32(7)) & 3).astype(np.int8)


def _jax_engine(profile):
    return jscan.ScanEngine(profile.sum_kfv, k=profile.k, ws=profile.windowsize, r=profile.n_records)


def test_hash_genome_matches_the_pallas_kernel():
    total = (1 << 20) + 12345  # a partial last grid step and the final slice
    got = tbench.hash_genome(total, 42, "cpu")
    assert got.dtype == torch.int8 and got.shape == (total,)
    want = np.asarray(jbench._pallas_hash_genome(total, 42, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [7, 11, 2**31 + 5])
@pytest.mark.parametrize("start", [0, 123_457, 2**32 - 3_000])
def test_hash_genome_plain_matches_numpy(seed, start):
    """Any seed as uint32; positions from ``start`` wrap at 2^32 as
    ``jnp.arange(total, dtype=uint32)`` does."""
    n = 10_007
    got = tbench.hash_genome_plain(n, seed, "cpu", start=start).numpy()
    want = _hash_codes_np(np.arange(start, start + n, dtype=np.uint64), seed)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0, 1, 2, 3}


def test_hash_genome_routes_by_device():
    """The CPU takes the plain twin in pieces and launches nothing; other
    devices are refused."""
    tbench.hash_genome.launches = 0
    n = tbench._CPU_PIECE + 1_001
    got = tbench.hash_genome(n, 3, "cpu")
    np.testing.assert_array_equal(got.numpy(), tbench.hash_genome_plain(n, 3, "cpu").numpy())
    assert tbench.hash_genome.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tbench.hash_genome(100, 3, "meta")


def test_device_random_genome_matches_jax(ref_fasta):
    profile = jax_gen_ref_ws_cons(ref_fasta, 6)
    prep = jbench._device_random_genome(_jax_engine(profile), 100_000, seed=42, max_ws=profile.windowsize + 1)
    got = tbench._device_random_genome(100_000, 42, "cpu")
    assert got.shape == (100_000,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(prep.dev)[:100_000])


def test_plant_genes_matches_jax(ref_fasta):
    profile = jax_gen_ref_ws_cons(ref_fasta, 6)
    n = 2_000_000
    prep = jbench._device_random_genome(_jax_engine(profile), n, seed=7, max_ws=profile.windowsize + 1)
    prep, want_n = jbench._plant_genes_device(prep, jax_as_records(ref_fasta), n, spacing=500_000)
    got, got_n = tbench._plant_genes_device(tbench._device_random_genome(n, 7, "cpu"), as_records(ref_fasta), n, 500_000)
    assert got_n == want_n == 4
    np.testing.assert_array_equal(got.numpy(), np.asarray(prep.dev)[:n])


def test_env_set_restores_the_callers_value(monkeypatch):
    """The NumPy-aligner row sets KMERGMA_ALIGN_NATIVE=0 for its call
    only; the caller's value, or its absence, comes back after."""
    monkeypatch.delenv("KMERGMA_ALIGN_NATIVE", raising=False)
    with tbench._env_set("KMERGMA_ALIGN_NATIVE", "0"):
        assert os.environ["KMERGMA_ALIGN_NATIVE"] == "0"
    assert "KMERGMA_ALIGN_NATIVE" not in os.environ
    monkeypatch.setenv("KMERGMA_ALIGN_NATIVE", "1")
    with pytest.raises(KeyError):
        with tbench._env_set("KMERGMA_ALIGN_NATIVE", "0"):
            raise KeyError("a row that fails")
    assert os.environ["KMERGMA_ALIGN_NATIVE"] == "1"


def test_run_on_cpu_matches_jax(ref_fasta, monkeypatch):
    """Every row at about 2 Mbp: exactly the JAX harness's keys, the
    hit-dense hits equal the JAX engine's (``full_fetch_windows = 0``)
    plus ``replay_single`` on the same codes, and KMERGMA_ALIGN_NATIVE as
    the caller left it."""
    monkeypatch.setenv("KMERGMA_ALIGN_NATIVE", "1")
    arts: dict = {}
    notes: list = []
    result = tbench.run(
        "cpu", n_mbp=2, dense_mbp=2, k10_mbp=1, strobe_mbp=0.5, g3_mbp=4, g3_rec_mbp=2,
        artefacts=arts, note=notes.append,
    )
    assert tbench.KEYS == _jax_harness_keys()
    assert tuple(result) == tbench.KEYS
    assert os.environ["KMERGMA_ALIGN_NATIVE"] == "1"
    assert len(notes) == 7 and all("min " in n and "median " in n for n in notes)
    assert result["cluster_m"] == 6 and result["hit_dense_hits"] == 4
    dense = arts["dense"]
    n = dense["codes"].shape[0]
    profile = jax_gen_ref_ws_cons(ref_fasta, 6)
    eng = _jax_engine(profile)
    eng.full_fetch_windows = 0
    d0, stream, _ = eng.record_stream(dense["codes"], 30.0)
    want = jax_replay_single(stream, d0, 30.0, 6, profile.windowsize, n, 50)
    assert [dataclasses.astuple(h) for h in dense["hits"]] == [dataclasses.astuple(h) for h in want]
    assert len(set(arts["g3"]["counts"])) == 1


def test_bench_module_exits_non_zero_without_cuda():
    """``python -m kmergma_tpu_torch.bench`` runs only on the card: here it
    exits non-zero and prints no JSON line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "kmergma_tpu_torch.bench"], cwd=root, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # see tests/_torch_one_thread.py
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""
