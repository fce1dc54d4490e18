"""The threshold estimate in bulk (kmergma_tpu_torch/ops/thresholds.py,
utils/julia_rand.py): the native Xoshiro256++ draws against the serial
Python stream, through the native library and its fallback; the batched
random sequences against ``randdnaseq_codes`` call by call; and the
estimates against the JAX package's serial ones, compared with ``==``."""

from pathlib import Path

import numpy as np
import pytest

from kmergma_tpu.ops import reference as jref
from kmergma_tpu.ops import thresholds as jthr
from kmergma_tpu.utils.julia_rand import randdnaseq_codes as serial_randdnaseq_codes
from kmergma_tpu_torch.ops import thresholds as tthr
from kmergma_tpu_torch.utils import julia_rand, native
from kmergma_tpu_torch.utils.julia_rand import JuliaXoshiro, randdnaseq_codes, randdnaseq_codes_batch

from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REF = str(Path(__file__).parent / "data" / "Alp_V_ref.fasta")
SEEDS = [0, 42, 2**40 + 7]
PATHS = ["native", "fallback"]


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """The native library, or none: ``get_lib`` then returns None."""
    if request.param == "native":
        assert native.get_lib() is not None, "the port's native library did not build"
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


def _state(rng: JuliaXoshiro) -> tuple:
    return rng.s0, rng.s1, rng.s2, rng.s3


@pytest.mark.parametrize("n", [0, 1, 17, 1900, 11100])
@pytest.mark.parametrize("seed", SEEDS)
def test_rand_u64s_is_the_serial_stream(path, seed, n):
    bulk, serial = JuliaXoshiro(seed), JuliaXoshiro(seed)
    for _ in range(2):  # and again from where the first call left the state
        got = bulk.rand_u64s(n)
        assert got.dtype == np.uint64 and got.shape == (n,)
        assert got.tolist() == [serial.rand_u64() for _ in range(n)]
        assert _state(bulk) == _state(serial)


@pytest.mark.parametrize("length", [1, 15, 16, 17, 288, 289, 290])
def test_randdnaseq_batch_rows_are_the_serial_calls(path, length):
    bulk, serial = JuliaXoshiro(42), JuliaXoshiro(42)
    got = randdnaseq_codes_batch(bulk, 7, length)
    assert got.dtype == np.int8 and got.shape == (7, length)
    for row in got:
        want = serial_randdnaseq_codes(serial, length)
        assert row.tobytes() == want.tobytes()
    assert _state(bulk) == _state(serial)
    one = randdnaseq_codes(bulk, length)
    assert one.dtype == np.int8 and one.tobytes() == serial_randdnaseq_codes(serial, length).tobytes()
    assert _state(bulk) == _state(serial)


@pytest.mark.parametrize("buffer", [7.0, 8.0, 12.0])
def test_alp_v_estimates_equal_jax(path, buffer):
    p = jref.gen_ref_ws_cons(REF, 6)
    assert tthr.estimate_optimal_threshold(p.mean_kfv, p.windowsize, buffer=buffer) == \
        jthr.estimate_optimal_threshold(p.mean_kfv, p.windowsize, buffer=buffer)
    assert tthr.last_counters == {"trials": 100, "draws": 100 * 19, "rng_native": int(path == "native")}
    c = jref.eliminate_null_params(jref.cluster_ref_api(REF, 6))
    assert tthr.estimate_optimal_thresholds(c.kfvs, c.windowsizes, buffer=buffer) == \
        jthr.estimate_optimal_thresholds(c.kfvs, c.windowsizes, buffer=buffer)
    assert tthr.last_counters["trials"] == 100 * len(c.kfvs)
    assert tthr.last_counters["draws"] == 100 * sum(-(-w // 16) for w in c.windowsizes)


#: (k, random sequence lengths, one a cluster, trials): a profile a length;
#: at k 8 a block holds 2 trials (``_BLOCK_BYTES``), so 101 trials end on
#: a part block; shorter sequences than k count no k-mer
PROFILE_CASES = [
    (3, [120], 100),
    (4, [64, 90, 200], 100),
    (6, [288, 17, 1, 289, 290, 16, 400, 5], 100),
    (8, [150, 151], 101),
    (12, [300], 3),
]


@pytest.mark.parametrize("k, lengths, trials", PROFILE_CASES)
def test_random_profile_estimates_equal_jax(k, lengths, trials):
    rng = np.random.default_rng(k)
    kfvs = [rng.random(4**k) * rng.integers(1, 4) for _ in lengths]
    assert tthr.estimate_optimal_threshold(kfvs[0], lengths[0], seed=7, num_trials=trials) == \
        jthr.estimate_optimal_threshold(kfvs[0], lengths[0], seed=7, num_trials=trials)
    assert tthr.estimate_optimal_thresholds(kfvs, lengths, seed=7, num_trials=trials, buffer=3.5) == \
        jthr.estimate_optimal_thresholds(kfvs, lengths, seed=7, num_trials=trials, buffer=3.5)


def test_a_block_is_sized_from_4_to_the_k():
    assert tthr._BLOCK_BYTES // (4**6 * 8) >= 32
    assert tthr._BLOCK_BYTES // (4**8 * 8) == 2
    assert max(1, tthr._BLOCK_BYTES // (4**9 * 8)) == 1


def test_randdnaseq_codes_is_the_one_row_batch(monkeypatch):
    calls = []
    batch = julia_rand.randdnaseq_codes_batch

    def spy(rng, n_seqs, length):
        calls.append((n_seqs, length))
        return batch(rng, n_seqs, length)

    monkeypatch.setattr(julia_rand, "randdnaseq_codes_batch", spy)
    assert randdnaseq_codes(JuliaXoshiro(1), 33).shape == (33,)
    assert calls == [(1, 33)]
