"""R1, the planned record's run reduce (``scan_kernels.run_reduce_multi``).

Its plain twin, profile by profile, against the JAX package's below mask
(``_below_and_words``) and jitted ``_device_run_reduce`` on the edge cases
of ``tests/_r1_cases.py``; a NumPy model of the kernel's three launches
(row folds, row carries, row runs, with the kernel's index arithmetic on
shrunk thread counts) against the twin; ``_planned_streams`` on the CPU
cluster engine, one wrapper call a planned pass for all six profiles and
the JAX engine's streams; and the wrapper's refusals.  The kernel against
the twin on the card: ``tests/test_torch_kernels.py::
test_r1_matches_twin_on_card``.  Zero tolerance: integer arithmetic.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmergma_tpu.ops import scan as jscan
from kmergma_tpu.ops import scan_cluster as jcluster
from kmergma_tpu.ops.reference import cluster_ref_api, eliminate_null_params
from kmergma_tpu.utils.fasta import as_records
from kmergma_tpu_torch.ops import scan_cluster as tcluster
from kmergma_tpu_torch.ops import scan_kernels
from kmergma_tpu_torch.ops.scan_kernels import _run_reduce_multi_plain, run_reduce_multi, run_reduce_size

from ._r1_cases import R1_CASES, r1_case
from ._torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

DATA = Path(__file__).parent / "data"
INT_MAX = 2**31 - 1

_jax_reduce = jax.jit(jscan._device_run_reduce, static_argnums=(3,), static_argnames=("run_bucket",))


def _torch_args(profiles, device="cpu"):
    """``run_reduce_multi``'s arguments for a case's profiles."""
    return (
        [torch.from_numpy(p["d"]).to(device) for p in profiles],
        [torch.from_numpy(p["starts"]).to(device) for p in profiles],
        [torch.tensor(p["nvr"], dtype=torch.int32, device=device) for p in profiles],
        [p["thr"] for p in profiles], [p["nw"] for p in profiles], [p["mi"] for p in profiles],
        [p["R"] for p in profiles],
    )


def _jax_part(p) -> np.ndarray:
    """One profile's [nvr, d[0, 0], reduce] from the JAX functions."""
    d = jnp.asarray(p["d"])
    starts = jnp.asarray(p["starts"].astype(np.int32))
    meta = jnp.asarray([p["thr"], p["thr"], p["nw"]], dtype=jnp.int32)
    below = jscan._below_and_words(d, starts, meta, jnp.int32(p["nvr"]))[0]
    red = np.asarray(_jax_reduce(d, below, starts, p["d"].shape[1], jnp.int32(p["mi"]), run_bucket=p["R"]))
    return np.concatenate([[p["nvr"], p["d"][0, 0]], red]).astype(np.int32)


def _parts(blob: np.ndarray, profiles) -> list:
    offs = np.cumsum([0] + [run_reduce_size(p["R"]) for p in profiles])
    assert blob.shape == (offs[-1],)
    return [blob[a:b] for a, b in zip(offs[:-1], offs[1:])]


@pytest.mark.parametrize("name", R1_CASES)
def test_plain_twin_matches_jax(name):
    """The batched twin equals the JAX below mask and reduce, profile by
    profile, on every edge case; the cases reach what they are for."""
    profiles = r1_case(name)
    got = _parts(run_reduce_multi(*_torch_args(profiles)).numpy(), profiles)
    for p, part in zip(profiles, got):
        np.testing.assert_array_equal(part, _jax_part(p))
    n_runs = [int(part[2]) for part in got]
    rspan = profiles[0]["d"].shape[1]
    if name == "runs_across_rows":
        # the first run spans all five adjacent rows, to the record's end
        assert n_runs == [2] and int(got[0][3 + 2 * 64]) == 5 * rspan
    if name == "borders_not_adjacent":
        assert n_runs[0] >= 6  # a row's border flags never join the next row's
    if name == "runs_over_bucket":
        assert n_runs[0] > profiles[0]["R"]
    if name in ("m6", "m32"):
        assert len({p["d"].shape[0] for p in profiles}) > 1 and all(n > 0 for n in n_runs)


def _r1_model(profiles, row_threads: int, scan_threads: int) -> np.ndarray:
    """A NumPy model of R1's three launches (``csrc/run_reduce.cu``), with
    its index arithmetic: each row staged with one flag from each
    neighbouring row, folded in per-thread chunks of ceil(rspan / threads)
    columns; each profile's row folds scanned ``scan_threads`` rows at a
    time with a running carry; each row scanned again from its carry, every
    fall written at its run's slot when below R; the header and the slots
    past n_runs from the row-carry pass."""
    def combine(a, b):  # (count, min, arg): b restarts at a rise
        take_b = b[0] > 0 or b[1] < a[1]
        return (a[0] + b[0], b[1] if take_b else a[1], b[2] if take_b else a[2])

    ident = (0, INT_MAX, 0)

    def exclusive(values):
        out, acc = [], ident
        for v in values:
            out.append(acc)
            acc = combine(acc, v)
        return out, acc

    blobs = []
    for p in profiles:
        d, starts, nvr, thr, nw, mi, R = (p[k] for k in ("d", "starts", "nvr", "thr", "nw", "mi", "R"))
        n, rspan = d.shape
        nfl = n * rspan

        def flag(row, col):
            win = int(starts[row]) + col
            return row < nvr and win < nw and win <= mi and (row | col) != 0 and int(d[row, col]) < thr

        def adjacent(row):
            return row > 0 and int(starts[row]) == int(starts[row - 1]) + rspan

        def stage(row):
            fl = [adjacent(row) and flag(row - 1, rspan - 1)] + [flag(row, c) for c in range(rspan)]
            fl.append(row + 1 < n and adjacent(row + 1) and flag(row + 1, 0))
            return fl, [int(d[row, c]) if fl[c + 1] else INT_MAX for c in range(rspan)]

        per = -(-rspan // row_threads)
        chunks = [range(t * per, min(t * per + per, rspan)) for t in range(row_threads)]

        def element(fl, val, row, c):
            return (1 if fl[c + 1] and not fl[c] else 0, val[c], row * rspan + c)

        def chunk_folds(fl, val, row):
            folds = []
            for cs in chunks:
                s = ident
                for c in cs:
                    s = combine(s, element(fl, val, row, c))
                folds.append(s)
            return folds

        # (a) row folds
        rows = [exclusive(chunk_folds(*stage(row), row))[1] for row in range(n)]
        # (b) row carries, the header and the empty slots
        carry = ident
        for r0 in range(0, n, scan_threads):
            ex, total = exclusive(rows[r0 : r0 + scan_threads])
            for j, e in enumerate(ex):
                rows[r0 + j] = combine(carry, e)
            carry = combine(carry, total)
        out = np.zeros(run_reduce_size(R), dtype=np.int64)
        n_runs = carry[0]
        out[:3] = nvr, d[0, 0], n_runs
        for j in range(n_runs, R):
            out[3 + 3 * R + j] = d[-1, -1]
        # (c) row runs
        for row in range(n):
            fl, val = stage(row)
            ex, _ = exclusive(chunk_folds(fl, val, row))
            for t, cs in enumerate(chunks):
                s = combine(rows[row], ex[t])
                for c in cs:
                    s = combine(s, element(fl, val, row, c))
                    if not fl[c + 1] or fl[c + 2] or s[0] - 1 >= R:
                        continue
                    i, arg_row = s[0] - 1, s[2] // rspan
                    win = int(starts[row]) + c
                    nxt = min(row * rspan + c + 1, nfl - 1)
                    out[3 + i] = int(starts[arg_row]) + s[2] - arg_row * rspan
                    out[3 + R + i] = s[1]
                    out[3 + 2 * R + i] = win + 1
                    out[3 + 3 * R + i] = d.reshape(-1)[nxt]
                    out[3 + 4 * R + i] = (c + 1 < rspan or (row + 1 < n and adjacent(row + 1))) and win + 1 <= mi
        blobs.append(out.astype(np.int32))
    return np.concatenate(blobs)


@pytest.mark.parametrize("name", R1_CASES)
@pytest.mark.parametrize("rspan,row_threads,scan_threads", [(64, 8, 4), (64, 256, 1024), (40, 16, 2)])
def test_kernel_model_matches_plain_twin(name, rspan, row_threads, scan_threads):
    """The model of R1's launches equals the plain twin on every case: at
    the kernel's thread counts (256 a row, 1,024 a profile's rows, more
    threads than columns), on shrunk ones (several columns a thread,
    several row blocks a profile), and at a width no thread count divides."""
    profiles = r1_case(name, rspan=rspan, seed=1)
    want = run_reduce_multi(*_torch_args(profiles)).numpy()
    np.testing.assert_array_equal(_r1_model(profiles, row_threads, scan_threads), want)


def test_kernel_model_at_the_main_path_width():
    """The model at the engine's rows of 1,024 windows and the kernel's
    thread counts, six profiles, against the plain twin."""
    profiles = r1_case("m6", rspan=1024, seed=2)
    want = run_reduce_multi(*_torch_args(profiles)).numpy()
    np.testing.assert_array_equal(_r1_model(profiles, 256, 1024), want)


def test_planned_streams_one_call_a_pass(ref_fasta, monkeypatch):
    """``ClusterScanEngine.record_streams`` makes one R1 wrapper call a
    planned pass, carrying all six profiles, and gives the JAX engine's
    (dist0, stream) on Loci.fasta; with buckets far too small, the reruns
    carry only the profiles that overflowed, one call each."""
    clusters = eliminate_null_params(cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
    jeng = jcluster.ClusterScanEngine(clusters.profiles, k=6, chunk_windows=1 << 18, use_fused=False)
    jeng.engines[0].full_fetch_windows = 0
    calls: list = []
    real = scan_kernels.run_reduce_multi

    def spy(ds, *a):
        calls.append(len(ds))
        return real(ds, *a)

    monkeypatch.setattr(scan_kernels, "run_reduce_multi", spy)
    for small in (False, True):
        port = tcluster.ClusterScanEngine(clusters.profiles, k=6, device="cpu")
        if small:
            for e in port.engines:
                e.plan_regions, e.run_bucket = 2, 4
        n_rec = 0
        for rec in as_records(str(DATA / "Loci.fasta")):
            if len(rec) - jeng.max_ws - 6 + 2 < 1:
                continue
            calls.clear()
            assert port.record_streams(rec.codes, thrs) == jeng.record_streams(rec.codes, thrs), rec.identifier
            assert calls[0] == 6  # the first pass carries every profile
            if not small:
                assert calls == [6]
            else:
                assert len(calls) > 1  # the overflowed profiles' reruns
            n_rec += 1
        assert n_rec > 0


def test_wrapper_refuses_what_it_cannot_take():
    profiles = r1_case("m6")
    args = _torch_args(profiles)
    with pytest.raises(ValueError):
        run_reduce_multi([], [], [], [], [], [], [])
    with pytest.raises(ValueError):
        run_reduce_multi(*(a * 6 for a in args))  # 36 profiles
    with pytest.raises(ValueError):
        run_reduce_multi(args[0][:1], args[1][1:2], *(a[:1] for a in args[2:]))  # starts of another length
    with pytest.raises(ValueError):
        run_reduce_multi([args[0][0].to(torch.int64)], *(a[:1] for a in args[1:]))
    with pytest.raises(ValueError):
        run_reduce_multi(*(a[:1] for a in args[:3]), [2**31], *(a[:1] for a in args[4:]))
    with pytest.raises(ValueError):
        run_reduce_multi([args[0][0].to("meta")], [args[1][0].to("meta")], [args[2][0].to("meta")],
                         *(a[:1] for a in args[3:]))
    run_reduce_multi.launches = 0
    _run_reduce_multi_plain(*args)
    run_reduce_multi(*args)
    assert run_reduce_multi.launches == 0  # CPU tensors take the twin
