"""R1, the planned record's run reduce (``scan_kernels.run_reduce_multi``).

Its plain twin, profile by profile, against the JAX package's below mask
(``_below_and_words``) and jitted ``_device_run_reduce`` on the edge cases
of ``tests/_r1_cases.py`` (33 and 84 profiles among them); a NumPy model
of the kernel's one launch (a block a row from a ticket, the row's fold
published, a decoupled look-back, with the kernel's index arithmetic on
shrunk thread and lane counts, its blocks interleaved in random orders)
against the twin; ``_planned_streams`` on the CPU
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
from kmergma_tpu_torch.ops.scan_kernels import _r1_descriptors, _run_reduce_multi_plain, run_reduce_multi, run_reduce_size

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
    if name in ("m6", "m32", "m33", "m84"):
        assert len({p["d"].shape[0] for p in profiles}) > 1 and all(n > 0 for n in n_runs)


def _r1_model(profiles, threads: int, lanes: int = 32, per_launch: int = 510, seed: "int | None" = None) -> np.ndarray:
    """A NumPy model of R1's one launch (``csrc/run_reduce.cu``), with its
    index arithmetic: the profiles in launches of ``per_launch``, a block
    a region row of every profile taking its row from the launch's ticket;
    rows past a profile's live rows (max(1, min(nvr, n))) leave at once; a
    live row staged with one flag from each neighbouring row, folded in
    per-thread chunks of ceil(rspan / threads) columns and a block scan;
    its fold published (row 0: as its inclusive prefix), then a look-back
    over the profile's earlier rows ``lanes`` at a time, folding each
    window up to the nearest row with an inclusive prefix; its inclusive
    prefix published, then every fall written at its run's slot when below
    R, and at the last live row the header and the slots past n_runs.

    The blocks are generators that yield at each publication and at each
    wait for a flag.  ``seed`` None runs them one after another in ticket
    order; a seed interleaves them at random (a block starts only after
    the one with the ticket before it), so each look-back finds its own
    mix of rows with and without an inclusive prefix."""
    def combine(a, b):  # (count, min, arg): b restarts at a rise
        take_b = b[0] > 0 or b[1] < a[1]
        return (a[0] + b[0], b[1] if take_b else a[1], b[2] if take_b else a[2])

    ident = (0, INT_MAX, 0)
    unwritten = -(2**40)
    blobs = [np.full(run_reduce_size(p["R"]), unwritten, dtype=np.int64) for p in profiles]
    row_offs = np.cumsum([0] + [p["d"].shape[0] for p in profiles])
    status: dict = {}  # call row -> (state, payload); 1 the row's fold, 2 its inclusive prefix

    def block(pi, row):
        p = profiles[pi]
        d, starts, nvr, thr, nw, mi, R = (p[k] for k in ("d", "starts", "nvr", "thr", "nw", "mi", "R"))
        n, rspan = d.shape
        live = max(1, min(nvr, n))
        if row >= live:
            return
        nfl = n * rspan

        def flag(r, col):
            win = int(starts[r]) + col
            return r < nvr and win < nw and win <= mi and (r | col) != 0 and int(d[r, col]) < thr

        def adjacent(r):
            return r > 0 and int(starts[r]) == int(starts[r - 1]) + rspan

        fl = [adjacent(row) and flag(row - 1, rspan - 1)] + [flag(row, c) for c in range(rspan)]
        fl.append(row + 1 < n and adjacent(row + 1) and flag(row + 1, 0))
        base = row * rspan
        per = -(-rspan // threads)
        chunks = [range(min(t * per, rspan), min(t * per + per, rspan)) for t in range(threads)]

        def element(c):
            return (1 if fl[c + 1] and not fl[c] else 0, int(d[row, c]) if fl[c + 1] else INT_MAX, base + c)

        ex, total = [], ident
        for cs in chunks:
            ex.append(total)
            for c in cs:
                total = combine(total, element(c))
        grow = int(row_offs[pi]) + row
        prefix = ident
        if row == 0:
            status[grow] = (2, total)
        else:
            status[grow] = (1, total)
            yield
            first, hi = grow - row, grow - 1
            while True:
                rows_ = [hi - lane for lane in range(lanes)]
                while not all(j < first or j in status for j in rows_):
                    yield  # a lane spins on its row's flag
                seen = [(2, ident) if j < first else status[j] for j in rows_]
                stop = next((lane for lane, (state, _v) in enumerate(seen) if state == 2), lanes - 1)
                w = ident
                for lane in range(stop, -1, -1):  # in row order
                    w = combine(w, seen[lane][1])
                prefix = combine(w, prefix)
                if seen[stop][0] == 2:
                    break
                hi -= lanes
                yield
            status[grow] = (2, combine(prefix, total))
        yield
        out = blobs[pi]
        dflat = d.reshape(-1)
        for t, cs in enumerate(chunks):
            s = combine(prefix, ex[t])
            for c in cs:
                s = combine(s, element(c))
                if not fl[c + 1] or fl[c + 2] or s[0] - 1 >= R:
                    continue
                i, arg_row = s[0] - 1, s[2] // rspan
                win = int(starts[row]) + c
                out[3 + i] = int(starts[arg_row]) + s[2] - arg_row * rspan
                out[3 + R + i] = s[1]
                out[3 + 2 * R + i] = win + 1
                out[3 + 3 * R + i] = dflat[min(base + c + 1, nfl - 1)]
                out[3 + 4 * R + i] = (c + 1 < rspan or (row + 1 < n and adjacent(row + 1))) and win + 1 <= mi
        if row == live - 1:
            n_runs = combine(prefix, total)[0]
            out[:3] = nvr, d[0, 0], n_runs
            for j in range(n_runs, R):
                out[3 + j] = out[3 + R + j] = out[3 + 2 * R + j] = out[3 + 4 * R + j] = 0
                out[3 + 3 * R + j] = d[-1, -1]

    rng = None if seed is None else np.random.default_rng(seed)
    for g0 in range(0, len(profiles), per_launch):
        tickets = [(pi, row) for pi in range(g0, min(g0 + per_launch, len(profiles)))
                   for row in range(profiles[pi]["d"].shape[0])]
        gens, started = [], 0
        while started < len(tickets) or gens:
            choices = len(gens) + (started < len(tickets))
            pick = 0 if rng is None else int(rng.integers(choices))
            if pick == len(gens):  # the next ticket is taken
                gens.append(block(*tickets[started]))
                started += 1
            try:
                next(gens[pick])
            except StopIteration:
                gens.pop(pick)
    blob = np.concatenate(blobs)
    assert (blob != unwritten).all(), "a slot of the output was never written"
    return blob.astype(np.int32)


@pytest.mark.parametrize("name", R1_CASES)
@pytest.mark.parametrize("rspan,threads,lanes", [(64, 8, 2), (64, 256, 32), (40, 16, 3)])
def test_kernel_model_matches_plain_twin(name, rspan, threads, lanes):
    """The model of R1's launch equals the plain twin on every case: at the
    kernel's thread and lane counts (256 a row, more threads than columns,
    32 rows a look-back window), on shrunk ones (several columns a thread,
    look-back windows of 2 and 3 rows, so the walk crosses windows), at a
    width no thread count divides, and with the profiles in launches of 5."""
    profiles = r1_case(name, rspan=rspan, seed=1)
    want = run_reduce_multi(*_torch_args(profiles)).numpy()
    np.testing.assert_array_equal(_r1_model(profiles, threads, lanes), want)
    np.testing.assert_array_equal(_r1_model(profiles, threads, lanes, per_launch=5), want)


@pytest.mark.parametrize("name", ["runs_across_rows", "runs_over_bucket", "regions_over_bucket", "m6", "m84"])
@pytest.mark.parametrize("seed", range(4))
def test_kernel_model_any_finishing_order(name, seed):
    """The model with its blocks interleaved at random, so a look-back finds
    any mix of earlier rows with only a fold or with an inclusive prefix,
    gives the plain twin's output whichever row finishes first."""
    profiles = r1_case(name, rspan=40, seed=5 + seed)
    want = run_reduce_multi(*_torch_args(profiles)).numpy()
    np.testing.assert_array_equal(_r1_model(profiles, 16, lanes=3, per_launch=7, seed=seed), want)


def test_kernel_model_at_the_main_path_width():
    """The model at the engine's rows of 1,024 windows and the kernel's
    thread and lane counts, six profiles, against the plain twin, in
    ticket order and interleaved."""
    profiles = r1_case("m6", rspan=1024, seed=2)
    want = run_reduce_multi(*_torch_args(profiles)).numpy()
    np.testing.assert_array_equal(_r1_model(profiles, 256), want)
    np.testing.assert_array_equal(_r1_model(profiles, 256, seed=0), want)


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
    many = [a * 6 for a in args]  # 36 profiles: more than 32 are taken
    np.testing.assert_array_equal(run_reduce_multi(*many).numpy(), np.tile(run_reduce_multi(*args).numpy(), 6))
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


def test_descriptors_point_into_live_copies():
    """R1's descriptors for strided distances and starts: each pointer is
    the start of a contiguous copy that the wrapper keeps until the launch
    call returns, equal to its input, and no two copies share memory (a
    copy freed early would hand its block to the next profile's); the
    output offsets, widths and rows are each profile's own."""
    profiles = r1_case("m6", rspan=64, seed=9)
    ds, starts, nvrs, thrs, nws, mis, buckets = _torch_args(profiles)
    ds_t = [d.t().contiguous().t() for d in ds]
    starts_s = [torch.stack([s, s], dim=1)[:, 0] for s in starts]
    assert sum(not d.is_contiguous() for d in ds_t) >= 2 and sum(not s.is_contiguous() for s in starts_s) >= 2
    desc, kept, size, n_rows = _r1_descriptors(ds_t, starts_s, nvrs, thrs, nws, mis, buckets)
    assert desc.dtype == np.int64 and desc.shape == (6, 9) and len(kept) == 6
    spans = []
    for row, (d, st), d_in, st_in, nvr in zip(desc, kept, ds, starts, nvrs):
        assert d.is_contiguous() and st.is_contiguous() and torch.equal(d, d_in) and torch.equal(st, st_in)
        assert (row[0], row[1], row[2]) == (d.data_ptr(), st.data_ptr(), nvr.data_ptr())
        spans += [(d.data_ptr(), d.data_ptr() + 4 * d.numel()), (st.data_ptr(), st.data_ptr() + 8 * st.numel())]
    spans.sort()
    assert all(a_end <= b for (_a, a_end), (b, _b_end) in zip(spans, spans[1:]))
    sizes = [run_reduce_size(R) for R in buckets]
    assert desc[:, 3].tolist() == [4 * sum(sizes[:i]) for i in range(6)] and size == sum(sizes)
    assert desc[:, 4:].tolist() == [[nw, mi, thr, R, d.shape[0]] for nw, mi, thr, R, d in zip(nws, mis, thrs, buckets, ds)]
    assert n_rows == sum(d.shape[0] for d in ds)
    np.testing.assert_array_equal(run_reduce_multi(ds_t, starts_s, nvrs, thrs, nws, mis, buckets).numpy(),
                                  run_reduce_multi(ds, starts, nvrs, thrs, nws, mis, buckets).numpy())


def test_chip_smoke_r1_alone_on_cpu(capsys):
    """``chip_smoke.py --r1-alone`` (R1 alone on captured planned passes)
    on CPU tensors at a small size: every pass captured with its profile
    count, timed, no device time off the card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", DATA.parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.r1_kernels("cpu", label="cpu", contig_bp=60_000)
    assert {name: v["profiles"] for name, v in out.items()} == {
        "R1_single_m1": 1, "R1_cluster_m6": 6, "R1_fragment_m6": 6, "R1_many_m35": 35, "R1_many_m84": 84}
    assert all(v["rows"] >= v["profiles"] and 0 < v["ms_min"] <= v["ms"] for v in out.values())
    assert all(v["device_ms"] is None and v["device_profiled_ms"] is None for v in out.values())
    assert "R1_many_m84: R1 alone on 84 profiles" in capsys.readouterr().out
