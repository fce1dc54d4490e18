"""Edge cases of R1, the planned record's run reduce
(``kmergma_tpu_torch.ops.scan_kernels.run_reduce_multi``): one call each,
made with numpy from a seed.

Each case is a list of profiles, each a dict of ``d`` (int32[n, rspan]),
``starts`` (int64[n]: ascending region starts on the rspan grid, 0 past
the planned rows, as ``_plan_regions`` gives them), ``nvr`` (the true
region count), ``thr``, ``nw``, ``mi`` and ``R``.  The CPU tests hold the
plain twin against the JAX reduce on them and a NumPy model of the kernel
against the twin; the ``cuda`` test and ``chip_smoke.py`` hold the kernel
against the twin.  Imports numpy only.
"""

import numpy as np

EVERY_WINDOW = 2**30  # the two-axis dryrun's threshold: every window below

R1_CASES = (
    "runs_across_rows",  # a run over three and more adjacent regions
    "borders_not_adjacent",  # flags at both borders of rows that do not touch
    "padded_rows",  # rows at or past nvr, start 0, below values masked
    "mi_cut",  # mi < nw - 1, in the middle of a row
    "ties",  # values from 0 to 2: ties in every run
    "runs_over_bucket",  # n_runs > R
    "regions_over_bucket",  # nvr > n (the region bucket overflowed)
    "one_row",
    "m1_random",
    "m6",  # six profiles of different n
    "m32",  # thirty-two profiles of different n
    "m33",  # one profile past 32 (a launch once took at most 32)
    "m84",  # the Alp_V set with every midpoint a cutoff: 84 profiles
)


def _starts(rng, n_valid: int, n: int, rspan: int, p_adjacent: float) -> np.ndarray:
    gaps = np.where(rng.random(max(n_valid - 1, 0)) < p_adjacent, 1, rng.integers(2, 4, max(n_valid - 1, 0)))
    starts = np.zeros(n, dtype=np.int64)
    starts[1:n_valid] = np.cumsum(gaps) * rspan
    return starts


def _profile(rng, rspan: int, n: int, *, n_valid: int | None = None, p_adjacent: float = 0.5, d_hi: int = 40,
             thr: int | None = None, tail: int | None = None, mi_cut: int = 0, R: int = 64) -> dict:
    """A profile of ``n`` rows, ``n_valid`` of them planned (all by default;
    more than n: the bucket overflowed), the record ending ``tail`` windows
    into the last planned row and the stream ``mi_cut`` windows before it."""
    n_valid = n if n_valid is None else n_valid
    starts = _starts(rng, min(n_valid, n), n, rspan, p_adjacent)
    last = int(starts[min(n_valid, n) - 1])
    tail = int(rng.integers(1, rspan + 1)) if tail is None else tail
    nw = last + tail
    d = rng.integers(0, d_hi, (n, rspan)).astype(np.int32)
    thr = int(rng.integers(d_hi // 4, 3 * d_hi // 4)) if thr is None else thr
    return dict(d=d, starts=starts, nvr=n_valid, thr=thr, nw=nw, mi=nw - 1 - mi_cut, R=R)


def r1_case(name: str, rspan: int = 64, seed: int = 0) -> list:
    """The profiles of case ``name`` at region rows of ``rspan`` windows."""
    rng = np.random.default_rng([seed, R1_CASES.index(name)])
    if name == "runs_across_rows":
        # every window below: one run from window 1 over all five adjacent
        # rows, then a second over the three rows after a gap
        p = _profile(rng, rspan, 8, p_adjacent=1.0, thr=EVERY_WINDOW, tail=rspan)
        p["starts"][5:] = p["starts"][4] + rspan * np.arange(3, 6)
        p["nw"] = int(p["starts"][-1]) + rspan - 3
        p["mi"] = p["nw"] - 1
        return [p]
    if name == "borders_not_adjacent":
        p = _profile(rng, rspan, 6, p_adjacent=0.0, tail=rspan)
        p["d"][:] = 100
        p["d"][:, :3] = rng.integers(0, 10, (6, 3))
        p["d"][:, -3:] = rng.integers(0, 10, (6, 3))
        p["thr"] = 10
        return [p]
    if name == "padded_rows":
        p = _profile(rng, rspan, 8, n_valid=3)
        p["d"][3:] = 0  # below everywhere, but past nvr
        return [p]
    if name == "mi_cut":
        return [_profile(rng, rspan, 4, p_adjacent=1.0, tail=rspan, mi_cut=rspan + rspan // 3)]
    if name == "ties":
        return [_profile(rng, rspan, 6, d_hi=3, thr=2)]
    if name == "runs_over_bucket":
        p = _profile(rng, rspan, 5, p_adjacent=1.0, R=4)
        p["d"][:] = np.where(np.arange(rspan) % 3 == 0, 1, 50)[None, :]  # a run every third window
        p["thr"] = 10
        return [p]
    if name == "regions_over_bucket":
        return [_profile(rng, rspan, 5, n_valid=9, tail=rspan)]
    if name == "one_row":
        return [_profile(rng, rspan, 1)]
    if name == "m1_random":
        return [_profile(rng, rspan, 7, p_adjacent=0.7)]
    if name == "m6":
        return [_profile(rng, rspan, n, p_adjacent=0.6, R=int(rng.choice([16, 64]))) for n in (1, 4, 2, 6, 3, 5)]
    if name == "m32":
        ns = (1, 2, 3, 5)
        return [_profile(rng, rspan, ns[i % 4], n_valid=max(1, ns[i % 4] - (i % 7 == 3)), p_adjacent=0.6, thr=EVERY_WINDOW if i % 9 == 4 else None)
                for i in range(32)]
    if name in ("m33", "m84"):
        # rows of 1-4, some past nvr, some regions over the bucket, mixed
        # run buckets, some profiles below everywhere
        ns = (1, 2, 4, 3)
        return [_profile(rng, rspan, ns[i % 4], n_valid=ns[i % 4] + (2 if i % 13 == 5 else -(i % 5 == 2 and ns[i % 4] > 1)),
                         p_adjacent=0.6, R=int(rng.choice([8, 64])), thr=EVERY_WINDOW if i % 11 == 7 else None)
                for i in range(int(name[1:]))]
    raise ValueError(f"no R1 case {name!r}")
