"""ctypes binding + on-demand build of the native C++ IO library.

Builds ``kmergma_tpu_torch/native/fastaio.cpp`` with g++ on first use (no
pip / pybind11 dependency) into ``build/kmergma_tpu_torch/`` beside the
package, keyed by a hash of the source and flags (as the CUDA kernels are,
``_kernels``), and exposes a fast mmap-based fasta loader.  Falls back
silently to the pure-Python parser if no toolchain is available -
everything works without the native path, it is a data-loader accelerator
for multi-gigabase inputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIB: "ctypes.CDLL | None | bool" = None  # None = not tried, False = unavailable

_SRC = Path(__file__).resolve().parent.parent / "native" / "fastaio.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kmergma_tpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
#: a parse of a smaller file runs on one thread (``parse_threads``)
PARALLEL_MIN_BYTES = 4 << 20
#: the least bytes a parse thread takes
MIN_CHUNK_BYTES = 1 << 20


def _so_path() -> Path:
    """The shared object for the current source and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libfastaio_{h.hexdigest()[:16]}.so"


def _build_lib() -> "ctypes.CDLL | None":
    so_path = _so_path()
    try:
        if not so_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
            subprocess.run(
                ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        lib.fasta_plan, lib.xoshiro256pp_fill  # newest symbols check (stale .so -> AttributeError)
    except (OSError, subprocess.SubprocessError, AttributeError):
        return None

    lib.fasta_plan.restype = ctypes.c_void_p
    lib.fasta_plan.argtypes = [ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_long, ctypes.c_void_p]
    lib.fasta_fill.restype = None
    lib.fasta_fill.argtypes = [ctypes.c_void_p] * 7
    lib.fasta_free.restype = None
    lib.fasta_free.argtypes = [ctypes.c_void_p]
    lib.encode_seq.restype = ctypes.c_long
    lib.encode_seq.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p]
    lib.scan_rolling_i64.restype = ctypes.c_int
    lib.scan_rolling_i64.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.semiglobal_batch.restype = ctypes.c_int
    lib.semiglobal_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int,            # a_idx, m
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,  # b_flat, b_off, b_len, n_subj
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # nuc44, gap_open, gap_extend
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ops_flat, ops_off, n_ops
        ctypes.c_void_p, ctypes.c_int,            # scores, n_threads
    ]
    lib.xoshiro256pp_fill.restype = None
    lib.xoshiro256pp_fill.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
    return lib


def semiglobal_batch_native(a_idx: np.ndarray, bs: "list[np.ndarray]", nuc44: np.ndarray, gap_open: int, gap_extend: int):
    """Native threaded batch aligner.

    a_idx int8[m], bs = per-subject int8 letter-index arrays.  Returns
    (scores int64[n], ops int8 flat in traceback order, ops_off, n_ops) or
    None when the native library is unavailable.  Raises on a DP
    invariant violation (never observed; the fuzz suite pins equality).
    """
    lib = get_lib()
    if lib is None:
        return None
    m = int(a_idx.shape[0])
    n_subj = len(bs)
    b_len = np.asarray([b.shape[0] for b in bs], dtype=np.int64)
    b_off = np.zeros(n_subj, dtype=np.int64)
    np.cumsum(b_len[:-1], out=b_off[1:])
    b_flat = np.concatenate(bs).astype(np.int8) if n_subj else np.zeros(0, np.int8)
    caps = m + b_len + 2
    ops_off = np.zeros(n_subj, dtype=np.int64)
    np.cumsum(caps[:-1], out=ops_off[1:])
    ops_flat = np.empty(int(caps.sum()), dtype=np.int8)
    n_ops = np.empty(n_subj, dtype=np.int64)
    scores = np.empty(n_subj, dtype=np.int64)
    a8 = np.ascontiguousarray(a_idx, dtype=np.int8)
    nuc = np.ascontiguousarray(nuc44, dtype=np.int32)
    rc = lib.semiglobal_batch(
        a8.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(m),
        b_flat.ctypes.data_as(ctypes.c_void_p),
        b_off.ctypes.data_as(ctypes.c_void_p),
        b_len.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(n_subj),
        nuc.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(gap_open), ctypes.c_int(gap_extend),
        ops_flat.ctypes.data_as(ctypes.c_void_p),
        ops_off.ctypes.data_as(ctypes.c_void_p),
        n_ops.ctypes.data_as(ctypes.c_void_p),
        scores.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(min(8, os.cpu_count() or 1)),
    )
    if rc != 0:
        raise AssertionError("native traceback: inconsistent DP cell")
    return scores, ops_flat, ops_off, n_ops


def get_lib() -> "ctypes.CDLL | None":
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _build_lib() or False
    return _LIB or None


def xoshiro256pp_native(state: "tuple[int, int, int, int]", n: int) -> "tuple[np.ndarray, tuple] | None":
    """The next ``n`` Xoshiro256++ outputs (uint64[n]) of the stream at the
    four state words ``state``, and the four words ``n`` single draws leave;
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.array(state, dtype=np.uint64)
    out = np.empty(n, dtype=np.uint64)
    lib.xoshiro256pp_fill(words.ctypes.data, ctypes.c_long(n), out.ctypes.data)
    return out, tuple(int(w) for w in words)


def parse_threads(n_bytes: int) -> int:
    """Threads for a parse of ``n_bytes``: one below ``PARALLEL_MIN_BYTES``,
    where starting threads costs more than the parse, else as many as the
    process may run on, up to 8 (as the aligner takes)."""
    if n_bytes < PARALLEL_MIN_BYTES:
        return 1
    cpus = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    return min(8, cpus or 1)


def load_fasta_native(path: str, *, _threads: "int | None" = None, _min_chunk: int = MIN_CHUNK_BYTES):
    """Parse a fasta file with the native library, in place and threaded.

    Returns (codes, seq_bytes, offsets, lengths, descriptions, counters)
    where ``codes`` is one contiguous int8 array of all records' 2-bit codes and
    ``seq_bytes`` the raw (case-preserved, whitespace-stripped) sequence
    bytes at the same offsets, or None if the native path is unavailable.
    ``counters`` holds ``threads`` (chunks parsed in parallel), ``lines``
    and ``slow_lines`` (lines that failed the one-check-a-line fast path).
    Raises ValueError on a file with no record, else on an invalid
    nucleotide, naming the first in file order.

    The file is mapped, not copied.  ``_threads`` (else ``parse_threads``)
    chunks of at least ``_min_chunk`` bytes are parsed at once; chunk t
    starts one past the first '\\n' at or after byte n * t / T.
    """
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        n = os.fstat(fh.fileno()).st_size
        if n == 0:
            empty = np.zeros(0, np.int64)
            return np.zeros(0, np.int8), np.zeros(0, np.uint8), empty, empty, [], {"threads": 0, "lines": 0, "slow_lines": 0}
        threads = parse_threads(n) if _threads is None else _threads
        info = np.zeros(8, np.int64)
        plan = lib.fasta_plan(fh.fileno(), n, threads, _min_chunk, info.ctypes.data)
        if not plan:
            raise OSError(f"cannot map {path}")
        try:
            nr, n_seq, n_desc, bad, lines, slow, used, any_record = (int(v) for v in info)
            if not any_record:
                raise ValueError(f"no fasta records found in {path}")
            if bad >= 0:
                raise ValueError(f"invalid nucleotide character at byte {bad} of {path} (only A/C/G/T/N supported)")
            codes = np.empty(n_seq, dtype=np.int8)
            seq_bytes = np.empty(n_seq, dtype=np.uint8)
            offsets = np.empty(nr, dtype=np.int64)
            lengths = np.empty(nr, dtype=np.int64)
            desc_buf = np.empty(n_desc, dtype=np.uint8)
            desc_lens = np.empty(nr, dtype=np.int64)
            lib.fasta_fill(plan, *(a.ctypes.data for a in (codes, seq_bytes, offsets, lengths, desc_buf, desc_lens)))
        finally:
            lib.fasta_free(plan)
    raw = desc_buf.tobytes()
    ends = np.cumsum(desc_lens).tolist()
    descs = [raw[e - d : e].decode("ascii") for e, d in zip(ends, desc_lens.tolist())]
    return codes, seq_bytes, offsets, lengths, descs, {"threads": used, "lines": lines, "slow_lines": slow}


def scan_rolling_i64_native(
    codes: np.ndarray, s_profile: np.ndarray, k: int, ws: int, r: int
) -> "np.ndarray | None":
    """Exact int64 scaled window distances via the native O(1)/bp rolling
    recurrence (the reference's own algorithm, GenomeMiner.jl:42-77).

    Returns int64[n - ws + 1], or None if the native library is
    unavailable.  Raises OverflowError if D would exceed int64.
    """
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    s64 = np.ascontiguousarray(s_profile, dtype=np.int64)
    nw = codes.shape[0] - ws + 1
    out = np.empty(max(nw, 1), dtype=np.int64)
    rc = lib.scan_rolling_i64(
        codes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(codes.shape[0]),
        s64.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(s64.shape[0]),
        ctypes.c_int(k),
        ctypes.c_int(ws),
        ctypes.c_longlong(r),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise OverflowError("scaled window distance exceeds int64")
    return out
