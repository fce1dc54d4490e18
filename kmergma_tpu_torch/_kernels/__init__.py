"""Build and load the hand-written CUDA kernels of ``kmergma_tpu_torch/csrc``.

``nvcc`` compiles every ``.cu`` source (with the ``.cuh`` headers they
include), one process per source, all at once, and links them into one
shared library with a plain C interface for Hopper (``sm_90a``), loaded
with ``ctypes``.  The build runs
at first use, never at import, into ``build/kmergma_tpu_torch/`` beside the
package, keyed by a hash of the sources and flags, so a fresh checkout
builds once and later processes reuse the library.  Only sources in the
repository are compiled; nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kmergma_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: "ctypes.CDLL | None" = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def paths() -> tuple[Path, Path]:
    """(shared library, nvcc log) for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"libkmergma_kernels_{key}.so", BUILD_DIR / f"nvcc_{key}.log"


def _build() -> Path:
    """One ``nvcc -c`` per source, all started together, then one link."""
    lib_path, log_path = paths()
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    sources = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)] for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in compiles]
    log = []
    try:
        for cmd, proc in zip(compiles, procs):
            log.append(" ".join(cmd) + "\n" + proc.communicate(timeout=900)[0])
        failed = [src.name for src, proc in zip(sources, procs) if proc.returncode != 0]
        if not failed:
            link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
            log.append(" ".join(link) + "\n" + proc.stdout)
            failed = [] if proc.returncode == 0 else ["the link"]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    log_path.write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
    os.replace(tmp, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)  # a host int array (``int_array``)
    lib.kmg_match_counts.restype = i
    lib.kmg_match_counts.argtypes = [p, ll, i, i, i, p, p]
    lib.kmg_pair_multi.restype = i
    lib.kmg_pair_multi.argtypes = [p, ll, i, i, ip, i, i, i, i, i, i, p, p, p]
    lib.kmg_pair_depth_codes.restype = i
    lib.kmg_pair_depth_codes.argtypes = [p, i, i, i, i, i, i, i, i, p, p, p]
    lib.kmg_pair_depth_kcodes.restype = i
    lib.kmg_pair_depth_kcodes.argtypes = [p, ll, i, i, i, i, i, p, p]
    lib.kmg_cluster_tables_in_smem.restype = i
    lib.kmg_cluster_tables_in_smem.argtypes = [i, i, i, i, i]
    lib.kmg_cluster_launch_shape.restype = i
    lib.kmg_cluster_launch_shape.argtypes = [i, i, i, i, i, i, i, ip]
    lib.kmg_fused_cluster_bitmaps.restype = i
    lib.kmg_cluster_count_bytes.restype = i
    lib.kmg_cluster_count_bytes.argtypes = [i, i, i]
    lib.kmg_fused_cluster_bitmaps.argtypes = [
        p, p, i, i, i, ip, ip, ip, ip, i, i, i, i, p, p, p, p, i, p,
    ]
    lib.kmg_lookup_roundtrip.restype = i
    lib.kmg_lookup_roundtrip.argtypes = [p, i, i, i, i, i, p, p]
    lib.kmg_hash_genome.restype = i
    lib.kmg_hash_genome.argtypes = [p, ll, ctypes.c_uint, p]
    lib.kmg_align_dp.restype = i
    lib.kmg_align_dp.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, p, p, p, p]
    lib.kmg_align_launch_info.restype = i
    lib.kmg_align_launch_info.argtypes = [i, i, i, ip]
    lib.kmg_run_reduce.restype = i
    lib.kmg_run_reduce.argtypes = [i, i, p, p, ll, i, p, ip]
    lib.kmg_run_reduce_state_bytes.restype = ll
    lib.kmg_run_reduce_state_bytes.argtypes = [ll]
    lib.kmg_error_string.restype = ctypes.c_char_p
    lib.kmg_error_string.argtypes = [i]
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises if it cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(_build())))
    return _LIB


def int_array(values) -> "ctypes.Array":
    """A host C int array for the kernels' per-group and per-cluster scalars."""
    values = [int(v) for v in values]
    return (ctypes.c_int * len(values))(*values)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = load().kmg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
