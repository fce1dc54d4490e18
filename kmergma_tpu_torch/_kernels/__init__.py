"""Build and load the hand-written CUDA kernels of ``kmergma_tpu_torch/csrc``.

``nvcc`` compiles every ``.cu`` source into one shared library with a plain
C interface for Hopper (``sm_90a``), loaded with ``ctypes``.  The build runs
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

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
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"libkmergma_kernels_{key}.so", BUILD_DIR / f"nvcc_{key}.log"


def _build() -> Path:
    lib_path, log_path = paths()
    if lib_path.exists():
        return lib_path
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    log_path.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kmg_fused_bitmaps.restype = i
    lib.kmg_fused_bitmaps.argtypes = [
        p, p, i, i, i, i, i, i, i, i, i, ll, p, p, p, i, p,
    ]
    lib.kmg_match_counts.restype = i
    lib.kmg_match_counts.argtypes = [p, ll, i, i, i, p, p]
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


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = load().kmg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
