"""The least time one H100 could take for a call's scan, from its shapes.

Copies of chip_smoke.py's ``HBM_BYTES_PER_S``, ``INT32_OPS_PER_S``,
``PROFILE_OPS_PER_WINDOW`` and ``bound`` at commit 643846b.
"""

from __future__ import annotations

#: one H100 SXM's published peaks (NVIDIA's data sheet): device memory
#: bytes per second, and the non-tensor 32-bit rate, the FP32 one (the
#: data sheet gives no INT32 rate), taken as the ceiling of the kernels'
#: 32-bit integer compares and adds
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
#: integer operations a profile adds to each window of the scan beside
#: the pair tests that all profiles share: two products, two subtractions,
#: the delta's add, the prefix sum's add and the threshold compare; the
#: distance recurrence is O(1) a window, so this is the least the exact
#: scan of a window against one profile can do
PROFILE_OPS_PER_WINDOW = 7


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(ms, what binds): the larger of the bytes over the memory rate and
    the operations over the 32-bit rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_least_ms(record_lengths: list[int], windowsizes: list[int]) -> float:
    """The exact scan of a call's records against its profiles: each
    genome code read once (one byte), and every profile's recurrence at
    every window of a record long enough for it."""
    n_bytes = sum(n for n in record_lengths if n >= min(windowsizes))
    n_ops = sum(max(n - ws + 1, 0) for n in record_lengths for ws in windowsizes) * PROFILE_OPS_PER_WINDOW
    return bound(n_bytes, n_ops)[0]
