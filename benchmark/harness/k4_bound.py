"""The least time one H100 could take for the K4 launches of a strobemer
call, from its record lengths, with the peaks of ``roofline.py``.

The strobemer span engine runs K4 (csrc/pair_depth.cu) once a record, on
the record's strobe codes at k = 1 and pair depth w - 1 (exact mode), the
shape that takes K4's sliding-histogram route: O(1) integer work a
position, so device memory binds.  Of a record of n bp, scanned at
windowsize ws, K4 reads one code byte and writes an int32 pair delta and
an int32 K code for each of its n - ws - 1 transitions, and a few more
codes and K codes for the first window: 9 bytes a transition is the least
it moves.  Its 7 or so integer operations a position (two histogram
reads, a subtraction, two updates) take a twenty-fifth of that time at the
32-bit rate.
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S, INT32_OPS_PER_S

#: bytes K4 moves a transition: the code read, the pair delta and the K code written
BYTES_PER_TRANSITION = 1 + 4 + 4
#: integer operations of the sliding histogram a transition
OPS_PER_TRANSITION = 7


def k4_least_ms(record_lengths: list[int], ws: int) -> float:
    """The least time, in ms, of K4 over the records of one call: the
    bytes over the memory rate or the operations over the 32-bit rate,
    whichever is longer; records without a transition run no K4."""
    nt = sum(n - ws - 1 for n in record_lengths if n - ws - 1 >= 1)
    return max(nt * BYTES_PER_TRANSITION / HBM_BYTES_PER_S, nt * OPS_PER_TRANSITION / INT32_OPS_PER_S) * 1e3
