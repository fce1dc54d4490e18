"""The edge shapes of K5 (``codes_pair_multi``), shared by the NumPy model
of its route (``test_torch_pair_routes.py``, CPU) and its ``cuda`` test
(``test_torch_kernels.py``, on the card): group counts 1, 3, 4 and 32,
widths that differ by more than 16, depths 0, 1, 14, 15, 16 and deeper
(the plain route), k = 5, 6, 10 (int32 compares, and warps whose codes
fit 16 bits) and 16, ragged last tiles, nkc > nt, codes shorter than the
tiles read, codes off a 16-byte boundary, units that go round a block
more than once and the 2048-position tile of long records."""

import numpy as np

#: name -> (k, ws_tuple, depth, n codes, nt beyond n - max(ws) + 1, nkc
#: beyond nt + max(ws) - k, offset of the codes in their buffer, on CPU)
K5_CASES = {
    "g1_d16": (6, (289,), 16, 9_000, 0, 0, 0, True),
    "g3_d16_60kb": (6, (288, 289, 290), 16, 60_000, 0, 0, 0, True),
    "g32_spread_d16": (6, tuple(range(100, 740, 20)), 16, 7_000, 0, 0, 3, True),
    "g3_spread_d15_nkc": (6, (21, 77, 300), 15, 5_000, 0, 40, 0, True),
    "d0": (6, (288, 289, 290), 0, 5_000, 0, 0, 0, True),
    "k5_d1": (5, (96, 96, 101, 120), 1, 5_000, 0, 0, 1, True),
    "d14_w15": (6, (20, 40), 14, 4_100, 0, 7, 0, True),
    "deep_d40": (6, (288, 289, 290), 40, 5_000, 0, 0, 0, True),
    "deep_d255": (6, (300, 400), 255, 4_000, 0, 0, 5, True),
    "k10_d16": (10, (120, 140), 16, 9_000, 0, 0, 0, True),
    "k10_deep_d30": (10, (120, 140), 30, 4_000, 0, 0, 0, True),
    "k16_d16": (16, (300, 310), 16, 4_000, 0, 0, 0, True),
    "short_codes": (6, (288, 289, 290), 16, 3_000, 500, 100, 0, True),
    "wide_units_loop": (6, (9_000, 9_100), 16, 20_000, 0, 0, 0, True),
    "long_tile_2048": (6, (288, 289, 290), 16, 600_000, 0, 0, 0, False),
}


def k5_case(name: str) -> tuple:
    """(k, ws_tuple, depth, codes int8[n], nt, nkc, offset) of a case."""
    k, ws_tuple, depth, n, nt_extra, nkc_extra, offset, _cpu = K5_CASES[name]
    nt = n - max(ws_tuple) + 1 + nt_extra
    nkc = nt + max(ws_tuple) - k + nkc_extra
    return k, ws_tuple, depth, k5_codes(n, seed=n + depth + k), nt, nkc, offset


def k5_codes(n: int, seed: int) -> np.ndarray:
    """Seeded 2-bit codes with a low-complexity quarter and a run of one
    code (so pairs match, and k = 10 has warps whose K codes fit 16 bits)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    q = n // 4
    codes[q : 2 * q] = np.tile(rng.integers(0, 4, 7, dtype=np.int8), -(-q // 7))[:q]
    codes[n // 2 : n // 2 + min(3_000, n // 4)] = 0
    return codes
