"""CDEF constants and the signaled strength presets (normative tables).

The port's copy of the tables of the JAX package's ``ops/cdef.py``: the
primary and secondary taps, the per-direction tap offsets, the direction
search's divisor table and the 4-entry strength sets scaled with quality.
The search and the filter themselves run on the torch device
(``ops/device_cdef.py``).

Reference: cdef_directions (``EbCdef.c:113``), cdef_pri_taps /
cdef_sec_taps (``EbCdef.c:200``), cdef_find_dir_c's div_table
(``EbCdef.c:132``).
"""

from __future__ import annotations

import numpy as np

CDEF_VERY_LARGE = 0x4000

PRI_TAPS = ((4, 2), (3, 3))
SEC_TAPS = ((2, 1), (2, 1))

# (dy, dx) per direction, two taps (decomposed from cdef_directions :113)
DIR_OFFSETS = (
    ((-1, 1), (-2, 2)), ((0, 1), (-1, 2)), ((0, 1), (0, 2)),
    ((0, 1), (1, 2)), ((1, 1), (2, 2)), ((1, 0), (2, 1)),
    ((1, 0), (2, 0)), ((1, 0), (2, -1)),
)

_DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105])


def strength_presets(qindex: int):
    """4-entry (y, uv) strength sets (pri*4 + sec six-bit codes), scaled
    with quality; entry 0 is always off."""
    if qindex < 80:
        y = (0, 1 * 4 + 0, 2 * 4 + 1, 4 * 4 + 1)
    elif qindex < 160:
        y = (0, 2 * 4 + 1, 4 * 4 + 1, 7 * 4 + 2)
    else:
        y = (0, 2 * 4 + 1, 5 * 4 + 2, 9 * 4 + 2)
    uv = tuple(min(63, (s // 4 // 2) * 4 + min(s % 4, 3)) for s in y)
    return y, uv
