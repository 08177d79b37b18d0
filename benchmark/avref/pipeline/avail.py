"""Above-right / bottom-left reference availability (closed form).

The spec tracks a per-superblock BlockDecoded map; for square blocks whose
transform covers the whole block (this encoder's shape), availability
reduces to a closed form over the z-order position within the superblock —
verified bit-for-bit against the reference's has_tr/has_bl tables
(``EbIntraPrediction.c:5574ff``, has_top_right :5706, has_bottom_left
:5894) in tests. One flag pair per leaf serves all three planes (the
chroma derivation collapses to the luma one for 1:1 leaves in 4:2:0).
"""

from __future__ import annotations


def _morton(r: int, c: int) -> int:
    v = 0
    for b in range(6):
        v |= ((c >> b) & 1) << (2 * b)
        v |= ((r >> b) & 1) << (2 * b + 1)
    return v


def has_top_right(mi_row: int, mi_col: int, s4: int, mi_cols: int,
                  sb_mi: int = 16) -> bool:
    """s4: block size in mi units (square). Tile-relative mi coords."""
    if mi_row == 0:
        return False                      # no above row
    if mi_col + s4 >= mi_cols:
        return False                      # no right neighbor in frame
    blk_row = (mi_row & (sb_mi - 1)) // s4
    blk_col = (mi_col & (sb_mi - 1)) // s4
    if blk_row == 0:
        return True                       # top row of SB: above-right SB done
    if (blk_col + 1) * s4 >= sb_mi:
        return False                      # rightmost column of SB
    return _morton(blk_row - 1, blk_col + 1) < _morton(blk_row, blk_col)


def has_bottom_left(mi_row: int, mi_col: int, s4: int, mi_rows: int,
                    sb_mi: int = 16) -> bool:
    if mi_col == 0:
        return False                      # no left column
    if mi_row + s4 >= mi_rows:
        return False                      # no bottom neighbor in frame
    blk_row = (mi_row & (sb_mi - 1)) // s4
    blk_col = (mi_col & (sb_mi - 1)) // s4
    if blk_col == 0:
        return (blk_row + 1) * s4 < sb_mi  # left SB: until SB bottom
    if (blk_row + 1) * s4 >= sb_mi:
        return False                      # bottom row of SB
    return _morton(blk_row + 1, blk_col - 1) < _morton(blk_row, blk_col)


# --- general (rect-aware) availability from the reference bitmap tables -------
# (extracted by tools/extract_avail_tables.py from EbIntraPrediction.c
# has_tr_*/has_bl_*; lookup logic mirrors has_top_right :5706 /
# has_bottom_left :5894 at block level: row_off = col_off = 0 and the
# transform spanning the whole block.)
import functools
from pathlib import Path

import numpy as np

_AVAIL_DATA = Path(__file__).parent / "data" / "avail_tables.npz"
_MAX_MIB_LOG2 = 5


@functools.lru_cache(maxsize=1)
def _avail_tables():
    with np.load(_AVAIL_DATA) as z:
        return {k: z[k] for k in z.files}


# (w4, h4) -> BLOCK_* enum index (square + 2:1 rects down to 8x4)
_BSIZE_OF_WH4 = {(1, 1): 0, (1, 2): 1, (2, 1): 2, (2, 2): 3, (2, 4): 4,
                 (4, 2): 5, (4, 4): 6, (4, 8): 7, (8, 4): 8, (8, 8): 9,
                 (8, 16): 10, (16, 8): 11, (16, 16): 12, (1, 4): 16,
                 (4, 1): 17, (2, 8): 18, (8, 2): 19, (4, 16): 20,
                 (16, 4): 21}


def _tr_table(w4: int, h4: int, vert_ab: bool) -> np.ndarray:
    """Square members of VERT_A/VERT_B use the mixed-vertical coding-order
    tables (reference get_has_tr_table, EbIntraPrediction.c:5691); rect
    members and every other partition use the base tables."""
    bs = _BSIZE_OF_WH4[(w4, h4)]
    if vert_ab and w4 == h4 and f"has_tr_vert_{bs}" in _avail_tables():
        return _avail_tables()[f"has_tr_vert_{bs}"]
    return _avail_tables()[f"has_tr_{bs}"]


def _bl_table(w4: int, h4: int, vert_ab: bool) -> np.ndarray:
    """Reference get_has_bl_table (EbIntraPrediction.c:5879)."""
    bs = _BSIZE_OF_WH4[(w4, h4)]
    if vert_ab and w4 == h4 and f"has_bl_vert_{bs}" in _avail_tables():
        return _avail_tables()[f"has_bl_vert_{bs}"]
    return _avail_tables()[f"has_bl_{bs}"]


def has_top_right_wh(mi_row: int, mi_col: int, w4: int, h4: int,
                     mi_cols: int, sb_mi: int = 16,
                     vert_ab: bool = False) -> bool:
    """Rect-aware top-right availability (tile-relative mi coords)."""
    if mi_row == 0 or mi_col + w4 >= mi_cols:
        return False
    bw_log2 = w4.bit_length() - 1
    bh_log2 = h4.bit_length() - 1
    blk_row = (mi_row & (sb_mi - 1)) >> bh_log2
    blk_col = (mi_col & (sb_mi - 1)) >> bw_log2
    if blk_row == 0:
        return True
    if ((blk_col + 1) << bw_log2) >= sb_mi:
        return False
    idx = (blk_row << (_MAX_MIB_LOG2 - bw_log2)) + blk_col
    tab = _tr_table(w4, h4, vert_ab)
    return bool((tab[idx >> 3] >> (idx & 7)) & 1)


def has_bottom_left_wh(mi_row: int, mi_col: int, w4: int, h4: int,
                       mi_rows: int, sb_mi: int = 16,
                       vert_ab: bool = False) -> bool:
    if mi_col == 0 or mi_row + h4 >= mi_rows:
        return False
    bw_log2 = w4.bit_length() - 1
    bh_log2 = h4.bit_length() - 1
    blk_row = (mi_row & (sb_mi - 1)) >> bh_log2
    blk_col = (mi_col & (sb_mi - 1)) >> bw_log2
    if blk_col == 0:
        return (blk_row << bh_log2) + h4 < sb_mi
    if ((blk_row + 1) << bh_log2) >= sb_mi:
        return False
    idx = (blk_row << (_MAX_MIB_LOG2 - bw_log2)) + blk_col
    tab = _bl_table(w4, h4, vert_ab)
    return bool((tab[idx >> 3] >> (idx & 7)) & 1)


# --- VERT_A/B membership from the leaf map ------------------------------------


