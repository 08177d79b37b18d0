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

from svt_av1_tpu_torch.utils.trace import setup_step

_AVAIL_DATA = Path(__file__).parent / "data" / "avail_tables.npz"
_MAX_MIB_LOG2 = 5


@functools.lru_cache(maxsize=1)
def _avail_tables():
    with setup_step("tables"), np.load(_AVAIL_DATA) as z:
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


def has_top_right_wh_vec(mi_row, mi_col, w4: int, h4: int,
                         mi_cols: int, sb_mi: int = 16,
                         vert_ab=None) -> np.ndarray:
    """Vectorized ``has_top_right_wh`` over [B] mi coords (same block
    shape for all): one table gather instead of B Python calls.
    ``vert_ab``: optional [B] bool array marking square VERT_A/B members."""
    mi_row = np.asarray(mi_row, dtype=np.int64)
    mi_col = np.asarray(mi_col, dtype=np.int64)
    bw_log2 = w4.bit_length() - 1
    bh_log2 = h4.bit_length() - 1
    blk_row = (mi_row & (sb_mi - 1)) >> bh_log2
    blk_col = (mi_col & (sb_mi - 1)) >> bw_log2
    idx = (blk_row << (_MAX_MIB_LOG2 - bw_log2)) + blk_col
    tab = _tr_table(w4, h4, False)
    out = ((tab[idx >> 3] >> (idx & 7)) & 1).astype(bool)
    if vert_ab is not None and np.any(vert_ab):
        vtab = _tr_table(w4, h4, True)
        vout = ((vtab[idx >> 3] >> (idx & 7)) & 1).astype(bool)
        out = np.where(np.asarray(vert_ab, dtype=bool), vout, out)
    out = np.where(((blk_col + 1) << bw_log2) >= sb_mi, False, out)
    out = np.where(blk_row == 0, True, out)
    return np.where((mi_row == 0) | (mi_col + w4 >= mi_cols), False, out)


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


def has_bottom_left_wh_vec(mi_row, mi_col, w4: int, h4: int,
                           mi_rows: int, sb_mi: int = 16,
                           vert_ab=None) -> np.ndarray:
    """Vectorized ``has_bottom_left_wh`` over [B] mi coords."""
    mi_row = np.asarray(mi_row, dtype=np.int64)
    mi_col = np.asarray(mi_col, dtype=np.int64)
    bw_log2 = w4.bit_length() - 1
    bh_log2 = h4.bit_length() - 1
    blk_row = (mi_row & (sb_mi - 1)) >> bh_log2
    blk_col = (mi_col & (sb_mi - 1)) >> bw_log2
    idx = (blk_row << (_MAX_MIB_LOG2 - bw_log2)) + blk_col
    tab = _bl_table(w4, h4, False)
    out = ((tab[idx >> 3] >> (idx & 7)) & 1).astype(bool)
    if vert_ab is not None and np.any(vert_ab):
        vtab = _bl_table(w4, h4, True)
        vout = ((vtab[idx >> 3] >> (idx & 7)) & 1).astype(bool)
        out = np.where(np.asarray(vert_ab, dtype=bool), vout, out)
    out = np.where(((blk_row + 1) << bh_log2) >= sb_mi, False, out)
    out = np.where(blk_col == 0, (blk_row << bh_log2) + h4 < sb_mi, out)
    return np.where((mi_col == 0) | (mi_row + h4 >= mi_rows), False, out)


# --- VERT_A/B membership from the leaf map ------------------------------------

def leaf_square_tshape(leaf_sizes: dict, r: int, c: int, w4: int, h4: int,
                       mi_rows: int, mi_cols: int):
    """Parent partition type iff the square leaf at tile-relative mi
    (r, c) is a square member of a PARTITION_VERT_A/VERT_B parent, else
    None. Rect members keep base behavior everywhere, so only squares
    are reported."""
    if w4 != h4 or w4 < 2 or w4 >= 16:
        return None      # ext partitions need parents > 8x8; SB is 64
    from svt_av1_tpu_torch.pipeline import common
    from svt_av1_tpu_torch.utils.blocks import (PARTITION_VERT_A,
                                          PARTITION_VERT_B)
    p4 = w4 * 2
    pr, pc = r - (r % p4), c - (c % p4)
    part, leaves = common.infer_partition(leaf_sizes, pr, pc, p4 * 4,
                                          mi_rows, mi_cols)
    if part not in (PARTITION_VERT_A, PARTITION_VERT_B) or not leaves:
        return None
    if any(lr == r and lc == c and wh == (w4 * 4, h4 * 4)
           for lr, lc, wh in leaves):
        return part
    return None


def leaf_vert_ab(leaf_sizes: dict, r: int, c: int, w4: int, h4: int,
                 mi_rows: int, mi_cols: int) -> bool:
    """True iff the square leaf at tile-relative mi (r, c) is a square
    member of a PARTITION_VERT_A/VERT_B parent, in which case the
    mixed-vertical availability tables apply (reference
    get_has_tr_table/get_has_bl_table, EbIntraPrediction.c:5691/5879)."""
    return leaf_square_tshape(leaf_sizes, r, c, w4, h4, mi_rows,
                              mi_cols) is not None


def leaf_vert_ab_flags(leaf_sizes: dict, rs, cs, w4: int, h4: int,
                       mi_rows: int, mi_cols: int) -> np.ndarray:
    """Vectorized ``leaf_vert_ab`` over parallel [B] coord arrays (same
    block shape for all). Cheap early-out for shapes that can never be
    VERT_A/B square members."""
    rs = np.asarray(rs)
    cs = np.asarray(cs)
    if w4 != h4 or w4 < 2 or w4 >= 16:
        return np.zeros(rs.shape, dtype=bool)
    return np.array([leaf_vert_ab(leaf_sizes, int(r), int(c), w4, h4,
                                  mi_rows, mi_cols)
                     for r, c in zip(rs, cs)], dtype=bool)
