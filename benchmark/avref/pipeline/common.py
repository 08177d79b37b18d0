"""Shared helpers for the frame encode/decode walks.

The encoder (``pipeline.intra``) and the verification decoder
(``pipeline.decode``) both use these so geometry decisions cannot diverge.
"""

from __future__ import annotations

import numpy as np

from benchmark.avref.utils.blocks import (MODE_TO_TXFM, SQUARE_BLOCK_OF_SIZE,
                                          TX_HEIGHT, TX_SIZE_SQR_UP, TX_WIDTH,
                                          TX_32X32, DCT_DCT)
from benchmark.avref.entropy import tx_sets


def pixel_dtype(bd: int):
    import numpy as np
    return np.uint16 if bd > 8 else np.uint8


# --- resolution-bucketed plane pads ------------------------------------------
# Fused whole-frame device programs bake plane dims into their compile
# keys, so every new resolution used to pay the full cold-compile wall
# (the reference starts instantly at any size, user guide :127). Padding
# the compute planes up to a canonical bucket lets nearby resolutions
# share the compiled program set; the pad is compute-only — coded
# geometry (mi grid, sequence header, MV clamp semantics via the
# valid-core reference pads) is unchanged. Luma dims; chroma is half.
_PLANE_BUCKETS = ((1280, 768), (1920, 1088), (2560, 1472), (3840, 2176))


def chroma_tx_type(uv_mode: int, tx_size: int,
                   reduced_tx_set: bool) -> int:
    """compute_tx_type for intra chroma (spec 8.3.2 / reference
    EbTransforms GetTransformType): Mode_To_Txfm unless outside the
    allowed set or the tx is 64-sized."""
    if int(TX_SIZE_SQR_UP[tx_size]) > TX_32X32:
        return DCT_DCT
    tt = int(MODE_TO_TXFM[uv_mode])
    set_type = tx_sets.ext_tx_set_type(tx_size, False, reduced_tx_set)
    if not tx_sets.EXT_TX_USED[set_type][tt]:
        return DCT_DCT
    return tt


def coded_dims(tx_size: int):
    """(coded_w, coded_h): 64-point dimensions keep only 32 coefficients."""
    return (min(32, int(TX_WIDTH[tx_size])),
            min(32, int(TX_HEIGHT[tx_size])))


def square_bsize(size_px: int) -> int:
    return SQUARE_BLOCK_OF_SIZE[size_px]


# (w_px, h_px) -> BLOCK_* enum (squares + the 2:1/4:1 rects partitions make)
_RECT_BSIZE = {(4, 4): 0, (4, 8): 1, (8, 4): 2, (8, 8): 3, (8, 16): 4,
               (16, 8): 5, (16, 16): 6, (16, 32): 7, (32, 16): 8,
               (32, 32): 9, (32, 64): 10, (64, 32): 11, (64, 64): 12,
               (4, 16): 16, (16, 4): 17, (8, 32): 18, (32, 8): 19,
               (16, 64): 20, (64, 16): 21}

# (w_px, h_px) -> TX_* (max_txsize_rect_lookup for TX_MODE_LARGEST)
_RECT_TX = {(4, 4): 0, (8, 8): 1, (16, 16): 2, (32, 32): 3, (64, 64): 4,
            (4, 8): 5, (8, 4): 6, (8, 16): 7, (16, 8): 8, (16, 32): 9,
            (32, 16): 10, (32, 64): 11, (64, 32): 12,
            (4, 16): 13, (16, 4): 14, (8, 32): 15, (32, 8): 16,
            (16, 64): 17, (64, 16): 18}


def leaf_wh(v):
    """Normalize a leaf-map value: int size -> (size, size)."""
    return (v, v) if isinstance(v, (int, np.integer)) else tuple(v)


def rect_bsize(w_px: int, h_px: int) -> int:
    return _RECT_BSIZE[(w_px, h_px)]


def tx_size_for_rect(w_px: int, h_px: int, plane: int) -> int:
    """TX_MODE_LARGEST tx for a (possibly rect) block; chroma dims are
    already halved by the caller and capped at 32 per side."""
    if plane == 0:
        return _RECT_TX[(w_px, h_px)]
    return _RECT_TX[(min(32, w_px), min(32, h_px))]


def tile_rects(sb_cols: int, sb_rows: int, mi_cols: int, mi_rows: int,
               cols_log2: int, rows_log2: int):
    """Uniform tile rectangles (spec 5.9.15 uniform spacing), raster order.
    Returns [(mi_r0, mi_c0, mi_rows_t, mi_cols_t, sb_rows_t, sb_cols_t)]."""
    tw_sb = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
    th_sb = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
    rects = []
    for r0 in range(0, sb_rows, th_sb):
        for c0 in range(0, sb_cols, tw_sb):
            sb_r = min(th_sb, sb_rows - r0)
            sb_c = min(tw_sb, sb_cols - c0)
            mi_r0, mi_c0 = r0 * 16, c0 * 16
            rects.append((mi_r0, mi_c0,
                          min(sb_r * 16, mi_rows - mi_r0),
                          min(sb_c * 16, mi_cols - mi_c0),
                          sb_r, sb_c))
    return rects


def chroma_tx_type_inter(luma_tt: int, tx_size: int,
                         reduced_tx_set: bool) -> int:
    """compute_tx_type for inter chroma (spec 8.3.2): inherit the
    co-located luma block's tx type, demoted to DCT when outside the
    chroma tx size's allowed set or for 64-point transforms."""
    if int(TX_SIZE_SQR_UP[tx_size]) > TX_32X32:
        return DCT_DCT
    set_type = tx_sets.ext_tx_set_type(tx_size, True, reduced_tx_set)
    if not tx_sets.EXT_TX_USED[set_type][luma_tt]:
        return DCT_DCT
    return int(luma_tt)
