"""Mode and partition syntax readers (intra frames), sharing the context
derivation of ``TileContexts`` (reference writers: EncodePartitionAv1
``EbEntropyCoding.c:935``, EncodeSkipCoeffAv1 ``:1016``,
EncodeIntraLumaModeAv1 ``:1055``, chroma mode ``:1160``).
"""

from __future__ import annotations

import numpy as np

from benchmark.avref.entropy.ctx import TileContexts
from benchmark.avref.entropy.writer import SymbolReader
from benchmark.avref.utils.blocks import (BLOCK_8X8, BLOCK_128X128,
                                          BLOCK_WIDTH, PARTITION_HORZ,
                                          PARTITION_HORZ_4, PARTITION_HORZ_A,
                                          PARTITION_HORZ_B, PARTITION_SPLIT,
                                          PARTITION_VERT, PARTITION_VERT_4,
                                          PARTITION_VERT_A, PARTITION_VERT_B)

PARTITION_TYPES = 4
EXT_PARTITION_TYPES = 10
CDF_PROB_TOP = 32768


def partition_cdf_length(bsize: int) -> int:
    if bsize <= BLOCK_8X8:
        return PARTITION_TYPES
    if bsize == BLOCK_128X128:
        return EXT_PARTITION_TYPES - 2
    return EXT_PARTITION_TYPES


def _cdf_element_prob(icdf: np.ndarray, element: int) -> int:
    """Probability mass of one symbol in an inverse-CDF table
    (cdf_element_prob, EbEntropyCoding.c:902)."""
    hi = int(icdf[element - 1]) if element > 0 else CDF_PROB_TOP
    return hi - int(icdf[element])


def _gather_vert_alike(cdf: np.ndarray, bsize: int) -> np.ndarray:
    """2-symbol CDF for 'continues vertically?' at a bottom frame edge
    (partition_gather_vert_alike, EbEntropyCoding.c:922)."""
    p = CDF_PROB_TOP
    p -= _cdf_element_prob(cdf, PARTITION_VERT)
    p -= _cdf_element_prob(cdf, PARTITION_SPLIT)
    p -= _cdf_element_prob(cdf, PARTITION_HORZ_A)
    p -= _cdf_element_prob(cdf, PARTITION_VERT_A)
    p -= _cdf_element_prob(cdf, PARTITION_VERT_B)
    if bsize != BLOCK_128X128:
        p -= _cdf_element_prob(cdf, PARTITION_VERT_4)
    return np.array([CDF_PROB_TOP - p, 0, 0], dtype=np.int32)


def _gather_horz_alike(cdf: np.ndarray, bsize: int) -> np.ndarray:
    p = CDF_PROB_TOP
    p -= _cdf_element_prob(cdf, PARTITION_HORZ)
    p -= _cdf_element_prob(cdf, PARTITION_SPLIT)
    p -= _cdf_element_prob(cdf, PARTITION_HORZ_A)
    p -= _cdf_element_prob(cdf, PARTITION_HORZ_B)
    p -= _cdf_element_prob(cdf, PARTITION_VERT_A)
    if bsize != BLOCK_128X128:
        p -= _cdf_element_prob(cdf, PARTITION_HORZ_4)
    return np.array([CDF_PROB_TOP - p, 0, 0], dtype=np.int32)


def read_partition(r: SymbolReader, fc, ctxs: TileContexts, bsize: int,
                   mi_row: int, mi_col: int, mi_cols: int,
                   mi_rows: int) -> int:
    hbs = int(BLOCK_WIDTH[bsize]) >> 3
    has_rows = (mi_row + hbs) < mi_rows
    has_cols = (mi_col + hbs) < mi_cols
    ctx = ctxs.partition_ctx(mi_row, mi_col, bsize)
    if not has_rows and not has_cols:
        return PARTITION_SPLIT
    if has_rows and has_cols:
        return r.read_symbol(fc.partition[ctx], partition_cdf_length(bsize))
    if has_cols:  # bottom edge: split_or_horz (spec 5.11.4)
        cdf = _gather_vert_alike(fc.partition[ctx].copy(), bsize)
        s = r.ec.decode_symbol(cdf, 2)
        return PARTITION_SPLIT if s else PARTITION_HORZ
    cdf = _gather_horz_alike(fc.partition[ctx].copy(), bsize)
    s = r.ec.decode_symbol(cdf, 2)
    return PARTITION_SPLIT if s else PARTITION_VERT


def read_skip(r: SymbolReader, fc, ctxs: TileContexts, mi_row: int,
              mi_col: int) -> int:
    ctx = ctxs.skip_ctx(mi_row, mi_col)
    return r.read_symbol(fc.skip[ctx], 2)


def read_intra_luma_mode_kf(r: SymbolReader, fc, ctxs: TileContexts,
                            mi_row: int, mi_col: int) -> int:
    above, left = ctxs.intra_mode_ctx(mi_row, mi_col)
    return r.read_symbol(fc.kf_y_mode[above][left], 13)


# size_group_lookup for square blocks (reference EbDefinitions.h:1272)
_SIZE_GROUP = {4: 0, 8: 1, 16: 2, 32: 3, 64: 3}


def read_intra_luma_mode_if(r: SymbolReader, fc, size: int) -> int:
    return r.read_symbol(fc.if_y_mode[_SIZE_GROUP[size]], 13)


MAX_ANGLE_DELTA = 3


def read_angle_delta(r: SymbolReader, fc, mode: int) -> int:
    return r.read_symbol(fc.angle_delta[mode - 1], 7) - MAX_ANGLE_DELTA


def read_intra_chroma_mode(r: SymbolReader, fc, y_mode: int,
                           cfl_allowed: bool) -> int:
    return r.read_symbol(fc.uv_mode[int(cfl_allowed)][y_mode],
                         13 + int(cfl_allowed))
