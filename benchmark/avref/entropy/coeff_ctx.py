"""Coefficient-coding context derivation (shared by encoder and decoder).

Normative context rules of AV1 residual coding (spec 5.11.39 coeffs syntax;
reference behavior: ``EbRateDistortionCost.c:248-470`` get_nz_map_ctx /
get_br_ctx, ``EbEntropyCoding.c:224-480`` eob tokens / GetTxbCtx).

The nz/br context maps are *vectorized over all positions of a transform
block* — this is the piece that runs as a batched device op in the two-phase
entropy design.
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark.avref.utils.blocks import (TX_16X32, TX_16X64, TX_32X16,
                                          TX_32X32, TX_32X64, TX_64X16,
                                          TX_64X32, TX_64X64, TX_CLASS_2D,
                                          TX_CLASS_VERT, TX_HEIGHT, TX_WIDTH,
                                          TX_SIZE_SQR, TX_SIZE_SQR_UP)

NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12
BR_CDF_SIZE = 4
MAX_BASE_BR_RANGE = COEFF_BASE_RANGE + NUM_BASE_LEVELS + 1  # 15
COEFF_CONTEXT_BITS = 6
COEFF_CONTEXT_MASK = 63
SIG_COEF_CONTEXTS_2D = 26

# eob class tables (reference EbEntropyCoding.c:186-222)
EOB_OFFSET_BITS = np.array([0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9])
EOB_GROUP_START = np.array([0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513])


def adjusted_tx_size(tx_size: int) -> int:
    """64-point dims clamp to 32 for coefficient coding."""
    return {TX_64X64: TX_32X32, TX_64X32: TX_32X32, TX_32X64: TX_32X32,
            TX_16X64: TX_16X32, TX_64X16: TX_32X16}.get(tx_size, tx_size)


def txb_dims(tx_size: int):
    adj = adjusted_tx_size(tx_size)
    w, h = int(TX_WIDTH[adj]), int(TX_HEIGHT[adj])
    return w, h, int(np.log2(w))


def txs_ctx(tx_size: int) -> int:
    return (int(TX_SIZE_SQR[tx_size]) + int(TX_SIZE_SQR_UP[tx_size]) + 1) >> 1


def eob_multi_size(tx_size: int) -> int:
    w, h, _ = txb_dims(tx_size)
    return int(np.log2(w * h)) - 4


@functools.lru_cache(maxsize=None)
def nz_map_ctx_offset_2d(w: int, h: int) -> np.ndarray:
    """TX_CLASS_2D ctx offset per raster position (reference
    av1_nz_map_ctx_offset ``EbRateDistortionCost.c:248``, generated from its
    row/col pattern; pinned against the literal table in tests)."""
    r = np.minimum(np.arange(h), 4)[:, None]
    c = np.minimum(np.arange(w), 4)[None, :]
    s = r + c
    base = np.where(s == 0, 0, np.where(s <= 1, 1, np.where(s <= 3, 6, 21)))
    if h > w:   # tall: first two rows -> 11
        base = np.where((r < 2) & (s > 0), 11, base)
    elif w > h:  # wide: first two cols -> 16
        base = np.where((c < 2) & (s > 0), 16, base)
    return base.reshape(-1)


def nz_map_ctx_at(levels: np.ndarray, pos: int, tx_size: int,
                  tx_class: int) -> int:
    """Scalar nz ctx for one raster position (decoder-side incremental)."""
    h, w = levels.shape
    r, c = pos // w, pos % w

    def lv(dy, dx):
        rr, cz = r + dy, c + dx
        return min(int(levels[rr, cz]), 3) if rr < h and cz < w else 0
    mag = lv(0, 1) + lv(1, 0)
    if tx_class == TX_CLASS_2D:
        mag += lv(1, 1) + lv(0, 2) + lv(2, 0)
    elif tx_class == TX_CLASS_VERT:
        mag += lv(2, 0) + lv(3, 0) + lv(4, 0)
    else:
        mag += lv(0, 2) + lv(0, 3) + lv(0, 4)
    ctx = min((mag + 1) >> 1, 4)
    if tx_class == TX_CLASS_2D:
        if pos == 0:
            return 0
        return ctx + int(nz_map_ctx_offset_2d(w, h)[pos])
    idx = r if tx_class == TX_CLASS_VERT else c
    return ctx + SIG_COEF_CONTEXTS_2D + 5 * min(idx, 2)


def br_ctx_at(levels: np.ndarray, pos: int, tx_class: int) -> int:
    h, w = levels.shape
    r, c = pos // w, pos % w

    def lv(dy, dx):
        rr, cz = r + dy, c + dx
        return int(levels[rr, cz]) if rr < h and cz < w else 0
    mag = lv(0, 1) + lv(1, 0)
    if tx_class == TX_CLASS_2D:
        mag += lv(1, 1)
    elif tx_class == TX_CLASS_VERT:
        mag += lv(2, 0)
    else:
        mag += lv(0, 2)
    mag = min((mag + 1) >> 1, 6)
    if pos == 0:
        return mag
    if tx_class == TX_CLASS_2D:
        return mag + (7 if (r < 2 and c < 2) else 14)
    if tx_class == TX_CLASS_VERT:
        return mag + (7 if r == 0 else 14)
    return mag + (7 if c == 0 else 14)


def eob_base_ctx(scan_idx: np.ndarray, n: int) -> np.ndarray:
    """coeff_base_eob context for the last coeff (spec: by scan position)."""
    return np.where(scan_idx == 0, 0,
                    np.where(scan_idx <= n // 8, 1,
                             np.where(scan_idx <= n // 4, 2, 3)))


