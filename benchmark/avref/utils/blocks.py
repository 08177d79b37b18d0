"""Block / transform geometry: sizes, partitions, scan orders.

AV1 geometry constants re-derived from the spec (reference tables:
``EbTransforms.h:318ff`` scans, ``EbDefinitions.h`` block size enums). Scan
orders are *generated* — square default scans are the classic alternating
zigzag, rectangular ones are unidirectional up-right diagonals — and unit
tests pin them against spec values.
"""

from __future__ import annotations

import functools

import numpy as np

# --- block sizes (AV1 BLOCK_* enum order) --------------------------------------
BLOCK_4X4 = 0
BLOCK_4X8 = 1
BLOCK_8X4 = 2
BLOCK_8X8 = 3
BLOCK_8X16 = 4
BLOCK_16X8 = 5
BLOCK_16X16 = 6
BLOCK_16X32 = 7
BLOCK_32X16 = 8
BLOCK_32X32 = 9
BLOCK_32X64 = 10
BLOCK_64X32 = 11
BLOCK_64X64 = 12
BLOCK_64X128 = 13
BLOCK_128X64 = 14
BLOCK_128X128 = 15
BLOCK_4X16 = 16
BLOCK_16X4 = 17
BLOCK_8X32 = 18
BLOCK_32X8 = 19
BLOCK_16X64 = 20
BLOCK_64X16 = 21
BLOCK_SIZES_ALL = 22

BLOCK_WIDTH = np.array([4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64,
                        128, 128, 4, 16, 8, 32, 16, 64])
BLOCK_HEIGHT = np.array([4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128,
                         64, 128, 16, 4, 32, 8, 64, 16])

SQUARE_BLOCK_OF_SIZE = {4: BLOCK_4X4, 8: BLOCK_8X8, 16: BLOCK_16X16,
                        32: BLOCK_32X32, 64: BLOCK_64X64, 128: BLOCK_128X128}

# --- partition types ------------------------------------------------------------
PARTITION_NONE = 0
PARTITION_HORZ = 1
PARTITION_VERT = 2
PARTITION_SPLIT = 3
PARTITION_HORZ_A = 4
PARTITION_HORZ_B = 5
PARTITION_VERT_A = 6
PARTITION_VERT_B = 7
PARTITION_HORZ_4 = 8
PARTITION_VERT_4 = 9
EXT_PARTITION_TYPES = 10

# --- intra modes ------------------------------------------------------------------
DC_PRED = 0
V_PRED = 1
H_PRED = 2
D45_PRED = 3
D135_PRED = 4
D113_PRED = 5
D157_PRED = 6
D203_PRED = 7
D67_PRED = 8
SMOOTH_PRED = 9
SMOOTH_V_PRED = 10
SMOOTH_H_PRED = 11
PAETH_PRED = 12
INTRA_MODES = 13
UV_CFL_PRED = 13

# base angles for the 8 directional modes (V..D67), degrees
MODE_TO_ANGLE = {V_PRED: 90, H_PRED: 180, D45_PRED: 45, D135_PRED: 135,
                 D113_PRED: 113, D157_PRED: 157, D203_PRED: 203, D67_PRED: 67}

# --- tx sizes (square first, matching AV1 TX_SIZE enum) ---------------------------
TX_4X4 = 0
TX_8X8 = 1
TX_16X16 = 2
TX_32X32 = 3
TX_64X64 = 4
TX_4X8 = 5
TX_8X4 = 6
TX_8X16 = 7
TX_16X8 = 8
TX_16X32 = 9
TX_32X16 = 10
TX_32X64 = 11
TX_64X32 = 12
TX_4X16 = 13
TX_16X4 = 14
TX_8X32 = 15
TX_32X8 = 16
TX_16X64 = 17
TX_64X16 = 18
TX_SIZES_ALL = 19

TX_WIDTH = np.array([4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16,
                     8, 32, 16, 64])
TX_HEIGHT = np.array([4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4,
                      32, 8, 64, 16])

# Tx_Size_Sqr / Tx_Size_Sqr_Up (spec tables)
TX_SIZE_SQR = np.array([TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64,
                        TX_4X4, TX_4X4, TX_8X8, TX_8X8, TX_16X16, TX_16X16,
                        TX_32X32, TX_32X32, TX_4X4, TX_4X4, TX_8X8, TX_8X8,
                        TX_16X16, TX_16X16])
TX_SIZE_SQR_UP = np.array([TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64,
                           TX_8X8, TX_8X8, TX_16X16, TX_16X16, TX_32X32,
                           TX_32X32, TX_64X64, TX_64X64, TX_16X16, TX_16X16,
                           TX_32X32, TX_32X32, TX_64X64, TX_64X64])

# max square tx size for a (square) block size
MAX_TX_SIZE_OF_BLOCK = {4: TX_4X4, 8: TX_8X8, 16: TX_16X16, 32: TX_32X32,
                        64: TX_64X64}

# --- tx types -----------------------------------------------------------------------
DCT_DCT = 0
ADST_DCT = 1
DCT_ADST = 2
ADST_ADST = 3
FLIPADST_DCT = 4
DCT_FLIPADST = 5
FLIPADST_FLIPADST = 6
ADST_FLIPADST = 7
FLIPADST_ADST = 8
IDTX = 9
V_DCT = 10
H_DCT = 11
V_ADST = 12
H_ADST = 13
V_FLIPADST = 14
H_FLIPADST = 15
TX_TYPES = 16

# tx class (spec: used by coefficient context derivation)
TX_CLASS_2D = 0
TX_CLASS_HORIZ = 1
TX_CLASS_VERT = 2
TX_TYPE_CLASS = np.array([TX_CLASS_2D] * 10 +
                         [TX_CLASS_VERT, TX_CLASS_HORIZ,
                          TX_CLASS_VERT, TX_CLASS_HORIZ,
                          TX_CLASS_VERT, TX_CLASS_HORIZ])

# intra mode -> tx type (spec Mode_To_Txfm, used for chroma)
MODE_TO_TXFM = np.array([
    DCT_DCT,    # DC
    ADST_DCT,   # V
    DCT_ADST,   # H
    DCT_DCT,    # D45
    ADST_ADST,  # D135
    ADST_DCT,   # D113
    DCT_ADST,   # D157
    DCT_ADST,   # D203
    ADST_DCT,   # D67
    ADST_ADST,  # SMOOTH
    ADST_DCT,   # SMOOTH_V
    DCT_ADST,   # SMOOTH_H
    ADST_ADST,  # PAETH
    DCT_DCT,    # UV_CFL
])


# --- scan orders -----------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def zigzag_scan(w: int, h: int) -> np.ndarray:
    """Default scan: alternating zigzag for squares, up-right diagonal for
    rectangles (matches spec Default_Scan tables)."""
    order = []
    if w == h:
        for d in range(w + h - 1):
            cells = [(r, d - r) for r in range(max(0, d - w + 1),
                                               min(h, d + 1))]
            if d % 2 == 0:
                cells.reverse()  # even diagonals run bottom-left -> top-right
            order.extend(cells)
    else:
        for d in range(w + h - 1):
            # top-right -> bottom-left, always
            for r in range(max(0, d - w + 1), min(h, d + 1)):
                order.append((r, d - r))
    return np.array([r * w + c for r, c in order], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def mrow_scan(w: int, h: int) -> np.ndarray:
    return np.arange(w * h, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def mcol_scan(w: int, h: int) -> np.ndarray:
    return np.arange(w * h, dtype=np.int32).reshape(h, w).T.reshape(-1)


def get_scan(tx_size: int, tx_type: int) -> np.ndarray:
    """Scan order for (tx_size, tx_type); coefficients beyond 32 in either
    dimension are not scanned (spec: 64-point transforms keep 32x32 coeffs)."""
    w = min(32, int(TX_WIDTH[tx_size]))
    h = min(32, int(TX_HEIGHT[tx_size]))
    cls = int(TX_TYPE_CLASS[tx_type])
    if cls == TX_CLASS_2D:
        return zigzag_scan(w, h)
    # 1D transforms: vertical class scans row-major, horizontal column-major
    # (reference av1_scan_orders, EbTransforms.h:3336ff)
    if cls == TX_CLASS_VERT:
        return mrow_scan(w, h)
    return mcol_scan(w, h)


# --- superblock / partition helpers ------------------------------------------------


