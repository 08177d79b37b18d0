"""Tile-level neighbor context state for syntax coding.

Re-expresses the reference's NeighborArrayUnit machinery
(``EbNeighborArrays.c``; context derivations ``EbEntropyCoding.c:327-445``
GetTxbCtx, ``:935-1010`` EncodePartitionAv1, ``:1080-1100`` intra mode ctx) as
plain per-tile arrays: an above row + left column per context kind, plus a
full mode-info map for mode/skip neighbor lookups. Both the encoder and the
mirror decoder drive the same class, so context divergence is structurally
impossible.

Coordinates are tile-relative. Luma positions are in mi (4px) units; entropy
contexts are per plane in that plane's 4px units.
"""

from __future__ import annotations

import numpy as np

from benchmark.avref.utils.blocks import (BLOCK_HEIGHT, BLOCK_WIDTH, DC_PRED,
                                      TX_HEIGHT, TX_WIDTH)
from benchmark.avref.entropy.coeff_ctx import COEFF_CONTEXT_BITS, \
    COEFF_CONTEXT_MASK

# intra_mode_context (reference EbDefinitions.h:1174)
INTRA_MODE_CTX = np.array([0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0],
                          dtype=np.int32)

# skip_contexts[min][max] (reference EbEntropyCoding.c:382)
_SKIP_CONTEXTS = np.array([[1, 2, 2, 2, 3],
                           [1, 4, 4, 4, 5],
                           [1, 4, 4, 4, 5],
                           [1, 4, 4, 4, 5],
                           [1, 4, 4, 4, 6]], dtype=np.int32)

PARTITION_PLOFFSET = 4

# python-int twins of the size tables: the per-txb context math runs
# hundreds of thousands of times per frame on <=16-element slices, where
# numpy scalar/ufunc overhead dominates — plain ints are ~10x faster
_TXW = tuple(int(v) for v in TX_WIDTH)
_TXH = tuple(int(v) for v in TX_HEIGHT)
_BW = tuple(int(v) for v in BLOCK_WIDTH)
_BH = tuple(int(v) for v in BLOCK_HEIGHT)
_SKIP_CTX = tuple(tuple(int(v) for v in row) for row in _SKIP_CONTEXTS)


def _part_ctx_value(size_px: int) -> int:
    """partition_context_lookup (reference EbDefinitions.h:1233): bit k set
    means 'everything down to size 2^(k+3) was split here'."""
    return 32 - (size_px // 4)


class TileContexts:
    """Mutable neighbor-context state while coding one tile."""

    def __init__(self, mi_cols: int, mi_rows: int, num_planes: int = 3,
                 subsampling: tuple = (1, 1)):
        self.mi_cols = mi_cols
        self.mi_rows = mi_rows
        ss_x, ss_y = subsampling
        self.ss = [(0, 0), (ss_x, ss_y), (ss_x, ss_y)][:num_planes]
        # entropy-context bytes per plane (cul_level | dc-sign<<6) —
        # python lists: the slices read/written per txb are tiny
        self.ectx_above = [[0] * ((mi_cols + 1) >> sx)
                           for sx, _ in self.ss]
        self.ectx_left = [[0] * ((mi_rows + 1) >> sy)
                          for _, sy in self.ss]
        # partition contexts (one byte per mi col / mi row)
        self.part_above = np.zeros(mi_cols, dtype=np.int32)
        self.part_left = np.zeros(mi_rows, dtype=np.int32)
        # mode-info maps for mode/skip neighbor lookups
        self.mi_mode = np.full((mi_rows, mi_cols), DC_PRED, dtype=np.int32)
        self.mi_skip = np.zeros((mi_rows, mi_cols), dtype=np.int32)

    # --- coefficient (txb) contexts -------------------------------------------
    def txb_ctx(self, plane: int, plane_bsize: int, tx_size: int,
                x4: int, y4: int):
        """(txb_skip_ctx, dc_sign_ctx) for a tx block at plane-unit (x4, y4).

        Mirrors GetTxbCtx (EbEntropyCoding.c:327): dc_sign from the sign
        bits of neighbor context bytes; skip ctx from cul_level bytes.
        Pure-int hot path (called once per txb)."""
        tw = _TXW[tx_size] >> 2
        th = _TXH[tx_size] >> 2
        above = self.ectx_above[plane][x4:x4 + tw] if y4 != 0 else None
        left = self.ectx_left[plane][y4:y4 + th] if x4 != 0 else None

        dc_sign = 0
        for arr in (above, left):
            if arr is not None:
                for v in arr:
                    s = v >> COEFF_CONTEXT_BITS
                    if s == 2:
                        dc_sign += 1
                    elif s == 1:
                        dc_sign -= 1
        dc_sign_ctx = 2 if dc_sign > 0 else (1 if dc_sign < 0 else 0)

        if plane == 0:
            if (_BW[plane_bsize] == _TXW[tx_size]
                    and _BH[plane_bsize] == _TXH[tx_size]):
                return 0, dc_sign_ctx
            top = 0
            if above is not None:
                for v in above:
                    top |= v
                top &= COEFF_CONTEXT_MASK
            lft = 0
            if left is not None:
                for v in left:
                    lft |= v
                lft &= COEFF_CONTEXT_MASK
            mx = min(top | lft, 4)
            mn = min(top, lft)
            if mn > 4:
                mn = 4
            return _SKIP_CTX[mn][mx], dc_sign_ctx
        # chroma: 7/10 offset + (above any nonzero) + (left any nonzero)
        ctx_base = int(above is not None and any(above)) \
            + int(left is not None and any(left))
        tx_pels = _TXW[tx_size] * _TXH[tx_size]
        blk_pels = _BW[plane_bsize] * _BH[plane_bsize]
        ctx_offset = 10 if blk_pels > tx_pels else 7
        return ctx_base + ctx_offset, dc_sign_ctx

    def update_txb_ctx(self, plane: int, x4: int, y4: int, tx_size: int,
                       cul_level: int) -> None:
        cul = int(cul_level)
        ea = self.ectx_above[plane]
        el = self.ectx_left[plane]
        # clamp like the numpy slice-assign did (lists would extend)
        ew = min(x4 + (_TXW[tx_size] >> 2), len(ea))
        eh = min(y4 + (_TXH[tx_size] >> 2), len(el))
        ea[x4:ew] = [cul] * (ew - x4)
        el[y4:eh] = [cul] * (eh - y4)

    # --- partition contexts -----------------------------------------------------
    def partition_ctx(self, mi_row: int, mi_col: int, bsize: int) -> int:
        """Context index into partition_cdf (EncodePartitionAv1
        EbEntropyCoding.c:963-976)."""
        above_ctx = int(self.part_above[mi_col]) if mi_row > 0 else 0
        left_ctx = int(self.part_left[mi_row]) if mi_col > 0 else 0
        bsl = int(np.log2(BLOCK_WIDTH[bsize] // 4)) - 1  # rel. BLOCK_8X8
        above = (above_ctx >> bsl) & 1
        left = (left_ctx >> bsl) & 1
        return (left * 2 + above) + bsl * PARTITION_PLOFFSET

    def update_partition_ctx(self, mi_row: int, mi_col: int, bsize: int,
                             subsize: int) -> None:
        """Set neighbor bytes over the *bsize* extent with *subsize* values
        (reference EbEntropyCoding.c:4758-4766)."""
        bw = int(BLOCK_WIDTH[bsize]) >> 2
        bh = int(BLOCK_HEIGHT[bsize]) >> 2
        self.part_above[mi_col:mi_col + bw] = \
            _part_ctx_value(int(BLOCK_WIDTH[subsize]))
        self.part_left[mi_row:mi_row + bh] = \
            _part_ctx_value(int(BLOCK_HEIGHT[subsize]))

    # --- mode / skip contexts ----------------------------------------------------
    def intra_mode_ctx(self, mi_row: int, mi_col: int):
        """(above_ctx, left_ctx) for kf_y_mode (EbEntropyCoding.c:1080-1100);
        DC when the neighbor is unavailable."""
        above_mode = int(self.mi_mode[mi_row - 1, mi_col]) if mi_row > 0 \
            else DC_PRED
        left_mode = int(self.mi_mode[mi_row, mi_col - 1]) if mi_col > 0 \
            else DC_PRED
        return int(INTRA_MODE_CTX[above_mode]), int(INTRA_MODE_CTX[left_mode])

    def skip_ctx(self, mi_row: int, mi_col: int) -> int:
        above = int(self.mi_skip[mi_row - 1, mi_col]) if mi_row > 0 else 0
        left = int(self.mi_skip[mi_row, mi_col - 1]) if mi_col > 0 else 0
        return above + left

    def set_mi(self, mi_row: int, mi_col: int, bsize: int, mode: int,
               skip: int) -> None:
        bw = int(BLOCK_WIDTH[bsize]) >> 2
        bh = int(BLOCK_HEIGHT[bsize]) >> 2
        self.mi_mode[mi_row:mi_row + bh, mi_col:mi_col + bw] = mode
        self.mi_skip[mi_row:mi_row + bh, mi_col:mi_col + bw] = skip
