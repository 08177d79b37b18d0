"""Shared helpers for the frame encode/decode walks.

The encoder (``pipeline.intra``) and the verification decoder
(``pipeline.decode``) both use these so geometry decisions cannot diverge.
"""

from __future__ import annotations

import numpy as np

from svt_av1_tpu_torch.utils.blocks import (MAX_TX_SIZE_OF_BLOCK, MODE_TO_TXFM,
                                      SQUARE_BLOCK_OF_SIZE, TX_HEIGHT,
                                      TX_SIZE_SQR_UP, TX_WIDTH, TX_32X32,
                                      DCT_DCT)
from svt_av1_tpu_torch.bitstream import obu
from svt_av1_tpu_torch.entropy import tx_sets


def sequence_header(cfg) -> obu.SequenceHeader:
    """The stream's sequence header for ``cfg``: film grain is present
    when a strength or a full parameter set is configured."""
    return obu.SequenceHeader(width=cfg.width, height=cfg.height,
                              bit_depth=cfg.bit_depth,
                              enable_cdef=cfg.enable_cdef,
                              enable_restoration=cfg.enable_restoration,
                              enable_intra_edge_filter=(
                                  cfg.enable_intra_edge_filter),
                              film_grain_params_present=(
                                  cfg.film_grain_strength > 0
                                  or cfg.film_grain_params is not None),
                              color_primaries=cfg.color_primaries,
                              transfer_characteristics=(
                                  cfg.transfer_characteristics),
                              matrix_coefficients=cfg.matrix_coefficients,
                              color_range=cfg.color_range,
                              **obu.order_hint_fields(cfg.enable_tmvp))


def frame_grain(cfg, seq, film_grain=None):
    """A frame header's film grain parameters: ``film_grain`` when given
    (the Encoder resolves the stream's once), else resolved from ``cfg``
    when ``seq`` carries grain; None when it does not."""
    if film_grain is not None or not seq.film_grain_params_present:
        return film_grain
    from svt_av1_tpu_torch.ops import grain as grain_ops
    return grain_ops.resolved_params(cfg)


def pixel_dtype(bd: int):
    import numpy as np
    return np.uint16 if bd > 8 else np.uint8


def pad_to_multiple(plane: np.ndarray, multiple: int) -> np.ndarray:
    """Edge-replicate pad to a multiple (reference PadPicture semantics)."""
    h, w = plane.shape
    ph = -h % multiple
    pw = -w % multiple
    if ph == 0 and pw == 0:
        return plane
    return np.pad(plane, ((0, ph), (0, pw)), mode="edge")


# --- resolution-bucketed plane pads ------------------------------------------
# Fused whole-frame device programs bake plane dims into their compile
# keys, so every new resolution used to pay the full cold-compile wall
# (the reference starts instantly at any size, user guide :127). Padding
# the compute planes up to a canonical bucket lets nearby resolutions
# share the compiled program set; the pad is compute-only — coded
# geometry (mi grid, sequence header, MV clamp semantics via the
# valid-core reference pads) is unchanged. Luma dims; chroma is half.
_PLANE_BUCKETS = ((1280, 768), (1920, 1088), (2560, 1472), (3840, 2176))


def bucket_dims(w64: int, h64: int):
    """Bucketed (W, H) luma plane dims for ceil-64 dims (w64, h64).
    Small frames stay exact (tests / thumbnails compile fast anyway);
    env SVT_TPU_BUCKET=off disables, =WxH forces one bucket."""
    import os
    env = os.environ.get("SVT_TPU_BUCKET", "auto")
    if env == "off":
        return (w64, h64)
    if env not in ("auto", ""):
        bw, bh = (int(t) for t in env.lower().split("x"))
        return (max(bw, w64), max(bh, h64))
    if w64 * h64 <= 512 * 512:
        return (w64, h64)
    # both orientations of the ladder (portrait frames would otherwise
    # fall through to a hugely oversized landscape bucket); pick the
    # smallest-area candidate that fits
    cands = [(bw, bh) for bw, bh in _PLANE_BUCKETS
             if w64 <= bw and h64 <= bh]
    cands += [(bh, bw) for bw, bh in _PLANE_BUCKETS
              if w64 <= bh and h64 <= bw]
    if not cands:
        return (w64, h64)
    return min(cands, key=lambda c: c[0] * c[1])


def pad_frame_planes(y, u, v, dtype=np.int32):
    """Bucket-padded (y, u, v) compute planes (edge-replicated)."""
    y64 = pad_to_multiple(y, 64)
    bw, bh = bucket_dims(y64.shape[1], y64.shape[0])
    out = [np.pad(y64, ((0, bh - y64.shape[0]), (0, bw - y64.shape[1])),
                  mode="edge").astype(dtype)]
    for p in (u, v):
        p32 = pad_to_multiple(p, 32)
        out.append(np.pad(
            p32, ((0, bh // 2 - p32.shape[0]),
                  (0, bw // 2 - p32.shape[1])),
            mode="edge").astype(dtype))
    return out


def hadamard_n(n: int) -> np.ndarray:
    """Sylvester +-1 Hadamard matrix (shared by the host and device
    SATD kernels — the two must stay integer-identical)."""
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def tx_size_for_block(size_px: int, plane: int) -> int:
    """TX_MODE_LARGEST tx size for a square block (chroma capped at 32)."""
    if plane == 0:
        return MAX_TX_SIZE_OF_BLOCK[size_px]
    return MAX_TX_SIZE_OF_BLOCK[min(32, size_px)]


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


def fixed_leaf_sizes(mi_rows: int, mi_cols: int, sb_rows: int, sb_cols: int,
                     target: int):
    """Uniform square partition {(mi_row, mi_col): size_px} with the
    edge-split rule (blocks whose half-point crosses the mi area split
    down to 8x8)."""
    sizes = {}

    def rec(mi_row, mi_col, psize):
        if mi_row >= mi_rows or mi_col >= mi_cols:
            return
        hbs = psize >> 3
        crosses = not ((mi_row + hbs) < mi_rows and (mi_col + hbs) < mi_cols)
        if psize > target or (crosses and psize > 8):
            half = psize >> 1
            rec(mi_row, mi_col, half)
            rec(mi_row, mi_col + hbs, half)
            rec(mi_row + hbs, mi_col, half)
            rec(mi_row + hbs, mi_col + hbs, half)
        else:
            sizes[(mi_row, mi_col)] = psize

    for sb_y in range(0, sb_rows * 16, 16):
        for sb_x in range(0, sb_cols * 16, 16):
            rec(sb_y, sb_x, 64)
    return sizes


def infer_partition(leaf_sizes: dict, mi_row: int, mi_col: int, psize: int,
                    mi_rows: int, mi_cols: int):
    """Partition type + ordered leaves at one tree node, from the leaf
    map (single source of truth for emit/ordering; the decode side reads
    the coded symbol instead). Returns (partition, [(r, c, (w, h))]) or
    (PARTITION_SPLIT, None). Rect leaves sit under both half keys; the
    T-shapes (HORZ_A/B, VERT_A/B, spec 5.11.4) are recognized by their
    mixed square+rect corner patterns, which no SPLIT recursion can
    produce (a child-quadrant leaf can never span the parent's width)."""
    from svt_av1_tpu_torch.utils.blocks import (PARTITION_HORZ, PARTITION_HORZ_4,
                                          PARTITION_HORZ_A,
                                          PARTITION_HORZ_B, PARTITION_NONE,
                                          PARTITION_SPLIT, PARTITION_VERT,
                                          PARTITION_VERT_4,
                                          PARTITION_VERT_A,
                                          PARTITION_VERT_B)
    hbs = psize >> 3
    half = psize >> 1
    quarter = psize >> 2
    inb = lambda r, c: r < mi_rows and c < mi_cols
    clip = lambda lst: [(r, c, wh) for r, c, wh in lst if inb(r, c)]
    vA = leaf_sizes.get((mi_row, mi_col))
    if vA == psize:
        return PARTITION_NONE, [(mi_row, mi_col, (psize, psize))]
    vB = leaf_sizes.get((mi_row, mi_col + hbs))
    vC = leaf_sizes.get((mi_row + hbs, mi_col))
    rh, rv = (psize, half), (half, psize)
    if vA == rh:
        if vC == half and mi_row + hbs < mi_rows:   # HORZ_B: rect + 2 sq
            return PARTITION_HORZ_B, clip(
                [(mi_row, mi_col, rh), (mi_row + hbs, mi_col, (half, half)),
                 (mi_row + hbs, mi_col + hbs, (half, half))])
        return PARTITION_HORZ, clip(
            [(mi_row, mi_col, rh), (mi_row + hbs, mi_col, rh)])
    if vA == rv:
        if vB == half and mi_col + hbs < mi_cols:   # VERT_B: rect + 2 sq
            return PARTITION_VERT_B, clip(
                [(mi_row, mi_col, rv), (mi_row, mi_col + hbs, (half, half)),
                 (mi_row + hbs, mi_col + hbs, (half, half))])
        return PARTITION_VERT, clip(
            [(mi_row, mi_col, rv), (mi_row, mi_col + hbs, rv)])
    if vA == half:
        if vC == rh:                                # HORZ_A: 2 sq + rect
            return PARTITION_HORZ_A, clip(
                [(mi_row, mi_col, (half, half)),
                 (mi_row, mi_col + hbs, (half, half)),
                 (mi_row + hbs, mi_col, rh)])
        if vB == rv:                                # VERT_A: 2 sq + rect
            return PARTITION_VERT_A, clip(
                [(mi_row, mi_col, (half, half)),
                 (mi_row + hbs, mi_col, (half, half)),
                 (mi_row, mi_col + hbs, rv)])
    if vA == (psize, quarter):
        qbs = psize >> 4
        return PARTITION_HORZ_4, clip(
            [(mi_row + i * qbs, mi_col, (psize, quarter))
             for i in range(4)])
    if vA == (quarter, psize):
        qbs = psize >> 4
        return PARTITION_VERT_4, clip(
            [(mi_row, mi_col + i * qbs, (quarter, psize))
             for i in range(4)])
    return PARTITION_SPLIT, None


def leaves_in_coding_order(leaf_sizes: dict, mi_rows: int, mi_cols: int,
                           sb_rows: int, sb_cols: int):
    """Ordered (mi_row, mi_col, size_or_(w,h)) list from a leaf map.
    Rect leaves are stored under BOTH half keys with the same (w, h)
    value; the recursion emits them in coding order (top/bottom for
    HORZ, left/right for VERT; spec block order for the T-shapes)."""
    from svt_av1_tpu_torch.utils.blocks import PARTITION_NONE, PARTITION_SPLIT
    out = []

    def rec(mi_row, mi_col, psize):
        if mi_row >= mi_rows or mi_col >= mi_cols:
            return
        part, leaves = infer_partition(leaf_sizes, mi_row, mi_col, psize,
                                       mi_rows, mi_cols)
        if part == PARTITION_NONE:
            out.append((mi_row, mi_col, psize))
            return
        if part != PARTITION_SPLIT:
            out.extend(leaves)
            return
        hbs = psize >> 3
        half = psize >> 1
        rec(mi_row, mi_col, half)
        rec(mi_row, mi_col + hbs, half)
        rec(mi_row + hbs, mi_col, half)
        rec(mi_row + hbs, mi_col + hbs, half)

    for sb_y in range(0, sb_rows * 16, 16):
        for sb_x in range(0, sb_cols * 16, 16):
            rec(sb_y, sb_x, 64)
    return out


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


def intra_candidates(cfg):
    """(mode, angle_delta) candidate list from config, in a fixed order
    shared by every encoder backend (tie-breaks must agree)."""
    from svt_av1_tpu_torch.ops import intra_dir
    out = []
    for m in cfg.intra_modes:
        if intra_dir.is_directional(m):
            for d in cfg.angle_deltas:
                out.append((m, d))
        else:
            out.append((m, 0))
    return out


def edge_filter_active(cfg) -> bool:
    """True when enable_intra_edge_filter can change any keyframe
    prediction: a directional candidate with pAngle outside {90, 180}
    exists (the spec exempts exact V/H; fast presets whose candidate
    sets are non-directional keep the fused device paths)."""
    if not cfg.enable_intra_edge_filter:
        return False
    from svt_av1_tpu_torch.ops import intra_dir
    return any(intra_dir.is_directional(m)
               and intra_dir.mode_angle(m, d) not in (90, 180)
               for m, d in intra_candidates(cfg))


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


class PendingQC:
    """Device-resident coefficient group awaiting its one fetch.

    ``qcoeff[p][i] = (PendingQC, lane)`` markers defer the ~MBs of
    quantized coefficients (a torch tensor) until the syntax pass, which
    runs on the entropy worker thread, overlapped with the next frame's
    device compute. On a CUDA tensor the copy into pinned host memory
    starts at construction (the dispatch), behind the work that produces
    it, so resolving is usually a wait, not a transfer."""

    __slots__ = ("dev", "host", "_done")

    def __init__(self, dev):
        self.host = None
        self._done = None
        if dev.is_cuda:
            import torch
            with torch.cuda.device(dev.device):   # the tensor's own card
                pinned = torch.empty(dev.shape, dtype=dev.dtype,
                                     pin_memory=True)
                pinned.copy_(dev, non_blocking=True)
                self._done = torch.cuda.Event()
                self._done.record()
            dev = pinned
        self.dev = dev

    def get(self, lane: int):
        import numpy as _np
        if self.host is None:
            if self._done is not None:
                self._done.synchronize()
            self.host = self.dev.cpu().numpy()
            self.dev = self._done = None
        return self.host[lane].astype(_np.int32)


def resolve_qc(entry):
    """qcoeff[p][i] -> np.ndarray (resolving a pending marker)."""
    if type(entry) is tuple:
        pend, lane = entry
        return pend.get(lane)
    return entry
