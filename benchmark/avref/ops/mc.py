"""Motion compensation: AV1 sub-pel convolve (host NumPy oracle, batched).

Normative inter prediction for translation-only single reference
(reference behavior: av1_convolve_2d_sr_c ``EbInterPrediction.c:145``,
sub_pel_filters_8/_4 ``:106-127``). One 2D path covers the x-only / y-only /
copy cases bit-exactly (the phase-0 kernel is a pure delta and the rounding
chain cancels — verified in tests against the dedicated paths' math).

MVs are (row, col) in 1/8-pel luma units; chroma planes scale them to
1/16-chroma-pel phases. References must be edge-padded (``pad_reference``)
so clamped MVs always sample valid data.
"""

from __future__ import annotations

import numpy as np

FILTER_BITS = 7
ROUND0 = 3
ROUND1 = 11
REF_PAD = 32  # replicated border on each side of a reference plane

# EIGHTTAP_REGULAR, 16 phases (reference EbInterPrediction.c:106)
SUBPEL_FILTERS_8 = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 2, -6, 126, 8, -2, 0, 0],
    [0, 2, -10, 122, 18, -4, 0, 0], [0, 2, -12, 116, 28, -8, 2, 0],
    [0, 2, -14, 110, 38, -10, 2, 0], [0, 2, -14, 102, 48, -12, 2, 0],
    [0, 2, -16, 94, 58, -12, 2, 0], [0, 2, -14, 84, 66, -12, 2, 0],
    [0, 2, -14, 76, 76, -14, 2, 0], [0, 2, -12, 66, 84, -14, 2, 0],
    [0, 2, -12, 58, 94, -16, 2, 0], [0, 2, -12, 48, 102, -14, 2, 0],
    [0, 2, -10, 38, 110, -14, 2, 0], [0, 2, -8, 28, 116, -12, 2, 0],
    [0, 0, -4, 18, 122, -10, 2, 0], [0, 0, -2, 8, 126, -6, 2, 0],
], dtype=np.int32)

# 4-tap variant used when the block dimension is <= 4
SUBPEL_FILTERS_4 = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, -4, 126, 8, -2, 0, 0],
    [0, 0, -8, 122, 18, -4, 0, 0], [0, 0, -10, 116, 28, -6, 0, 0],
    [0, 0, -12, 110, 38, -8, 0, 0], [0, 0, -12, 102, 48, -10, 0, 0],
    [0, 0, -14, 94, 58, -10, 0, 0], [0, 0, -12, 84, 66, -10, 0, 0],
    [0, 0, -12, 76, 76, -12, 0, 0], [0, 0, -10, 66, 84, -12, 0, 0],
    [0, 0, -10, 58, 94, -14, 0, 0], [0, 0, -10, 48, 102, -12, 0, 0],
    [0, 0, -8, 38, 110, -12, 0, 0], [0, 0, -6, 28, 116, -10, 0, 0],
    [0, 0, -4, 18, 122, -8, 0, 0], [0, 0, -2, 8, 126, -4, 0, 0],
], dtype=np.int32)

# EIGHTTAP_SMOOTH (normative spec constants; reference
# sub_pel_filters_8smooth, EbInterPrediction.c:930)
SUBPEL_FILTERS_8SMOOTH = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 2, 28, 62, 34, 2, 0, 0],
    [0, 0, 26, 62, 36, 4, 0, 0], [0, 0, 22, 62, 40, 4, 0, 0],
    [0, 0, 20, 60, 42, 6, 0, 0], [0, 0, 18, 58, 44, 8, 0, 0],
    [0, 0, 16, 56, 46, 10, 0, 0], [0, -2, 16, 54, 48, 12, 0, 0],
    [0, -2, 14, 52, 52, 14, -2, 0], [0, 0, 12, 48, 54, 16, -2, 0],
    [0, 0, 10, 46, 56, 16, 0, 0], [0, 0, 8, 44, 58, 18, 0, 0],
    [0, 0, 6, 42, 60, 20, 0, 0], [0, 0, 4, 40, 62, 22, 0, 0],
    [0, 0, 4, 36, 62, 26, 0, 0], [0, 0, 2, 34, 62, 28, 2, 0],
], dtype=np.int32)

# MULTITAP_SHARP (reference sub_pel_filters_8sharp,
# EbInterPrediction.c:918)
SUBPEL_FILTERS_8SHARP = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [-2, 2, -6, 126, 8, -2, 2, 0],
    [-2, 6, -12, 124, 16, -6, 4, -2], [-2, 8, -18, 120, 26, -10, 6, -2],
    [-4, 10, -22, 116, 38, -14, 6, -2],
    [-4, 10, -22, 108, 48, -18, 8, -2],
    [-4, 10, -24, 100, 60, -20, 8, -2],
    [-4, 10, -24, 90, 70, -22, 10, -2],
    [-4, 12, -24, 80, 80, -24, 12, -4],
    [-2, 10, -22, 70, 90, -24, 10, -4],
    [-2, 8, -20, 60, 100, -24, 10, -4],
    [-2, 8, -18, 48, 108, -22, 10, -4],
    [-2, 6, -14, 38, 116, -22, 10, -4],
    [-2, 6, -10, 26, 120, -18, 8, -2],
    [-2, 4, -6, 16, 124, -12, 6, -2], [0, 2, -2, 8, 126, -6, 2, -2],
], dtype=np.int32)

# 4-tap smooth (reference sub_pel_filters_4smooth,
# EbInterPrediction.c:952)
SUBPEL_FILTERS_4SMOOTH = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, 30, 62, 34, 2, 0, 0],
    [0, 0, 26, 62, 36, 4, 0, 0], [0, 0, 22, 62, 40, 4, 0, 0],
    [0, 0, 20, 60, 42, 6, 0, 0], [0, 0, 18, 58, 44, 8, 0, 0],
    [0, 0, 16, 56, 46, 10, 0, 0], [0, 0, 14, 54, 48, 12, 0, 0],
    [0, 0, 12, 52, 52, 12, 0, 0], [0, 0, 12, 48, 54, 14, 0, 0],
    [0, 0, 10, 46, 56, 16, 0, 0], [0, 0, 8, 44, 58, 18, 0, 0],
    [0, 0, 6, 42, 60, 20, 0, 0], [0, 0, 4, 40, 62, 22, 0, 0],
    [0, 0, 4, 36, 62, 26, 0, 0], [0, 0, 2, 34, 62, 30, 0, 0],
], dtype=np.int32)

# switchable filter ids (spec interp_filter)
EIGHTTAP_REGULAR, EIGHTTAP_SMOOTH, MULTITAP_SHARP = 0, 1, 2
SWITCHABLE_FILTERS = 3

# filter banks indexed [ftype, phase, tap]: >4px dims and <=4px dims
# (spec av1_get_interp_filter_params_with_block_size: a <=4 dim maps
# REGULAR and SHARP to the 4-tap regular set, SMOOTH to 4-tap smooth —
# reference EbInterPrediction.c:979)
FILTER_BANK_8 = np.stack([SUBPEL_FILTERS_8, SUBPEL_FILTERS_8SMOOTH,
                          SUBPEL_FILTERS_8SHARP])
FILTER_BANK_4 = np.stack([SUBPEL_FILTERS_4, SUBPEL_FILTERS_4SMOOTH,
                          SUBPEL_FILTERS_4])


def pad_reference(plane: np.ndarray, pad: int = REF_PAD,
                  valid_hw=None) -> np.ndarray:
    """Edge-replicate pad (reference PadRefAndSetFlags semantics).

    ``valid_hw``: (vh, vw) decoder-visible core dims when the plane
    carries extra bucket-pad rows/cols (resolution-bucketed compute
    planes) — replication then starts at the CORE edge, reproducing
    exactly what a decoder's clip-reads yield beyond its own plane, so
    any legal MV reads identical pixels on both sides. Output shape is
    always plane + 2*pad (program keys stay bucket-stable)."""
    if valid_hw is not None:
        vh, vw = valid_hw
        h, w = plane.shape
        if vh < h or vw < w:
            return np.pad(plane[:vh, :vw],
                          ((pad, pad + h - vh), (pad, pad + w - vw)),
                          mode="edge")
    return np.pad(plane, pad, mode="edge")


def _filter_rows(dim: int, ftype, frac):
    """Per-block filter taps [B, 8] for one direction."""
    bank = FILTER_BANK_4 if dim <= 4 else FILTER_BANK_8
    if np.ndim(ftype) == 0:
        return bank[int(ftype)][frac]
    return bank[np.asarray(ftype, dtype=np.int64), frac]


def mc_block_batch(ref_padded: np.ndarray, xs, ys, mvs, w: int, h: int,
                   ss: int = 0, bd: int = 8, ftype=0) -> np.ndarray:
    """Motion-compensated prediction for a batch of same-sized blocks.

    ref_padded: padded reference plane (REF_PAD border). xs/ys: [B]
    block positions in *plane* pixels (unpadded coords). mvs: [B, 2]
    (row, col) in 1/8-pel luma units. ss: plane subsampling (0 luma,
    1 chroma 4:2:0). ftype: interp filter id (scalar or [B] per block).
    Returns [B, h, w] pixel-dtype predictions.
    """
    b = len(xs)
    mvs = np.asarray(mvs, dtype=np.int64)
    win, fxv, fyv = _gather_windows(ref_padded, xs, ys, mvs, w, h, ss,
                                    ftype)
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    final_bits = 2 * FILTER_BITS - ROUND0 - ROUND1
    sub = (1 << (offset_bits - ROUND1)) + (1 << (offset_bits - ROUND1 - 1))
    horiz = np.full((b, h + 7, w), 1 << (bd + FILTER_BITS - 1),
                    dtype=np.int64)
    for k in range(8):
        horiz += fxv[:, k, None, None] * win[:, :, k:k + w]
    horiz = (horiz + (1 << (ROUND0 - 1))) >> ROUND0
    vert = np.full((b, h, w), 1 << offset_bits, dtype=np.int64)
    for k in range(8):
        vert += fyv[:, k, None, None] * horiz[:, k:k + h]
    res = ((vert + (1 << (ROUND1 - 1))) >> ROUND1) - sub
    if final_bits > 0:
        res = (res + (1 << (final_bits - 1))) >> final_bits
    return np.clip(res, 0, (1 << bd) - 1) \
        .astype(np.uint16 if bd > 8 else np.uint8)


def _gather_windows(ref_padded, xs, ys, mvs, w, h, ss, ftype=0):
    """Batched (h+7, w+7) filter windows + per-block x/y filter rows."""
    scaled_r = mvs[:, 0] << (1 - ss)
    scaled_c = mvs[:, 1] << (1 - ss)
    int_r = np.asarray(ys, dtype=np.int64) + (scaled_r >> 4)
    int_c = np.asarray(xs, dtype=np.int64) + (scaled_c >> 4)
    frac_r = scaled_r & 15
    frac_c = scaled_c & 15
    y0 = int_r + REF_PAD - 3
    x0 = int_c + REF_PAD - 3
    iy = y0[:, None, None] + np.arange(h + 7)[None, :, None]
    ix = x0[:, None, None] + np.arange(w + 7)[None, None, :]
    win = ref_padded[iy, ix].astype(np.int64)
    return win, _filter_rows(w, ftype, frac_c), \
        _filter_rows(h, ftype, frac_r)


ROUND1_COMP = 7  # COMPOUND_ROUND1_BITS


def mc_block_batch_conv(ref_padded: np.ndarray, xs, ys, mvs, w: int,
                        h: int, ss: int = 0, bd: int = 8,
                        ftype=0) -> np.ndarray:
    """Compound-path convolve returning CONV-domain values (round_1 = 7,
    offset retained) — one side of a compound prediction (reference
    av1_jnt_convolve_2d_c, EbInterPrediction.c:290, do_average = 0).
    Returns [B, h, w] int32."""
    b = len(xs)
    mvs = np.asarray(mvs, dtype=np.int64)
    win, fxv, fyv = _gather_windows(ref_padded, xs, ys, mvs, w, h, ss,
                                    ftype)
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    horiz = np.full((b, h + 7, w), 1 << (bd + FILTER_BITS - 1),
                    dtype=np.int64)
    for k in range(8):
        horiz += fxv[:, k, None, None] * win[:, :, k:k + w]
    horiz = (horiz + (1 << (ROUND0 - 1))) >> ROUND0
    vert = np.full((b, h, w), 1 << offset_bits, dtype=np.int64)
    for k in range(8):
        vert += fyv[:, k, None, None] * horiz[:, k:k + h]
    return (((vert + (1 << (ROUND1_COMP - 1))) >> ROUND1_COMP)
            .astype(np.int32))


def compound_average(res0: np.ndarray, res1: np.ndarray,
                     bd: int = 8) -> np.ndarray:
    """Blend two CONV-domain predictions (simple average; jnt_comp is
    disabled sequence-wide). Mirrors the do_average tail of
    av1_jnt_convolve_2d_c (reference :341-356)."""
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    round_bits = 2 * FILTER_BITS - ROUND0 - ROUND1_COMP
    tmp = (res0.astype(np.int64) + res1.astype(np.int64)) >> 1
    tmp = tmp - ((1 << (offset_bits - ROUND1_COMP))
                 + (1 << (offset_bits - ROUND1_COMP - 1)))
    tmp = (tmp + (1 << (round_bits - 1))) >> round_bits
    return np.clip(tmp, 0, (1 << bd) - 1)
