"""Directional (angular) intra prediction, batched: the host NumPy version.

Without the intra edge filter (sequence header ``enable_intra_edge_filter
= 0``) prediction is pure 2-tap interpolation along the angle. With it,
the normative edge filter and upsample (AV1 spec 7.11.2) process the edges
first (``predict_directional_edge``). Semantics follow the reference
``EbIntraPrediction.c``: dr_intra_derivative (:342), av1_dr_prediction_z1_c
(:445), z2 (:485), z3 (:413).

Edge arrays use the "offset 1" layout: ``edge[0]`` is the top-left corner
sample, ``edge[1:]`` are the above row / left column (so spec index -1 maps
to 0) — zone 2 reads index -1.
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark.avref.utils.blocks import (MODE_TO_ANGLE, SMOOTH_H_PRED,
                                          SMOOTH_PRED, SMOOTH_V_PRED)

ANGLE_STEP = 3
MAX_ANGLE_DELTA = 3

# dr_intra_derivative (reference EbIntraPrediction.c:342; AV1 spec table)
DR_INTRA_DERIVATIVE = np.zeros(90, dtype=np.int32)
for _a, _v in [(3, 1023), (6, 547), (9, 372), (14, 273), (17, 215),
               (20, 178), (23, 151), (26, 132), (29, 116), (32, 102),
               (36, 90), (39, 80), (42, 71), (45, 64), (48, 57), (51, 51),
               (54, 45), (58, 40), (61, 35), (64, 31), (67, 27), (70, 23),
               (73, 19), (76, 15), (81, 11), (84, 7), (87, 3)]:
    DR_INTRA_DERIVATIVE[_a] = _v


def is_directional(mode: int) -> bool:
    return mode in MODE_TO_ANGLE


def mode_angle(mode: int, angle_delta: int) -> int:
    return MODE_TO_ANGLE[mode] + angle_delta * ANGLE_STEP


def get_dx(angle: int) -> int:
    if 0 < angle < 90:
        return int(DR_INTRA_DERIVATIVE[angle])
    if 90 < angle < 180:
        return int(DR_INTRA_DERIVATIVE[180 - angle])
    return 1


def get_dy(angle: int) -> int:
    if 90 < angle < 180:
        return int(DR_INTRA_DERIVATIVE[angle - 90])
    if 180 < angle < 270:
        return int(DR_INTRA_DERIVATIVE[270 - angle])
    return 1


def _z1(above1, bw, bh, dx, bd):
    """angle in (0, 90): above + above-right. above1: [B, 1+bw+bh]
    (index 0 = top-left)."""
    max_base_x = bw + bh - 1
    r = np.arange(bh)[:, None]
    c = np.arange(bw)[None, :]
    x = (r + 1) * dx
    base = (x >> 6) + c                      # [bh, bw]
    shift = (x >> 1) & 0x1F
    b0 = np.minimum(base, max_base_x)
    b1 = np.minimum(base + 1, max_base_x)
    v0 = above1[:, 1 + b0]
    v1 = above1[:, 1 + b1]
    val = (v0 * (32 - shift) + v1 * shift + 16) >> 5
    out = np.where(base[None] < max_base_x, val, above1[:, 1 + max_base_x,
                                                        None, None])
    return np.clip(out, 0, (1 << bd) - 1)


def _z3(left1, bw, bh, dy, bd):
    """angle in (180, 270): left + bottom-left. left1: [B, 1+bh+bw]."""
    max_base_y = bw + bh - 1
    r = np.arange(bh)[:, None]
    c = np.arange(bw)[None, :]
    y = (c + 1) * dy
    base = (y >> 6) + r
    shift = (y >> 1) & 0x1F
    b0 = np.minimum(base, max_base_y)
    b1 = np.minimum(base + 1, max_base_y)
    v0 = left1[:, 1 + b0]
    v1 = left1[:, 1 + b1]
    val = (v0 * (32 - shift) + v1 * shift + 16) >> 5
    out = np.where(base[None] < max_base_y, val,
                   left1[:, 1 + max_base_y, None, None])
    return np.clip(out, 0, (1 << bd) - 1)


def _z2(above1, left1, bw, bh, dx, dy, bd):
    """angle in (90, 180): above + left + corner (index -1 -> offset 0)."""
    r = np.arange(bh)[:, None]
    c = np.arange(bw)[None, :]
    x = c * 64 - (r + 1) * dx                # spec: x = -dx*(r+1) + (c<<6)
    base_x = x >> 6                          # >= -1 when used
    shift_x = (x >> 1) & 0x1F
    y = r * 64 - (c + 1) * dy
    base_y = y >> 6
    shift_y = (y >> 1) & 0x1F
    use_x = base_x >= -1
    bx0 = np.clip(base_x, -1, bw + bh - 1)
    bx1 = np.clip(base_x + 1, -1, bw + bh)
    by0 = np.clip(base_y, -1, bh + bw - 1)
    by1 = np.clip(base_y + 1, -1, bh + bw)
    vx = (above1[:, 1 + bx0] * (32 - shift_x)
          + above1[:, np.minimum(1 + bx1, above1.shape[1] - 1)] * shift_x
          + 16) >> 5
    vy = (left1[:, 1 + by0] * (32 - shift_y)
          + left1[:, np.minimum(1 + by1, left1.shape[1] - 1)] * shift_y
          + 16) >> 5
    out = np.where(use_x[None], vx, vy)
    return np.clip(out, 0, (1 << bd) - 1)


def predict_directional(mode: int, angle_delta: int, above1: np.ndarray,
                        left1: np.ndarray, bw: int, bh: int,
                        bd: int = 8) -> np.ndarray:
    """Batched directional prediction. above1/left1: offset-1 edge arrays
    ([B, 1+bw+bh] / [B, 1+bh+bw], index 0 = top-left). Returns [B, bh, bw].

    pAngle 90/180 are the exact V/H copies (handled by the caller's V/H
    predictors when delta == 0)."""
    angle = mode_angle(mode, angle_delta)
    assert angle not in (90, 180), "exact V/H handled by v_pred/h_pred"
    if 0 < angle < 90:
        return _z1(above1, bw, bh, get_dx(angle), bd)
    if 90 < angle < 180:
        return _z2(above1, left1, bw, bh, get_dx(angle), get_dy(angle), bd)
    return _z3(left1, bw, bh, get_dy(angle), bd)


# --- intra edge filter + upsample (enable_intra_edge_filter = 1) -----------------
# Normative edge processing for directional prediction (AV1 spec 7.11.2:
# intra_edge_filter_strength / use_intra_edge_upsample / intraEdgeFilter /
# intraEdgeUpsample; reference EbIntraPrediction.c:215
# av1_filter_intra_edge_high_c, :267 intra_edge_filter_strength, :316
# av1_upsample_intra_edge_high_c, :8020 filter_intra_edge_corner, invocation
# :8415-8465). All directional modes carry need_above_left, so the filter
# span always includes the corner: in the offset-1 layout the C call
# av1_filter_intra_edge(row - 1, n_px, s) is exactly a filter over
# edge1[0..sz-1] modifying indices 1..sz-1.
#
# The NumPy functions keep the JAX package's array-namespace parameter
# ``xp`` (numpy here); the torch twins at the end of the module compute the
# same integers on a torch device, with every static index and shift
# computed once in numpy and cached on the device.

INTRA_EDGE_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
MAX_UPSAMPLE_SZ = 16


def is_smooth_mode(mode: int) -> bool:
    """Neighbor smoothness for filt_type (reference is_smooth; CfL and
    inter neighbors are non-smooth)."""
    return mode in (SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED)


def edge_filter_strength(blk_wh: int, delta: int, ftype: int) -> int:
    """Static filter strength (reference intra_edge_filter_strength)."""
    d = abs(delta)
    s = 0
    if ftype == 0:
        if blk_wh <= 8:
            if d >= 56:
                s = 1
        elif blk_wh <= 16:
            if d >= 40:
                s = 1
        elif blk_wh <= 24:
            if d >= 8:
                s = 1
            if d >= 16:
                s = 2
            if d >= 32:
                s = 3
        elif blk_wh <= 32:
            if d >= 1:
                s = 1
            if d >= 4:
                s = 2
            if d >= 32:
                s = 3
        else:
            if d >= 1:
                s = 3
    else:
        if blk_wh <= 8:
            if d >= 40:
                s = 1
            if d >= 64:
                s = 2
        elif blk_wh <= 16:
            if d >= 20:
                s = 1
            if d >= 48:
                s = 2
        elif blk_wh <= 24:
            if d >= 4:
                s = 3
        else:
            if d >= 1:
                s = 3
    return s


def use_edge_upsample(blk_wh: int, delta: int, ftype: int) -> bool:
    """Static upsample decision (reference use_intra_edge_upsample)."""
    d = abs(delta)
    if d <= 0 or d >= 40:
        return False
    return blk_wh <= 8 if ftype else blk_wh <= 16


def filter_edge_batch(xp, edge1, sz, strength: int, apply_mask):
    """5-tap edge filter over offset-1 arrays (reference
    av1_filter_intra_edge_high_c with p = row - 1). edge1 [B, L]; sz [B]
    span *including* the corner; modifies indices 1..sz-1 with taps read
    from the unfiltered array clamped to [0, sz-1]; lanes with
    ``apply_mask`` False (or strength 0) pass through unchanged."""
    if strength == 0:
        return edge1
    b, L = edge1.shape
    kern = INTRA_EDGE_KERNELS[strength - 1]
    i = np.arange(L)[None, :, None]
    j = np.arange(5)[None, None, :]
    sz = sz.astype(np.int64) if isinstance(sz, np.ndarray) else sz
    k = xp.clip(i - 2 + j, 0, xp.maximum(sz, 1)[:, None, None] - 1)
    taps = xp.take_along_axis(edge1, k.reshape(b, L * 5),
                              axis=1).reshape(b, L, 5)
    s = sum(taps[:, :, t] * kern[t] for t in range(5) if kern[t])
    filt = (s + 8) >> 4
    do = apply_mask[:, None] & (np.arange(L)[None, :] >= 1) \
        & (np.arange(L)[None, :] < sz[:, None])
    return xp.where(do, filt, edge1)


def upsample_edge_batch(xp, edge1, n_px: int, bd: int):
    """2x upsample of the first ``n_px`` edge samples (reference
    av1_upsample_intra_edge_high_c). edge1 [B, L] offset-1 (corner at 0);
    returns an offset-2 array [B, 2*n_px + 1]: index 0 holds the original
    corner (spec position -2), odd indices the interpolated half
    samples, even indices >= 2 the original samples."""
    assert n_px <= MAX_UPSAMPLE_SZ
    ext = xp.concatenate([edge1[:, :1], edge1[:, :1], edge1[:, 1:1 + n_px],
                          edge1[:, n_px:n_px + 1]], axis=1)  # [B, n_px+3]
    s = (-ext[:, :-3] + 9 * ext[:, 1:-2] + 9 * ext[:, 2:-1]
         - ext[:, 3:])
    s = xp.clip((s + 8) >> 4, 0, (1 << bd) - 1)              # [B, n_px]
    b = edge1.shape[0]
    out = xp.zeros((b, 2 * n_px + 1), dtype=edge1.dtype)
    out[:, 0] = edge1[:, 0]
    out[:, 1::2] = s
    out[:, 2::2] = edge1[:, 1:1 + n_px]
    return out


def _z1e(xp, above, bw, bh, dx, bd, up: int, off: int):
    """Zone 1 with upsample-aware indexing (reference
    av1_dr_prediction_z1_c). ``above``: offset-``off`` edge array."""
    max_base = (bw + bh - 1) << up
    r = np.arange(bh)[:, None]
    c = np.arange(bw)[None, :]
    x = (r + 1) * dx
    base = (x >> (6 - up)) + (c << up)
    shift = ((x << up) >> 1) & 0x1F
    b0 = np.minimum(base, max_base)
    b1 = np.minimum(base + 1, max_base)
    v0 = above[:, off + b0]
    v1 = above[:, off + b1]
    val = (v0 * (32 - shift) + v1 * shift + 16) >> 5
    out = xp.where(base[None] < max_base, val,
                   above[:, off + max_base, None, None])
    return xp.clip(out, 0, (1 << bd) - 1)


def _z3e(xp, left, bw, bh, dy, bd, up: int, off: int):
    max_base = (bw + bh - 1) << up
    r = np.arange(bh)[:, None]
    c = np.arange(bw)[None, :]
    y = (c + 1) * dy
    base = (y >> (6 - up)) + (r << up)
    shift = ((y << up) >> 1) & 0x1F
    b0 = np.minimum(base, max_base)
    b1 = np.minimum(base + 1, max_base)
    v0 = left[:, off + b0]
    v1 = left[:, off + b1]
    val = (v0 * (32 - shift) + v1 * shift + 16) >> 5
    out = xp.where(base[None] < max_base, val,
                   left[:, off + max_base, None, None])
    return xp.clip(out, 0, (1 << bd) - 1)


def _z2e(xp, above, left, bw, bh, dx, dy, bd, up_a: int, up_l: int,
         off_a: int, off_l: int):
    r = np.arange(bh)[:, None]
    c = np.arange(bw)[None, :]
    na = above.shape[1] - 1 - off_a
    nl = left.shape[1] - 1 - off_l
    x = (c << 6) - (r + 1) * dx
    base_x = x >> (6 - up_a)
    shift_x = ((x << up_a) & 0x3F) >> 1
    y = (r << 6) - (c + 1) * dy
    base_y = y >> (6 - up_l)
    shift_y = ((y << up_l) & 0x3F) >> 1
    use_x = base_x >= -(1 << up_a)
    bx0 = np.clip(base_x, -(1 << up_a), na)
    bx1 = np.clip(base_x + 1, -(1 << up_a), na)
    by0 = np.clip(base_y, -(1 << up_l), nl)
    by1 = np.clip(base_y + 1, -(1 << up_l), nl)
    vx = (above[:, off_a + bx0] * (32 - shift_x)
          + above[:, off_a + bx1] * shift_x + 16) >> 5
    vy = (left[:, off_l + by0] * (32 - shift_y)
          + left[:, off_l + by1] * shift_y + 16) >> 5
    out = xp.where(use_x[None], vx, vy)
    return xp.clip(out, 0, (1 << bd) - 1)


def _edge_params(angle: int, bw: int, bh: int, ft: int):
    """Static (strength_above, strength_left, up_above, up_left) for one
    (angle, block, filt_type)."""
    wh = bw + bh
    zone = 1 if angle < 90 else (2 if angle < 180 else 3)
    s_a = edge_filter_strength(wh, angle - 90, ft) if zone in (1, 2) else 0
    s_l = edge_filter_strength(wh, angle - 180, ft) if zone in (2, 3) else 0
    u_a = use_edge_upsample(wh, angle - 90, ft) if zone in (1, 2) else False
    u_l = use_edge_upsample(wh, angle - 180, ft) if zone in (2, 3) else False
    return zone, s_a, s_l, u_a, u_l


def _process_and_predict(xp, angle, above1, left1, bw, bh, ha, hl,
                         n_top, n_left, ft: int, bd: int):
    """One filt_type variant: corner-filtered inputs -> filtered /
    upsampled edges -> zone prediction."""
    zone, s_a, s_l, u_a, u_l = _edge_params(angle, bw, bh, ft)
    dx, dy = get_dx(angle), get_dy(angle)
    a, l = above1, left1
    if s_a:
        sz = xp.clip(n_top, 0, bw) + 1 + (bh if zone == 1 else 0)
        a = filter_edge_batch(xp, a, sz, s_a, ha)
    if s_l:
        sz = xp.clip(n_left, 0, bh) + 1 + (bw if zone == 3 else 0)
        l = filter_edge_batch(xp, l, sz, s_l, hl)
    off_a = off_l = 1
    if u_a:
        a = upsample_edge_batch(xp, a, bw + (bh if zone == 1 else 0), bd)
        off_a = 2
    if u_l:
        l = upsample_edge_batch(xp, l, bh + (bw if zone == 3 else 0), bd)
        off_l = 2
    if zone == 1:
        return _z1e(xp, a, bw, bh, dx, bd, int(u_a), off_a)
    if zone == 2:
        return _z2e(xp, a, l, bw, bh, dx, dy, bd, int(u_a), int(u_l),
                    off_a, off_l)
    return _z3e(xp, l, bw, bh, dy, bd, int(u_l), off_l)


def predict_directional_edge(mode: int, angle_delta: int, above1, left1,
                             bw: int, bh: int, ha, hl, ftype, n_top,
                             n_left, bd: int = 8, xp=np):
    """Directional prediction with the normative edge filter + upsample
    (sequence header enable_intra_edge_filter = 1).

    ftype [B]: per-lane filt_type (neighbor smoothness); n_top/n_left
    [B]: real (boundary-capped) above/left sample counts. Strength and
    upsample depend on filt_type, so the two static variants are computed
    and blended per lane (fully batched; no data-dependent control flow).
    """
    angle = mode_angle(mode, angle_delta)
    assert angle not in (90, 180)
    zone = 1 if angle < 90 else (2 if angle < 180 else 3)
    # corner filter (reference filter_intra_edge_corner; zone 2 with
    # w + h >= 24, both edges available) — filt_type independent
    if zone == 2 and bw + bh >= 24:
        s = (left1[:, 1] * 5 + above1[:, 0] * 6 + above1[:, 1] * 5
             + 8) >> 4
        corner_a = xp.where(ha & hl, s, above1[:, 0])
        corner_l = xp.where(ha & hl, s, left1[:, 0])
        above1 = xp.concatenate([corner_a[:, None], above1[:, 1:]],
                                axis=1)
        left1 = xp.concatenate([corner_l[:, None], left1[:, 1:]], axis=1)
    if _edge_params(angle, bw, bh, 0) == _edge_params(angle, bw, bh, 1):
        return _process_and_predict(xp, angle, above1, left1, bw, bh,
                                    ha, hl, n_top, n_left, 0, bd)
    p0 = _process_and_predict(xp, angle, above1, left1, bw, bh, ha, hl,
                              n_top, n_left, 0, bd)
    p1 = _process_and_predict(xp, angle, above1, left1, bw, bh, ha, hl,
                              n_top, n_left, 1, bd)
    return xp.where((ftype != 0)[:, None, None], p1, p0)
