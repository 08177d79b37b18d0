"""AV1 intra predictors, batched (host NumPy oracle; device twin in jax_ops).

Normative prediction (AV1 spec 7.11.2; reference behavior
``EbIntraPrediction.c:2677ff``). All predictors operate on batches of blocks:
``above`` [B, bw], ``left`` [B, bh], ``top_left`` [B] are *prepared* edge
samples (availability rules applied by ``prepare_edges``), output [B, bh, bw].
"""

from __future__ import annotations

import numpy as np

from benchmark.avref.utils.blocks import (DC_PRED, H_PRED, PAETH_PRED,
                                      SMOOTH_H_PRED, SMOOTH_PRED,
                                      SMOOTH_V_PRED, V_PRED)

# spec Sm_Weights_Tx: weights per block dimension (index = dimension)
_SM_WEIGHTS = {
    4: np.array([255, 149, 85, 64]),
    8: np.array([255, 197, 146, 105, 73, 50, 37, 32]),
    16: np.array([255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26,
                  20, 17, 16]),
    32: np.array([255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111,
                  101, 92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14,
                  12, 10, 9, 8, 8]),
    64: np.array([255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176,
                  169, 163, 156, 150, 144, 138, 133, 127, 121, 116, 111, 106,
                  101, 96, 91, 86, 82, 77, 73, 69, 65, 61, 57, 54, 50, 47, 44,
                  41, 38, 35, 32, 29, 27, 25, 22, 20, 18, 16, 15, 13, 12, 10,
                  9, 8, 7, 6, 6, 5, 5, 4, 4, 4]),
}
_SM_SCALE = 256  # 1 << sm_weight_log2_scale
_SM_ROUND = 9    # log2(2 * scale)


def prepare_edges(recon: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                  bw: int, bh: int, bd: int = 8, max_w: int = None,
                  max_h: int = None):
    """Gather and prepare intra edge samples for a batch of blocks.

    recon: current reconstruction plane [H, W] (only causal samples read).
    xs, ys: [B] top-left pixel coordinates. Availability = in-frame causality
    (spec 7.11.2: above row y-1, left col x-1; unavailable edges are
    synthesized from the other edge or the base value). max_w/max_h bound the
    readable sample area (spec maxX/maxY = mi area, which can be smaller than
    the padded plane); samples beyond are replicated.

    Returns (above [B, bw+bh], left [B, bh+bw], top_left [B]) — the extra
    length carries top-right / bottom-left extensions (replication of the
    last available sample; sufficient while directional prediction clamps).
    """
    base = 1 << (bd - 1)
    b = len(xs)
    H, W = recon.shape
    if max_w is not None:
        W = min(W, max_w)
    if max_h is not None:
        H = min(H, max_h)
    above = np.empty((b, bw + bh), dtype=np.int32)
    left = np.empty((b, bh + bw), dtype=np.int32)
    top_left = np.empty(b, dtype=np.int32)
    for i in range(b):  # host oracle: clarity over speed
        x, y = int(xs[i]), int(ys[i])
        have_above = y > 0
        have_left = x > 0
        if have_above:
            n_right = min(bw + bh, W - x)  # replicate beyond frame edge
            row = recon[y - 1, x:x + n_right].astype(np.int32)
            above[i, :n_right] = row
            above[i, n_right:] = row[-1]
        elif have_left:
            above[i] = recon[y, x - 1]
        else:
            above[i] = base - 1
        if have_left:
            n_down = min(bh + bw, H - y)
            col = recon[y:y + n_down, x - 1].astype(np.int32)
            left[i, :n_down] = col
            left[i, n_down:] = col[-1]
        elif have_above:
            left[i] = recon[y - 1, x]
        else:
            left[i] = base + 1
        if have_above and have_left:
            top_left[i] = recon[y - 1, x - 1]
        elif have_above:
            top_left[i] = recon[y - 1, x]
        elif have_left:
            top_left[i] = recon[y, x - 1]
        else:
            top_left[i] = base
    return above, left, top_left


def prepare_edges_av1(recon: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                      bw: int, bh: int, have_above: np.ndarray,
                      have_left: np.ndarray, have_above_right: np.ndarray,
                      have_bottom_left: np.ndarray, bd: int = 8,
                      max_w: int = None, max_h: int = None):
    """Spec-exact edge arrays for intra prediction (AV1 7.11.2 reference
    sample gathering, no edge filter/upsample).

    Returns (above1 [B, 1+bw+bh], left1 [B, 1+bh+bw]) in "offset 1" layout:
    index 0 is the top-left corner sample, 1.. are the above row / left
    column extended by replication past the availability limit
    (2*bw / 2*bh when the above-right / bottom-left neighbor is decoded,
    bw / bh otherwise; always clamped to the mi area max_w/max_h)."""
    base = 1 << (bd - 1)
    b = len(xs)
    H, W = recon.shape
    # max_w/max_h may be scalars or per-block arrays (tile right/bottom
    # pixel bounds — edge replication clamps at the TILE edge, spec
    # 7.11.2 BlockDecoded is tile-relative)
    Wv = np.minimum(W, np.broadcast_to(
        W if max_w is None else max_w, (b,)))
    Hv = np.minimum(H, np.broadcast_to(
        H if max_h is None else max_h, (b,)))
    above1 = np.empty((b, 1 + bw + bh), dtype=np.int32)
    left1 = np.empty((b, 1 + bh + bw), dtype=np.int32)
    for i in range(b):
        x, y = int(xs[i]), int(ys[i])
        ha, hl = bool(have_above[i]), bool(have_left[i])
        htr = bool(have_above_right[i])
        hbl = bool(have_bottom_left[i])
        if ha:
            lim = min(int(Wv[i]) - 1, x + (2 * bw if htr else bw) - 1)
            cols = np.minimum(x + np.arange(bw + bh), lim)
            above1[i, 1:] = recon[y - 1, cols]
        elif hl:
            above1[i, 1:] = recon[y, x - 1]
        else:
            above1[i, 1:] = base - 1
        if hl:
            lim = min(int(Hv[i]) - 1, y + (2 * bh if hbl else bh) - 1)
            rows = np.minimum(y + np.arange(bh + bw), lim)
            left1[i, 1:] = recon[rows, x - 1]
        elif ha:
            left1[i, 1:] = recon[y - 1, x]
        else:
            left1[i, 1:] = base + 1
        if ha and hl:
            corner = recon[y - 1, x - 1]
        elif ha:
            corner = recon[y - 1, x]
        elif hl:
            corner = recon[y, x - 1]
        else:
            corner = base
        above1[i, 0] = corner
        left1[i, 0] = corner
    return above1, left1


# --- predictors ------------------------------------------------------------------
def dc_pred(above, left, bw, bh, bd=8):
    """DC with both edges 'available' (prepared rows make this general only
    when the caller passes the right variant); spec uses the availability-
    specific averages, so callers pass have_above/have_left to predict()."""
    s = above[:, :bw].sum(axis=1) + left[:, :bh].sum(axis=1)
    avg = (s + ((bw + bh) >> 1)) // (bw + bh)
    return np.broadcast_to(avg[:, None, None], (len(above), bh, bw)).copy()


def dc_pred_avail(above, left, bw, bh, have_above, have_left, bd=8):
    """Availability-aware DC (spec dcPredict): [B] bool masks."""
    b = len(above)
    base = 1 << (bd - 1)
    sum_a = above[:, :bw].sum(axis=1)
    sum_l = left[:, :bh].sum(axis=1)
    both = (sum_a + sum_l + ((bw + bh) >> 1)) // (bw + bh)
    only_a = (sum_a + (bw >> 1)) >> int(np.log2(bw))
    only_l = (sum_l + (bh >> 1)) >> int(np.log2(bh))
    avg = np.where(have_above & have_left, both,
                   np.where(have_above, only_a,
                            np.where(have_left, only_l, base)))
    return np.broadcast_to(avg[:, None, None], (b, bh, bw)).copy()


def v_pred(above, left, bw, bh):
    return np.broadcast_to(above[:, None, :bw],
                           (len(above), bh, bw)).copy()


def h_pred(above, left, bw, bh):
    return np.broadcast_to(left[:, :bh, None],
                           (len(left), bh, bw)).copy()


def paeth_pred(above, left, top_left, bw, bh):
    a = above[:, None, :bw].astype(np.int32)
    l = left[:, :bh, None].astype(np.int32)
    tl = top_left[:, None, None].astype(np.int32)
    base = a + l - tl
    pa = np.abs(base - a)
    pl = np.abs(base - l)
    ptl = np.abs(base - tl)
    # tie order per spec: left wins over top wins over top-left
    return np.where((pl <= pa) & (pl <= ptl), l,
                    np.where(pa <= ptl, a, tl))


def smooth_pred(above, left, bw, bh):
    wh = _SM_WEIGHTS[bh][None, :, None]
    ww = _SM_WEIGHTS[bw][None, None, :]
    below = left[:, bh - 1][:, None, None].astype(np.int64)
    right = above[:, bw - 1][:, None, None].astype(np.int64)
    a = above[:, None, :bw].astype(np.int64)
    l = left[:, :bh, None].astype(np.int64)
    s = (wh * a + (_SM_SCALE - wh) * below
         + ww * l + (_SM_SCALE - ww) * right)
    return ((s + (1 << (_SM_ROUND - 1))) >> _SM_ROUND).astype(np.int32)


def smooth_v_pred(above, left, bw, bh):
    wh = _SM_WEIGHTS[bh][None, :, None]
    below = left[:, bh - 1][:, None, None].astype(np.int64)
    a = above[:, None, :bw].astype(np.int64)
    s = wh * a + (_SM_SCALE - wh) * below
    return ((s + (_SM_SCALE >> 1)) >> (_SM_ROUND - 1)).astype(np.int32)


def smooth_h_pred(above, left, bw, bh):
    ww = _SM_WEIGHTS[bw][None, None, :]
    right = above[:, bw - 1][:, None, None].astype(np.int64)
    l = left[:, :bh, None].astype(np.int64)
    s = ww * l + (_SM_SCALE - ww) * right
    return ((s + (_SM_SCALE >> 1)) >> (_SM_ROUND - 1)).astype(np.int32)


def predict_any(mode: int, angle_delta: int, above1: np.ndarray,
                left1: np.ndarray, bw: int, bh: int, have_above,
                have_left, bd: int = 8, edge=None) -> np.ndarray:
    """Dispatch any intra mode (incl. directional) over offset-1 edge
    arrays from ``prepare_edges_av1``. ``edge``: None (sequence signals
    enable_intra_edge_filter = 0) or (ftype [B], n_top [B], n_left [B])
    for the normative edge filter + upsample on directional modes."""
    from benchmark.avref.ops import intra_dir
    if intra_dir.is_directional(mode):
        angle = intra_dir.mode_angle(mode, angle_delta)
        if angle not in (90, 180):
            if edge is not None:
                return intra_dir.predict_directional_edge(
                    mode, angle_delta, above1.astype(np.int64),
                    left1.astype(np.int64), bw, bh,
                    np.asarray(have_above), np.asarray(have_left),
                    edge[0], edge[1], edge[2], bd=bd, xp=np)
            return intra_dir.predict_directional(mode, angle_delta, above1,
                                                 left1, bw, bh, bd)
    return predict(mode, above1[:, 1:], left1[:, 1:], above1[:, 0], bw, bh,
                   have_above=have_above, have_left=have_left, bd=bd)


def predict(mode: int, above, left, top_left, bw: int, bh: int,
            have_above=None, have_left=None, bd: int = 8) -> np.ndarray:
    """Dispatch one intra mode over a batch of prepared edges."""
    if have_above is None:
        have_above = np.ones(len(above), dtype=bool)
    if have_left is None:
        have_left = np.ones(len(above), dtype=bool)
    if mode == DC_PRED:
        return dc_pred_avail(above, left, bw, bh, have_above, have_left, bd)
    if mode == V_PRED:
        return v_pred(above, left, bw, bh)
    if mode == H_PRED:
        return h_pred(above, left, bw, bh)
    if mode == PAETH_PRED:
        return paeth_pred(above, left, top_left, bw, bh)
    if mode == SMOOTH_PRED:
        return smooth_pred(above, left, bw, bh)
    if mode == SMOOTH_V_PRED:
        return smooth_v_pred(above, left, bw, bh)
    if mode == SMOOTH_H_PRED:
        return smooth_h_pred(above, left, bw, bh)
    raise NotImplementedError(f"intra mode {mode} (directional modes: "
                              "post-MVP, needs edge filter + upsampling)")
