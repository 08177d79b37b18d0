"""Independent intra prediction-path conformance checker.

Round-1 VERDICT flagged that encoder and mirror decoder share
``ops.intra``/``pipeline.avail`` — a shared bug in prediction, edge
gathering or availability would be invisible to every roundtrip test.
This module re-implements that pixel path FROM THE SPEC (7.11.2
reference sample + prediction processes) in deliberately plain scalar
code that imports none of it, and decodes streams in lockstep with the
mirror, asserting per block:

- availability (have_above_right / have_bottom_left) derived from a
  from-scratch BlockDecoded simulation equals the mirror's table lookup;
- the final reconstruction equals independent-prediction + residual.

Independence boundary (documented, on purpose): entropy/syntax readers
and the integer inverse transforms are reused — syntax is genuinely
re-read from bits and the transforms are unit-validated against
independent float DCT/ADST references in tests/test_transforms.py. The
prediction path (predictors, angle derivation, edges, availability,
CfL) is what this module recomputes independently; only the normative
constant tables (sm_weights, dr_intra_derivative — spec tables) are
extracted by tools/extract_indep_tables.py.

Inter prediction is verified too: every single-ref and compound motion
compensation is recomputed with a plain scalar 8/4-tap convolve written
offset-free from the spec rounding chain (the reference's carried
offsets cancel algebraically), including a hard check that the sample
window stays inside the reference padding (an unclamped MV is a real
conformance failure). Sub-pel filter taps are normative constants
(tools/extract_indep_tables.py).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from svt_av1_tpu_torch.pipeline.decode import FrameDecoder, StreamDecoder

_DATA = Path(__file__).parent / "data" / "indep_tables.npz"


@functools.lru_cache(maxsize=1)
def _tables():
    with np.load(_DATA) as z:
        return {k: z[k] for k in z.files}


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n if n > 0 else x


# --- scalar predictors (spec 7.11.2.2-7.11.2.6) --------------------------------

def _dc(above, left, ha, hl, w, h, bd):
    if ha and hl:
        s = int(np.sum(above[:w])) + int(np.sum(left[:h]))
        return np.full((h, w), (s + ((w + h) >> 1)) // (w + h))
    if ha:
        return np.full((h, w), (int(np.sum(above[:w])) + (w >> 1)) // w)
    if hl:
        return np.full((h, w), (int(np.sum(left[:h])) + (h >> 1)) // h)
    return np.full((h, w), 1 << (bd - 1))


def _paeth(above, left, tl, w, h):
    out = np.empty((h, w), dtype=np.int64)
    for i in range(h):
        for j in range(w):
            base = int(above[j]) + int(left[i]) - int(tl)
            pa = abs(base - int(above[j]))
            pl = abs(base - int(left[i]))
            ptl = abs(base - int(tl))
            if pa <= pl and pa <= ptl:
                out[i, j] = above[j]
            elif pl <= ptl:
                out[i, j] = left[i]
            else:
                out[i, j] = tl
    return out


def _smooth(above, left, w, h, mode):
    sm = _tables()["sm_weight_arrays"]
    ww = sm[w:w + w]
    wh = sm[h:h + h]
    br = int(left[h - 1])    # bottom-left for vertical mix
    rt = int(above[w - 1])   # top-right for horizontal mix
    out = np.empty((h, w), dtype=np.int64)
    for i in range(h):
        for j in range(w):
            if mode == 9:       # SMOOTH: average of V and H mixes
                sv = int(wh[i]) * int(above[j]) + (256 - int(wh[i])) * br
                sh = int(ww[j]) * int(left[i]) + (256 - int(ww[j])) * rt
                out[i, j] = _round2(sv + sh, 9)
            elif mode == 10:    # SMOOTH_V
                sv = int(wh[i]) * int(above[j]) + (256 - int(wh[i])) * br
                out[i, j] = _round2(sv, 8)
            else:               # SMOOTH_H
                sh = int(ww[j]) * int(left[i]) + (256 - int(ww[j])) * rt
                out[i, j] = _round2(sh, 8)
    return out


_BASE_ANGLE = {1: 90, 2: 180, 3: 45, 4: 135, 5: 113, 6: 157, 7: 203, 8: 67}


def _directional(above1, left1, mode, delta, w, h):
    """spec 7.11.2.4 without edge filter/upsample (the sequence disables
    intra_edge_filter). above1/left1: offset-1 arrays, index 0 = corner."""
    dr = _tables()["dr_intra_derivative"]
    p_angle = _BASE_ANGLE[mode] + delta * 3
    out = np.empty((h, w), dtype=np.int64)
    if p_angle == 90:
        return np.tile(above1[1:1 + w], (h, 1)).astype(np.int64)
    if p_angle == 180:
        return np.tile(left1[1:1 + h, None], (1, w)).astype(np.int64)
    if p_angle < 90:                      # zone 1: above row only
        dx = int(dr[p_angle])
        max_base = w + h - 1
        for i in range(h):
            for j in range(w):
                idx = (i + 1) * dx
                base = (idx >> 6) + j
                shift = (idx >> 1) & 0x1F
                if base < max_base:
                    out[i, j] = _round2(
                        int(above1[1 + base]) * (32 - shift)
                        + int(above1[2 + base]) * shift, 5)
                else:
                    out[i, j] = above1[1 + max_base]
    elif p_angle > 180:                   # zone 3: left column only
        dy = int(dr[270 - p_angle])
        max_base = w + h - 1
        for i in range(h):
            for j in range(w):
                idx = (j + 1) * dy
                base = (idx >> 6) + i
                shift = (idx >> 1) & 0x1F
                if base < max_base:
                    out[i, j] = _round2(
                        int(left1[1 + base]) * (32 - shift)
                        + int(left1[2 + base]) * shift, 5)
                else:
                    out[i, j] = left1[1 + max_base]
    else:                                 # zone 2: both edges
        dx = int(dr[180 - p_angle])
        dy = int(dr[p_angle - 90])
        for i in range(h):
            for j in range(w):
                idx = (j << 6) - (i + 1) * dx
                base = idx >> 6
                if base >= -1:
                    shift = (idx >> 1) & 0x1F
                    out[i, j] = _round2(
                        int(above1[1 + base]) * (32 - shift)
                        + int(above1[2 + base]) * shift, 5)
                else:
                    idx = (i << 6) - (j + 1) * dy
                    base = idx >> 6
                    shift = (idx >> 1) & 0x1F
                    out[i, j] = _round2(
                        int(left1[1 + base]) * (32 - shift)
                        + int(left1[2 + base]) * shift, 5)
    return out


def _edges(recon, x, y, w, h, ha, hl, htr, hbl, bd, max_w, max_h):
    """spec 7.11.2 reference sample gathering (no filter/upsample).
    Returns offset-1 (above1, left1) with index 0 = corner sample."""
    base = 1 << (bd - 1)
    # gather can supply up to 2w (2h) real samples; directional reads
    # stop at index w+h-1 (maxBase), whichever is larger bounds the array
    above = np.empty(max(2 * w, w + h), dtype=np.int64)
    left = np.empty(max(2 * h, w + h), dtype=np.int64)
    if ha:
        # base w pixels, plus at most w more top-right ones when
        # haveAboveRight (spec/libaom: numTopRight = Min(w, to-edge));
        # everything past that replicates the last valid sample
        navail = min(w, max_w - x)
        if htr:
            navail += max(0, min(w, max_w - x - w))
        seg = recon[y - 1, x:x + navail].astype(np.int64)
        above[:navail] = seg
        above[navail:] = seg[-1]
    if hl:
        navail = min(h, max_h - y)
        if hbl:
            navail += max(0, min(h, max_h - y - h))
        seg = recon[y:y + navail, x - 1].astype(np.int64)
        left[:navail] = seg
        left[navail:] = seg[-1]
    if ha and not hl:
        left[:] = above[0]
    if hl and not ha:
        above[:] = left[0]
    if not ha and not hl:
        above[:] = base - 1
        left[:] = base + 1
    if ha and hl:
        corner = int(recon[y - 1, x - 1])
    elif ha:
        corner = int(above[0])
    elif hl:
        corner = int(left[0])
    else:
        corner = base
    above1 = np.concatenate([[corner], above])
    left1 = np.concatenate([[corner], left])
    return above1, left1



# --- independent intra edge filter + upsample (spec 7.11.2.7-7.11.2.10) --------

_EDGE_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))


def _edge_strength(blk_wh, delta, ftype):
    d = abs(delta)
    if ftype == 0:
        if blk_wh <= 8:
            return 1 if d >= 56 else 0
        if blk_wh <= 16:
            return 1 if d >= 40 else 0
        if blk_wh <= 24:
            return 3 if d >= 32 else (2 if d >= 16 else
                                      (1 if d >= 8 else 0))
        if blk_wh <= 32:
            return 3 if d >= 32 else (2 if d >= 4 else
                                      (1 if d >= 1 else 0))
        return 3 if d >= 1 else 0
    if blk_wh <= 8:
        return 2 if d >= 64 else (1 if d >= 40 else 0)
    if blk_wh <= 16:
        return 2 if d >= 48 else (1 if d >= 20 else 0)
    if blk_wh <= 24:
        return 3 if d >= 4 else 0
    return 3 if d >= 1 else 0


def _edge_use_upsample(blk_wh, delta, ftype):
    d = abs(delta)
    if d <= 0 or d >= 40:
        return False
    return blk_wh <= 8 if ftype else blk_wh <= 16


def _edge_filter_sc(p, sz, strength):
    """p: offset-1 array (corner at 0); filters 1..sz-1 in place."""
    if strength == 0:
        return
    kern = _EDGE_KERNELS[strength - 1]
    orig = p.copy()
    for i in range(1, sz):
        acc = 0
        for j in range(5):
            k = min(max(i - 2 + j, 0), sz - 1)
            acc += int(orig[k]) * kern[j]
        p[i] = (acc + 8) >> 4


def _edge_upsample_sc(p1, n_px, bd):
    """p1 offset-1 -> offset-2 array of length 2*n_px+1."""
    inp = np.empty(n_px + 3, dtype=np.int64)
    inp[0] = inp[1] = p1[0]
    inp[2:2 + n_px] = p1[1:1 + n_px]
    inp[n_px + 2] = p1[n_px]
    out = np.empty(2 * n_px + 1, dtype=np.int64)
    out[0] = inp[0]
    for i in range(n_px):
        v = -inp[i] + 9 * inp[i + 1] + 9 * inp[i + 2] - inp[i + 3]
        out[2 * i + 1] = min(max((v + 8) >> 4, 0), (1 << bd) - 1)
        out[2 * i + 2] = inp[i + 2]
    return out


def _directional_edge(above1, left1, mode, delta, w, h, ha, hl, ft,
                      n_top, n_left, bd):
    """Directional prediction under enable_intra_edge_filter = 1."""
    dr = _tables()["dr_intra_derivative"]
    p_angle = _BASE_ANGLE[mode] + delta * 3
    wh = w + h
    above1 = above1.astype(np.int64).copy()
    left1 = left1.astype(np.int64).copy()
    zone = 1 if p_angle < 90 else (2 if p_angle < 180 else 3)
    if zone == 2 and wh >= 24 and ha and hl:
        sc = (int(left1[1]) * 5 + int(above1[0]) * 6
              + int(above1[1]) * 5 + 8) >> 4
        above1[0] = left1[0] = sc
    if zone in (1, 2) and ha:
        st = _edge_strength(wh, p_angle - 90, ft)
        _edge_filter_sc(above1, min(w, n_top) + 1
                        + (h if zone == 1 else 0), st)
    if zone in (2, 3) and hl:
        st = _edge_strength(wh, p_angle - 180, ft)
        _edge_filter_sc(left1, min(h, n_left) + 1
                        + (w if zone == 3 else 0), st)
    up_a = up_l = 0
    off_a = off_l = 1
    if zone in (1, 2) and _edge_use_upsample(wh, p_angle - 90, ft):
        above1 = _edge_upsample_sc(above1, w + (h if zone == 1 else 0),
                                   bd)
        up_a, off_a = 1, 2
    if zone in (2, 3) and _edge_use_upsample(wh, p_angle - 180, ft):
        left1 = _edge_upsample_sc(left1, h + (w if zone == 3 else 0),
                                  bd)
        up_l, off_l = 1, 2
    out = np.empty((h, w), dtype=np.int64)
    mx = (1 << bd) - 1
    if zone == 1:
        dx = int(dr[p_angle])
        max_base = (w + h - 1) << up_a
        for i in range(h):
            idx = (i + 1) * dx
            base0 = idx >> (6 - up_a)
            shift = ((idx << up_a) >> 1) & 0x1F
            for j in range(w):
                base = base0 + (j << up_a)
                if base < max_base:
                    v = _round2(int(above1[off_a + base]) * (32 - shift)
                                + int(above1[off_a + base + 1]) * shift,
                                5)
                    out[i, j] = min(max(v, 0), mx)
                else:
                    out[i, j] = above1[off_a + max_base]
    elif zone == 3:
        dy = int(dr[270 - p_angle])
        max_base = (w + h - 1) << up_l
        for i in range(h):
            for j in range(w):
                idx = (j + 1) * dy
                base = (idx >> (6 - up_l)) + (i << up_l)
                shift = ((idx << up_l) >> 1) & 0x1F
                if base < max_base:
                    v = _round2(int(left1[off_l + base]) * (32 - shift)
                                + int(left1[off_l + base + 1]) * shift,
                                5)
                    out[i, j] = min(max(v, 0), mx)
                else:
                    out[i, j] = left1[off_l + max_base]
    else:
        dx = int(dr[180 - p_angle])
        dy = int(dr[p_angle - 90])
        for i in range(h):
            for j in range(w):
                idx = (j << 6) - (i + 1) * dx
                base = idx >> (6 - up_a)
                if base >= -(1 << up_a):
                    shift = ((idx << up_a) & 0x3F) >> 1
                    v = _round2(int(above1[off_a + base]) * (32 - shift)
                                + int(above1[off_a + base + 1]) * shift,
                                5)
                else:
                    idx = (i << 6) - (j + 1) * dy
                    base = idx >> (6 - up_l)
                    shift = ((idx << up_l) & 0x3F) >> 1
                    v = _round2(int(left1[off_l + base]) * (32 - shift)
                                + int(left1[off_l + base + 1]) * shift,
                                5)
                out[i, j] = min(max(v, 0), mx)
    return out


def predict_indep(recon, x, y, w, h, mode, delta, ha, hl, htr, hbl, bd,
                  max_w, max_h, edge=None):
    above1, left1 = _edges(recon, x, y, w, h, ha, hl, htr, hbl, bd,
                           max_w, max_h)
    above, left, tl = above1[1:], left1[1:], above1[0]
    if mode == 0:
        return _dc(above, left, ha, hl, w, h, bd)
    if mode in (9, 10, 11):
        return _smooth(above, left, w, h, mode)
    if mode == 12:
        return _paeth(above, left, tl, w, h)
    if edge is not None and _BASE_ANGLE[mode] + delta * 3 not in (90, 180):
        return _directional_edge(above1, left1, mode, delta, w, h,
                                 bool(ha), bool(hl), *edge, bd)
    return _directional(above1, left1, mode, delta, w, h)


# --- independent scalar motion compensation (spec 7.11.3) ----------------------

def _mc_window(refp, pad, px, py, mv, w, h, ss):
    """Integer window + filter phases for one block. refp is the padded
    plane (edge replication is data, not logic); raises if the 8-tap
    window escapes the padding — a real conformance failure (unclamped
    MV)."""
    sr = int(mv[0]) << (1 - ss)        # 1/8-pel luma -> 1/16-pel plane
    sc = int(mv[1]) << (1 - ss)
    ir = py + (sr >> 4)
    ic = px + (sc >> 4)
    y0 = ir + pad - 3
    x0 = ic + pad - 3
    if (y0 < 0 or x0 < 0 or y0 + h + 7 > refp.shape[0]
            or x0 + w + 7 > refp.shape[1]):
        raise MismatchError(
            f"MV {mv} at plane pos ({px},{py}) {w}x{h} ss={ss} escapes "
            f"the reference padding (window [{y0}:{y0 + h + 7},"
            f"{x0}:{x0 + w + 7}] of {refp.shape})")
    win = refp[y0:y0 + h + 7, x0:x0 + w + 7].astype(np.int64)
    return win, sr & 15, sc & 15


def _mc_filters(w, h, fr, fc, ftype=0):
    t = _tables()

    def pick(dim):
        if dim <= 4:
            return t["sub_pel_filters_4smooth"] if ftype == 1 \
                else t["sub_pel_filters_4"]
        return [t["sub_pel_filters_8"], t["sub_pel_filters_8smooth"],
                t["sub_pel_filters_8sharp"]][ftype]

    return [int(v) for v in pick(w)[fc]], [int(v) for v in pick(h)[fr]]


def _mc_vert_pass(win, fx, fy, w, h, round1):
    """Offset-free 2D convolve: horizontal Round2(·,3) then vertical
    Round2(·,round1). Algebraically identical to the reference's
    offset-carrying av1_convolve_2d_c chain (the offsets cancel)."""
    mid = np.empty((h + 7, w), dtype=np.int64)
    for i in range(h + 7):
        for j in range(w):
            s = sum(fx[t] * int(win[i, j + t]) for t in range(8))
            mid[i, j] = _round2(s, 3)
    out = np.empty((h, w), dtype=np.int64)
    for i in range(h):
        for j in range(w):
            s = sum(fy[t] * int(mid[i + t, j]) for t in range(8))
            out[i, j] = _round2(s, round1)
    return out


def mc_single_indep(refp, pad, px, py, mv, w, h, ss, bd, ftype=0):
    win, fr, fc = _mc_window(refp, pad, px, py, mv, w, h, ss)
    fx, fy = _mc_filters(w, h, fr, fc, ftype)
    return np.clip(_mc_vert_pass(win, fx, fy, w, h, 11), 0,
                   (1 << bd) - 1)


def mc_compound_indep(rp0, rp1, pad, px, py, mv0, mv1, w, h, ss, bd,
                      ftype=0):
    """Compound average, offset-free: each side convolved with the
    compound round (7), floor-halved, then Round2 by the remaining 4
    bits (equal-weight distance compound; jnt weights disabled
    sequence-wide)."""
    sides = []
    for refp, mv in ((rp0, mv0), (rp1, mv1)):
        win, fr, fc = _mc_window(refp, pad, px, py, mv, w, h, ss)
        fx, fy = _mc_filters(w, h, fr, fc, ftype)
        sides.append(_mc_vert_pass(win, fx, fy, w, h, 7))
    avg = (sides[0] + sides[1]) >> 1
    return np.clip(_round2_arr(avg, 4), 0, (1 << bd) - 1)


def _round2_arr(x, n):
    return (x + (1 << (n - 1))) >> n


# --- BlockDecoded-simulation availability (spec 7.11.2) ------------------------

class _DecodedMap:
    """Tracks decoded 4x4 luma units in decode order; availability is a
    direct query instead of the extracted closed-form tables."""

    def __init__(self, mi_rows, mi_cols):
        self.map = np.zeros((mi_rows, mi_cols), dtype=bool)
        self.mi_rows, self.mi_cols = mi_rows, mi_cols

    def mark(self, r, c, w4, h4):
        self.map[r:r + h4, c:c + w4] = True

    def top_right(self, r, c, w4, h4):
        if r == 0 or c + w4 >= self.mi_cols:
            return False
        return bool(self.map[r - 1, c + w4])

    def bottom_left(self, r, c, w4, h4):
        if c == 0 or r + h4 >= self.mi_rows:
            return False
        return bool(self.map[r + h4, c - 1])


# --- lockstep checking decoder -------------------------------------------------

class MismatchError(AssertionError):
    pass


class IndepFrameDecoder(FrameDecoder):
    """Mirror decoder that re-derives availability and every intra
    prediction independently and asserts agreement per block.

    Hooks live in the *tails* (not ``_decode_block``) because rect and
    4:1 sub-blocks are decoded straight from ``_decode_partition``."""

    def _decode_one_tile(self, data, sb_rs, sb_cs):
        self._dmap = _DecodedMap(self.mi_rows, self.mi_cols)
        self.checked_blocks = getattr(self, "checked_blocks", 0)
        self._checking = False
        super()._decode_one_tile(data, sb_rs, sb_cs)

    def _decode_inter_tail(self, mi_row, mi_col, size, skip):
        super()._decode_inter_tail(mi_row, mi_col, size, skip)
        from svt_av1_tpu_torch.pipeline import common
        bw, bh = common.leaf_wh(size)
        self._dmap.mark(mi_row, mi_col, bw >> 2, bh >> 2)

    def _ref_pad(self, ref_plane, ss):
        return (ref_plane.shape[0] - ((self.seq.sb_rows * 64) >> ss)) // 2

    def _single_pred(self, ref_plane, px, py, mv, pw, ph, ss,
                     ftype=0):
        pred = super()._single_pred(ref_plane, px, py, mv, pw, ph, ss,
                                    ftype)
        mine = mc_single_indep(ref_plane, self._ref_pad(ref_plane, ss),
                               px, py, mv, pw, ph, ss, self.bd, ftype)
        got = np.asarray(pred, dtype=np.int64)
        if not np.array_equal(got, mine):
            d = np.abs(got - mine)
            raise MismatchError(
                f"inter pred mismatch at ({px},{py}) {pw}x{ph} ss={ss} "
                f"mv={tuple(mv)}: max |diff| {int(d.max())} over "
                f"{int((d > 0).sum())} px")
        self.checked_blocks += 1
        return pred

    def _compound_pred(self, rp0, rp1, px, py, mv0, mv1, pw, ph, ss,
                       ftype=0):
        pred = super()._compound_pred(rp0, rp1, px, py, mv0, mv1, pw,
                                      ph, ss, ftype)
        mine = mc_compound_indep(rp0, rp1, self._ref_pad(rp0, ss), px,
                                 py, mv0, mv1, pw, ph, ss, self.bd,
                                 ftype)
        got = np.asarray(pred, dtype=np.int64)
        if not np.array_equal(got, mine):
            d = np.abs(got - mine)
            raise MismatchError(
                f"compound pred mismatch at ({px},{py}) {pw}x{ph} "
                f"ss={ss} mv0={tuple(mv0)} mv1={tuple(mv1)}: max |diff| "
                f"{int(d.max())} over {int((d > 0).sum())} px")
        self.checked_blocks += 1
        return pred

    def _decode_intra_tail(self, mi_row, mi_col, size, skip, kf):
        from svt_av1_tpu_torch.pipeline import common
        bw, bh = common.leaf_wh(size)
        self._my_htr = self._dmap.top_right(mi_row, mi_col, bw >> 2,
                                            bh >> 2)
        self._my_hbl = self._dmap.bottom_left(mi_row, mi_col, bw >> 2,
                                              bh >> 2)
        # compare availability up front (the same lookups the mirror is
        # about to make) so a flag disagreement is reported as such, not
        # as a downstream prediction mismatch
        from svt_av1_tpu_torch.pipeline import avail
        from svt_av1_tpu_torch.utils.blocks import (PARTITION_VERT_A,
                                              PARTITION_VERT_B)
        vab = getattr(self, "_leaf_part", None) in (PARTITION_VERT_A,
                                                    PARTITION_VERT_B)
        t_htr = bool(avail.has_top_right_wh(mi_row, mi_col, bw >> 2,
                                            bh >> 2, self.mi_cols,
                                            vert_ab=vab))
        t_hbl = bool(avail.has_bottom_left_wh(mi_row, mi_col, bw >> 2,
                                              bh >> 2, self.mi_rows,
                                              vert_ab=vab))
        if (self._my_htr, self._my_hbl) != (t_htr, t_hbl):
            raise MismatchError(
                f"availability mismatch at mi ({mi_row},{mi_col}) "
                f"{bw}x{bh}: indep ({self._my_htr},{self._my_hbl}) vs "
                f"tables ({t_htr},{t_hbl})")
        self._checking = True
        try:
            super()._decode_intra_tail(mi_row, mi_col, size, skip, kf=kf)
        finally:
            self._checking = False
        self._dmap.mark(mi_row, mi_col, bw >> 2, bh >> 2)

    def _expected_recon(self, plane, x, y, tx_size, qcoeff, tx_type,
                        pred):
        from svt_av1_tpu_torch.ops import quant as quant_ops
        from svt_av1_tpu_torch.ops import transforms as tx_ops
        from svt_av1_tpu_torch.pipeline import common
        from svt_av1_tpu_torch.utils.blocks import TX_HEIGHT, TX_WIDTH
        tw, th = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        pred = np.asarray(pred, dtype=np.int64)
        if qcoeff is None or not np.any(qcoeff):
            return np.clip(pred, 0, (1 << self.bd) - 1)
        cw, ch = common.coded_dims(tx_size)
        dq = quant_ops.dequantize(qcoeff.reshape(1, -1), self.qp,
                                  quant_ops.tx_scale(tx_size))
        full = np.zeros((1, th, tw), dtype=np.int64)
        full[0, :ch, :cw] = dq.reshape(ch, cw)
        resid = tx_ops.inverse_tx2d(full, tx_type, tw, th, bd=self.bd)
        return tx_ops.recon_add(pred[None], resid, bd=self.bd)[0]

    def _predict_into(self, plane, x, y, tx_size, mode, delta, qcoeff,
                      tx_type):
        super()._predict_into(plane, x, y, tx_size, mode, delta, qcoeff,
                              tx_type)
        if not self._checking:
            return
        from svt_av1_tpu_torch.utils.blocks import TX_HEIGHT, TX_WIDTH
        tw, th = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        max_w, max_h = self.max_wh[plane]
        if plane > 0 and mode == 13:        # UV_CFL_PRED (spec 7.11.5)
            above1, left1 = _edges(self.recon[plane], x, y, tw, th,
                                   y > 0, x > 0, self._my_htr,
                                   self._my_hbl, self.bd, max_w, max_h)
            dc = _dc(above1[1:], left1[1:], y > 0, x > 0, tw, th,
                     self.bd)
            luma = self.recon[0][2 * y:2 * (y + th),
                                 2 * x:2 * (x + tw)].astype(np.int64)
            sub = (luma[0::2, 0::2] + luma[0::2, 1::2]
                   + luma[1::2, 0::2] + luma[1::2, 1::2]) << 1
            avg = _round2(int(np.sum(sub)), int(np.log2(tw * th)))
            ac = sub - avg
            alpha = int(self._cfl_alphas[plane - 1])
            scaled = alpha * ac
            pred = dc + np.where(scaled >= 0,
                                 (np.abs(scaled) + 32) >> 6,
                                 -((np.abs(scaled) + 32) >> 6))
        else:
            edge = None
            if self.seq.enable_intra_edge_filter:
                edge = (int(self._ftype[int(plane > 0)]),
                        int(np.clip(max_w - x, 0, tw)),
                        int(np.clip(max_h - y, 0, th)))
            pred = predict_indep(self.recon[plane], x, y, tw, th, mode,
                                 delta, y > 0, x > 0, self._my_htr,
                                 self._my_hbl, self.bd, max_w, max_h,
                                 edge=edge)
        # the mirror already overwrote the block interior, but intra
        # edges only read above/left neighbors, which are untouched
        expect = self._expected_recon(plane, x, y, tx_size, qcoeff,
                                      tx_type, pred)
        got = self.recon[plane][y:y + th, x:x + tw].astype(np.int64)
        if not np.array_equal(got, expect):
            d = np.abs(got - expect)
            raise MismatchError(
                f"intra pred mismatch plane {plane} at ({x},{y}) "
                f"{tw}x{th} mode {mode} delta {delta}: max |diff| "
                f"{int(d.max())} over {int((d > 0).sum())} px")
        self.checked_blocks += 1


class IndepStreamDecoder(StreamDecoder):
    """StreamDecoder running the checking FrameDecoder; accumulates the
    number of independently verified intra blocks."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.checked_blocks = 0
        outer = self

        class _Counting(IndepFrameDecoder):
            def _decode_one_tile(s, data, sb_rs, sb_cs):
                super()._decode_one_tile(data, sb_rs, sb_cs)
                outer.checked_blocks += s.checked_blocks
                s.checked_blocks = 0

        self.frame_decoder_cls = _Counting


def check_ivf(fh) -> int:
    """Decode an IVF stream with the independent checker; raises
    MismatchError on any disagreement. Returns blocks checked."""
    from svt_av1_tpu_torch.bitstream.ivf import read_ivf
    _, frames = read_ivf(fh)
    dec = IndepStreamDecoder()
    for _, payload in frames:
        dec.decode_tu(payload)
    return dec.checked_blocks
