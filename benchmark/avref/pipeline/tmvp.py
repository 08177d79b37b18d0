"""Temporal MV projection — spec 7.9 motion field estimation.

The reference (v0.4.0) stubs TMVP out of setup_ref_mv_list (the
"-------- TMVP --------" comment block, EbAdaptiveMotionVectorPrediction.c:1002
— order hints were off in that encoder), so this module implements the
*final spec* semantics directly:

- per-frame motion-field storage at 8x8 granularity (spec 7.19: only
  MVs pointing at *past* refs, magnitude-capped, second ref wins);
- motion field projection from up to 3 source frames in the normative
  order LAST, BWD, ALTREF2, ALTREF, LAST2 (spec 7.9.2 order with the
  last-overlay skip), scaling each stored MV by the order-hint distance
  ratio via the 1/den multiplier table (spec 7.9.3 get_mv_projection);
- the per-block temporal sample scan lives in pipeline.mvp (spec
  7.10.2.? add_tpl_ref_mv integration points).

Encoder and decoder both drive these functions from their reference-slot
stores, so the projected fields cannot diverge.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.avref.bitstream.obu import get_relative_dist  # noqa: F401

# named refs (mvp.py numbering)
LAST_FRAME = 1
LAST2_FRAME = 2
LAST3_FRAME = 3
GOLDEN_FRAME = 4
BWDREF_FRAME = 5
ALTREF2_FRAME = 6
ALTREF_FRAME = 7

MAX_FRAME_DISTANCE = 31
REFMVS_LIMIT = (1 << 12) - 1      # saved-MV magnitude cap (1/8-pel)
MAX_OFFSET_WIDTH = 64             # px; projection landing-window clamps
MAX_OFFSET_HEIGHT = 0
MFMV_STACK_SIZE = 3               # max projection passes

# 16384/den rounded (spec 7.9.3 div_mult); index 0 unused
DIV_MULT = np.array([
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638,
    1489, 1365, 1260, 1170, 1092, 1024, 963, 910, 862, 819, 780, 744,
    712, 682, 655, 630, 606, 585, 564, 546, 528], dtype=np.int64)


def mv_projection(mv, num: int, den: int):
    """Scale ``mv`` by num/den (spec 7.9.3): sign-aware round of
    mv * num * (16384/den) >> 14, clamped to the MV range."""
    den = min(den, MAX_FRAME_DISTANCE)
    num = min(num, MAX_FRAME_DISTANCE) if num > 0 \
        else max(num, -MAX_FRAME_DISTANCE)
    out = []
    for v in mv:
        s = int(v) * num * int(DIV_MULT[den])
        r = (s + 8192) >> 14 if s >= 0 else -((-s + 8192) >> 14)
        out.append(int(np.clip(r, -(1 << 15) + 1, (1 << 15) - 1)))
    return (out[0], out[1])


def lower_precision(mv):
    """lower_mv_precision for allow_high_precision_mv=0: force even."""
    r, c = mv
    if r & 1:
        r += -1 if r > 0 else 1
    if c & 1:
        c += -1 if c > 0 else 1
    return (r, c)


@dataclasses.dataclass
class SlotInfo:
    """Per-reference-slot frame facts needed for TMVP (both sides keep
    one per slot, refreshed with the frame that lands there)."""
    order_hint: int = 0
    # order hints of THAT frame's 7 named refs (LAST..ALTREF)
    ref_order_hints: tuple = (0,) * 7
    is_intra: bool = True
    # 8x8 motion field: ref[r8, c8] named-ref id (-1 none), mv[r8, c8, 2]
    field_ref: np.ndarray = None
    field_mv: np.ndarray = None


def save_motion_field(state, rel_dist) -> tuple:
    """Extract the frame's 8x8 saved motion field from the final
    MvpState (spec 7.19 storage rules: only past-pointing MVs, capped at
    REFMVS_LIMIT, second listed ref wins). ``rel_dist[ref]`` =
    get_relative_dist(ref_hint, cur_hint) per named ref (1..7)."""
    rows8 = (state.mi_rows + 1) >> 1
    cols8 = (state.mi_cols + 1) >> 1
    ref8 = np.full((rows8, cols8), -1, dtype=np.int8)
    mv8 = np.zeros((rows8, cols8, 2), dtype=np.int16)
    # blocks are >= 8x8 aligned, so the mi at (2r, 2c) covers cell (r, c)
    refs = [state.ref[0::2, 0::2], state.ref1[0::2, 0::2]]
    mvs = [state.mv[0::2, 0::2], state.mv1[0::2, 0::2]]
    for ref_map, mv_map in zip(refs, mvs):      # second entry overwrites
        r = ref_map[:rows8, :cols8]
        m = mv_map[:rows8, :cols8]
        past = np.zeros_like(r, dtype=bool)
        for ref in range(1, 8):
            if rel_dist[ref] < 0:
                past |= (r == ref)
        ok = past & (np.abs(m[..., 0]) <= REFMVS_LIMIT) \
            & (np.abs(m[..., 1]) <= REFMVS_LIMIT)
        ref8[ok] = r[ok].astype(np.int8)
        mv8[ok] = m[ok].astype(np.int16)
    return ref8, mv8


def _project_one(tpl, start: SlotInfo, dir_: int, cur_hint: int,
                 bits: int, mi_rows: int, mi_cols: int) -> bool:
    """motion_field_projection for one start frame (spec 7.9.2 body).
    dir_ = 2 projects a past frame (offset negated), 0 a future one."""
    if start is None or start.is_intra or start.field_ref is None:
        return False
    start_hint = start.order_hint
    start_to_cur = get_relative_dist(start_hint, cur_hint, bits)
    if dir_ == 2:
        start_to_cur = -start_to_cur
    # distance from the start frame to each of ITS refs
    ref_offset = [0] * 8
    for ref in range(1, 8):
        ref_offset[ref] = get_relative_dist(
            start_hint, start.ref_order_hints[ref - 1], bits)
    rows8 = (mi_rows + 1) >> 1
    cols8 = (mi_cols + 1) >> 1
    sign_bias = dir_ >> 1
    if abs(start_to_cur) > MAX_FRAME_DISTANCE:
        return True
    # vectorized over the whole 8x8 grid (cell order doesn't matter:
    # writes to the same landing cell are last-writer-wins in raster
    # order both here and in the scalar spec loop)
    refs = start.field_ref[:rows8, :cols8].astype(np.int64)
    offs = np.asarray(ref_offset, dtype=np.int64)[np.clip(refs, 0, 7)]
    valid = (refs > 0) & (offs > 0) & (offs <= MAX_FRAME_DISTANCE)
    fwd = start.field_mv[:rows8, :cols8].astype(np.int64)
    num = min(start_to_cur, MAX_FRAME_DISTANCE) if start_to_cur > 0 \
        else max(start_to_cur, -MAX_FRAME_DISTANCE)
    s = fwd * num * DIV_MULT[np.clip(offs, 0, MAX_FRAME_DISTANCE)][..., None]
    proj = np.where(s >= 0, (s + 8192) >> 14, -((-s + 8192) >> 14))
    proj = np.clip(proj, -(1 << 15) + 1, (1 << 15) - 1)
    # landing position (spec get_block_position): 1/8-pel -> 8-px units
    # with toward-zero shift; clamped to a 64px-wide window around the
    # source cell and to the frame
    ro = np.where(proj[..., 0] >= 0, proj[..., 0] >> 6,
                  -((-proj[..., 0]) >> 6))
    co = np.where(proj[..., 1] >= 0, proj[..., 1] >> 6,
                  -((-proj[..., 1]) >> 6))
    br = np.arange(rows8)[:, None]
    bc = np.arange(cols8)[None, :]
    row = br - ro if sign_bias else br + ro
    col = bc - co if sign_bias else bc + co
    base_r = (br >> 3) << 3
    base_c = (bc >> 3) << 3
    valid &= (row >= 0) & (row < (mi_rows >> 1)) \
        & (col >= 0) & (col < (mi_cols >> 1)) \
        & (row >= base_r - (MAX_OFFSET_HEIGHT >> 3)) \
        & (row < base_r + 8 + (MAX_OFFSET_HEIGHT >> 3)) \
        & (col >= base_c - (MAX_OFFSET_WIDTH >> 3)) \
        & (col < base_c + 8 + (MAX_OFFSET_WIDTH >> 3))
    rows_v = row[valid]
    cols_v = col[valid]
    tpl[rows_v, cols_v, 0] = fwd[..., 0][valid]
    tpl[rows_v, cols_v, 1] = fwd[..., 1][valid]
    tpl[rows_v, cols_v, 2] = offs[valid]
    return True


def build_tpl_field(mi_rows: int, mi_cols: int, cur_hint: int,
                    ref_frame_idx, slot_infos, bits: int) -> np.ndarray:
    """The current frame's projected motion field (spec 7.9.2 order;
    av1_setup_motion_field). Returns [rows8 + 8 + 1, cols8 + 8 + 1, 3]
    int32 (mv_row, mv_col, ref_frame_offset); offset <= 0 marks invalid
    (the padding rows keep out-of-frame sample positions harmlessly
    invalid)."""
    rows8 = (mi_rows + 1) >> 1
    cols8 = (mi_cols + 1) >> 1
    tpl = np.zeros((rows8 + 9, cols8 + 9, 3), dtype=np.int32)

    def slot(ref):
        return slot_infos[ref_frame_idx[ref - 1]]

    def hint(ref):
        s = slot(ref)
        return s.order_hint if s is not None else 0

    ref_stamp = MFMV_STACK_SIZE - 1
    last = slot(LAST_FRAME)
    if last is not None and last.field_ref is not None:
        # skip when LAST is the overlay of current GOLDEN (its ALTREF
        # was the same display frame)
        alt_of_lst = last.ref_order_hints[ALTREF_FRAME - 1]
        is_lst_overlay = alt_of_lst == hint(GOLDEN_FRAME)
        if not is_lst_overlay:
            _project_one(tpl, last, 2, cur_hint, bits, mi_rows, mi_cols)
        ref_stamp -= 1
    if get_relative_dist(hint(BWDREF_FRAME), cur_hint, bits) > 0:
        if _project_one(tpl, slot(BWDREF_FRAME), 0, cur_hint, bits,
                        mi_rows, mi_cols):
            ref_stamp -= 1
    if get_relative_dist(hint(ALTREF2_FRAME), cur_hint, bits) > 0:
        if _project_one(tpl, slot(ALTREF2_FRAME), 0, cur_hint, bits,
                        mi_rows, mi_cols):
            ref_stamp -= 1
    if get_relative_dist(hint(ALTREF_FRAME), cur_hint, bits) > 0 \
            and ref_stamp >= 0:
        if _project_one(tpl, slot(ALTREF_FRAME), 0, cur_hint, bits,
                        mi_rows, mi_cols):
            ref_stamp -= 1
    if ref_stamp >= 0:
        _project_one(tpl, slot(LAST2_FRAME), 2, cur_hint, bits,
                     mi_rows, mi_cols)
    return tpl
