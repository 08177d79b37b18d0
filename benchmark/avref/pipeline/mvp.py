"""Reference-MV stack construction (AV1 find_mv_stack, single reference).

Port of the normative algorithm's semantics (reference:
setup_ref_mv_list ``EbAdaptiveMotionVectorPrediction.c:905``, scans :685-835,
add_ref_mv_candidate :595) for this encoder's shape: blocks >= 8x8,
translation-only global motion, single tile. Temporal MV candidates
(use_ref_frame_mvs) ride the projected field built by
``pipeline.tmvp`` — the reference v0.4.0 stubs TMVP out (comment block
:1002), so the temporal arm follows the final spec directly.

Both the encoder syntax pass and the decoder drive the same ``MvpState``;
the stack, DRL contexts and mode contexts are derived here for both, so
they cannot diverge.
"""

from __future__ import annotations

import numpy as np

MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
REF_CAT_LEVEL = 640
MV_BORDER = 128  # 1/8-pel units (16 px)
MVREF_ROWS = 3

NONE_FRAME = -1
INTRA_FRAME = 0
LAST_FRAME = 1
BWDREF_FRAME = 5
ALTREF_FRAME = 7

# compound modes (AV1 enum, spec 6.10.24)
NEAREST_NEARESTMV = 17
NEAR_NEARMV = 18
NEAREST_NEWMV = 19
NEW_NEARESTMV = 20
NEAR_NEWMV = 21
NEW_NEARMV = 22
GLOBAL_GLOBALMV = 23
NEW_NEWMV = 24

# prediction modes (AV1 joint enum tail)
NEARESTMV = 13
NEARMV = 14
GLOBALMV = 15
NEWMV = 16


def _has_newmv(mode: int) -> bool:
    """have_newmv_in_inter_mode (spec): NEWMV or any compound *NEW* mode."""
    return mode in (NEWMV, NEW_NEWMV, NEAREST_NEWMV, NEW_NEARESTMV,
                    NEAR_NEWMV, NEW_NEARMV)


class MvpState:
    """Per-frame coded motion info at mi (4x4) granularity."""

    def __init__(self, mi_rows: int, mi_cols: int):
        self.mi_rows = mi_rows
        self.mi_cols = mi_cols
        self.ref = np.full((mi_rows, mi_cols), INTRA_FRAME, dtype=np.int32)
        self.mv = np.zeros((mi_rows, mi_cols, 2), dtype=np.int32)
        # second reference of a compound block (NONE_FRAME when single)
        self.ref1 = np.full((mi_rows, mi_cols), NONE_FRAME, dtype=np.int32)
        self.mv1 = np.zeros((mi_rows, mi_cols, 2), dtype=np.int32)
        self.mode = np.zeros((mi_rows, mi_cols), dtype=np.int32)
        # per-mi interp filter of coded inter blocks (switchable-filter
        # neighbor context; 0 = REGULAR)
        self.interp = np.zeros((mi_rows, mi_cols), dtype=np.int32)
        self.n8w = np.ones((mi_rows, mi_cols), dtype=np.int32)
        self.n8h = np.ones((mi_rows, mi_cols), dtype=np.int32)
        # temporal MV projection context (use_ref_frame_mvs frames):
        # tpl[r8, c8] = (mv_row, mv_col, ref_frame_offset>0) from
        # tmvp.build_tpl_field; rel_dist[ref] = dist(cur, ref) per named
        # ref; sign_bias[ref] for the compound collect inversion
        self.tpl = None
        self.rel_dist = None
        self.sign_bias = [0] * 8
        # tile placement: scans clip at this state's own bounds (spec
        # MiRowStart/MiColEnd semantics) but MV clamping is against the
        # FRAME edges (spec 7.10.2.14 uses MiRows/MiCols) — a tile view
        # carries its mi offset and the frame dims for that
        self.mi_off = (0, 0)
        self.frame_mi_rows = mi_rows
        self.frame_mi_cols = mi_cols
        self._tpl_parent = None

    def tile_view(self, mi_r0: int, mi_c0: int, mi_rs: int,
                  mi_cs: int) -> "MvpState":
        """A tile-local window into this frame-level state: the mi maps
        are numpy VIEWS (tile writes land in the frame arrays, so the
        frame-end motion-field save reads one stitched state), spatial
        scans clip at the view bounds (out-of-tile mi's are unavailable,
        spec 7.10.2), and TPL projections are shared slices of the
        frame-level projection."""
        t = MvpState.__new__(MvpState)
        t.mi_rows, t.mi_cols = mi_rs, mi_cs
        for f in ("ref", "mv", "ref1", "mv1", "mode", "interp", "n8w",
                  "n8h"):
            setattr(t, f, getattr(self, f)[mi_r0:mi_r0 + mi_rs,
                                           mi_c0:mi_c0 + mi_cs])
        t.mi_off = (self.mi_off[0] + mi_r0, self.mi_off[1] + mi_c0)
        t.frame_mi_rows = self.frame_mi_rows
        t.frame_mi_cols = self.frame_mi_cols
        # tpl keeps the +9 sample-padding tail rows/cols at the end
        # (tile origins are SB-aligned, hence even in mi units)
        t.tpl = None if self.tpl is None \
            else self.tpl[mi_r0 >> 1:, mi_c0 >> 1:]
        t.rel_dist = self.rel_dist
        t.sign_bias = self.sign_bias
        t._tpl_parent = self
        return t

    def tpl_proj(self, ref: int):
        """(valid [gh, gw] bool, mv [gh, gw, 2] int32): the projected +
        precision-lowered TPL MV grid for ``ref``, cached per frame.
        The normative mv_projection runs over the whole field in one
        vectorized pass instead of once per scanned sample (the scan is
        on the per-block syntax hot path)."""
        from benchmark.avref.pipeline import tmvp
        if self._tpl_parent is not None:
            # share the frame-level projection; slice to the tile window
            valid, r = self._tpl_parent.tpl_proj(ref)
            r0, c0 = self.mi_off[0] >> 1, self.mi_off[1] >> 1
            return valid[r0:, c0:], r[r0:, c0:]
        cache = getattr(self, "_tpl_proj", None)
        if cache is None:
            cache = self._tpl_proj = {}
        e = cache.get(ref)
        if e is None:
            t = self.tpl
            dist = t[..., 2].astype(np.int64)
            valid = dist > 0
            den = np.minimum(np.maximum(dist, 1),
                             tmvp.MAX_FRAME_DISTANCE)
            num = self.rel_dist[ref]
            num = min(num, tmvp.MAX_FRAME_DISTANCE) if num > 0 \
                else max(num, -tmvp.MAX_FRAME_DISTANCE)
            s = t[..., :2].astype(np.int64) * num \
                * tmvp.DIV_MULT[den][..., None]
            r = np.where(s >= 0, (s + 8192) >> 14, -((-s + 8192) >> 14))
            r = np.clip(r, -(1 << 15) + 1, (1 << 15) - 1)
            r = np.where(r & 1, r - np.sign(r), r)  # lower_precision
            e = (valid, r.astype(np.int32))
            cache[ref] = e
        return e

    def set_block(self, mi_row: int, mi_col: int, s4: int, ref: int,
                  mv, mode: int, ref1: int = NONE_FRAME,
                  mv1=(0, 0), h4: int = None) -> None:
        r, c = mi_row, mi_col
        w4 = s4
        h4 = s4 if h4 is None else h4
        self.ref[r:r + h4, c:c + w4] = ref
        self.mv[r:r + h4, c:c + w4] = mv
        self.ref1[r:r + h4, c:c + w4] = ref1
        self.mv1[r:r + h4, c:c + w4] = mv1
        self.mode[r:r + h4, c:c + w4] = mode
        self.n8w[r:r + h4, c:c + w4] = w4
        self.n8h[r:r + h4, c:c + w4] = h4


def _mvp_has_top_right_rect(mi_row: int, mi_col: int, w4: int, h4: int,
                            sb_mi: int = 16,
                            vert_a: bool = False) -> bool:
    """Rect-aware MVP top-right (reference has_top_right
    EbAdaptiveMotionVectorPrediction.c:836): square rule on
    bs = max(w4, h4) plus the two-rectangle adjustments. ``vert_a``:
    the block is a square member of a PARTITION_VERT_A parent — its
    bottom-left square is coded before the right rectangle, so it has
    no top-right (reference :882)."""
    bs = max(w4, h4)
    has_tr = _mvp_has_top_right(mi_row, mi_col, bs, sb_mi)
    if w4 < h4:
        is_sec_rect = bool(mi_col & (h4 - 1))
        if not is_sec_rect:
            has_tr = True
    if w4 > h4:
        is_sec_rect = bool(mi_row & (w4 - 1))
        if is_sec_rect:
            has_tr = False
    if vert_a and w4 == h4 and ((mi_row & (sb_mi - 1)) & bs):
        has_tr = False
    return has_tr


def _mvp_has_top_right(mi_row: int, mi_col: int, bs: int,
                       sb_mi: int = 16) -> bool:
    """MVP-specific top-right rule (reference :836; square blocks only)."""
    mask_row = mi_row & (sb_mi - 1)
    mask_col = mi_col & (sb_mi - 1)
    if bs > 16:
        return False
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    b = bs
    while b < sb_mi:
        if mask_col & b:
            if (mask_col & (2 * b)) and (mask_row & (2 * b)):
                has_tr = False
                break
        else:
            break
        b <<= 1
    return has_tr


def _clamp_mv_ref(mv, mi_row, mi_col, s4, mi_rows, mi_cols, h4=None):
    bw = s4 * 4
    bh = (s4 if h4 is None else h4) * 4
    to_left = -(mi_col * 32)
    to_right = (mi_cols - mi_col) * 32 - bw * 8
    to_top = -(mi_row * 32)
    to_bottom = (mi_rows - mi_row) * 32 - bh * 8
    row = int(np.clip(mv[0], to_top - bh * 8 - MV_BORDER,
                      to_bottom + bh * 8 + MV_BORDER))
    col = int(np.clip(mv[1], to_left - bw * 8 - MV_BORDER,
                      to_right + bw * 8 + MV_BORDER))
    return (row, col)


class MvStackResult:
    __slots__ = ("stack", "count", "mode_context", "ref_list",
                 "nearest_count")

    def drl_ctx(self, idx: int) -> int:
        """av1_drl_ctx: context from adjacent stack weights."""
        w0 = self.stack[idx][1]
        w1 = self.stack[idx + 1][1] if idx + 1 < len(self.stack) else 0
        if w0 >= REF_CAT_LEVEL and w1 >= REF_CAT_LEVEL:
            return 0
        if w0 >= REF_CAT_LEVEL and w1 < REF_CAT_LEVEL:
            return 1
        if w0 < REF_CAT_LEVEL and w1 < REF_CAT_LEVEL:
            return 2
        return 0

    @property
    def newmv_ctx(self) -> int:
        return self.mode_context & 7

    @property
    def zeromv_ctx(self) -> int:
        return (self.mode_context >> 3) & 1

    @property
    def refmv_ctx(self) -> int:
        return (self.mode_context >> 4) & 0xF


def _scan_tpl_grid(scan_tpl, mi_row, mi_col, w4, h4, zeromv_bit,
                   sb_mi: int = 16):
    """Drive a temporal scan callback over the normative sample grid:
    the block's own 8x8 cells (step 2, or 4 for >=64px dims) plus three
    bottom-right extension samples when the block is mid-sized, each
    gated to stay inside the superblock (spec check_sb_range)."""
    is_avail = False
    step_h = 4 if h4 >= 16 else 2
    step_w = 4 if w4 >= 16 else 2
    for br in range(0, min(h4, 16), step_h):
        for bc in range(0, min(w4, 16), step_w):
            ret = scan_tpl(br, bc, br == 0 and bc == 0)
            if br == 0 and bc == 0:
                is_avail = ret
    if not is_avail:
        zeromv_bit[0] = True
    if 2 <= h4 < 16 and 2 <= w4 < 16:
        voffset = max(2, h4)
        hoffset = max(2, w4)
        mrow = mi_row & (sb_mi - 1)
        mcol = mi_col & (sb_mi - 1)
        for br, bc in ((voffset, -2), (voffset, hoffset),
                       (voffset - 2, hoffset)):
            if 0 <= mrow + br < sb_mi and 0 <= mcol + bc < sb_mi:
                scan_tpl(br, bc, False)


def find_mv_stack(state: MvpState, mi_row: int, mi_col: int,
                  s4: int, ref_frame: int = LAST_FRAME,
                  gm_mv=(0, 0), h4: int = None,
                  vert_a: bool = False) -> MvStackResult:
    """Build the ref-MV stack for a block (s4 = width in mi units; h4
    defaults square) against ``ref_frame``. ``gm_mv``: the frame's
    global translation MV for this ref. ``vert_a``: square member of a
    PARTITION_VERT_A parent (reference :882 top-right adjust)."""
    mi_rows, mi_cols = state.mi_rows, state.mi_cols
    w4 = s4
    h4 = s4 if h4 is None else h4
    stack = []          # [mv(tuple), weight]
    newmv_count = 0
    row_match = False
    col_match = False

    up_avail = mi_row > 0
    left_avail = mi_col > 0
    max_row_offset = 0
    max_col_offset = 0
    if up_avail:
        max_row_offset = max(-(MVREF_ROWS << 1), -mi_row)
    if left_avail:
        max_col_offset = max(-(MVREF_ROWS << 1), -mi_col)

    def add_candidate(r, c, len_, weight):
        nonlocal newmv_count
        matched = False
        for cref, cmv in ((state.ref[r, c], state.mv[r, c]),
                          (state.ref1[r, c], state.mv1[r, c])):
            if cref != ref_frame:
                continue
            mv = (int(cmv[0]), int(cmv[1]))
            for e in stack:
                if e[0] == mv:
                    e[1] += weight * len_
                    break
            else:
                if len(stack) < MAX_REF_MV_STACK_SIZE:
                    stack.append([mv, weight * len_])
            if _has_newmv(int(state.mode[r, c])):
                newmv_count += 1
            matched = True
        return matched

    processed_rows = 0
    processed_cols = 0

    def scan_row(row_offset):
        nonlocal processed_rows, row_match
        end_mi = min(w4, mi_cols - mi_col, 16)
        col_off = 1 if abs(row_offset) > 1 else 0
        use_step_16 = w4 >= 16
        i = 0
        while i < end_mi:
            r = mi_row + row_offset
            c = mi_col + col_off + i
            if c >= mi_cols:  # col_off=1 can step past the frame edge
                break
            cand_w = int(state.n8w[r, c])
            cand_h = int(state.n8h[r, c])
            length = min(w4, cand_w)
            if use_step_16:
                length = max(4, length)
            elif abs(row_offset) > 1:
                length = max(length, 2)
            weight = 2
            if 2 <= w4 <= cand_w:
                inc = min(-max_row_offset + row_offset + 1, cand_h)
                weight = max(weight, inc)
                processed_rows = inc - row_offset - 1
            if add_candidate(r, c, length, weight):
                row_match = True
            i += length

    def scan_col(col_offset):
        nonlocal processed_cols, col_match
        end_mi = min(h4, mi_rows - mi_row, 16)
        row_off = 1 if abs(col_offset) > 1 else 0
        use_step_16 = h4 >= 16
        i = 0
        while i < end_mi:
            r = mi_row + row_off + i
            c = mi_col + col_offset
            if r >= mi_rows:  # row_off=1 can step past the frame edge
                break
            cand_w = int(state.n8w[r, c])
            cand_h = int(state.n8h[r, c])
            length = min(h4, cand_h)
            if use_step_16:
                length = max(4, length)
            elif abs(col_offset) > 1:
                length = max(length, 2)
            weight = 2
            if 2 <= h4 <= cand_h:
                inc = min(-max_col_offset + col_offset + 1, cand_w)
                weight = max(weight, inc)
                processed_cols = inc - col_offset - 1
            if add_candidate(r, c, length, weight):
                col_match = True
            i += length

    def scan_blk(row_offset, col_offset, count_row_match=True):
        nonlocal row_match
        r = mi_row + row_offset
        c = mi_col + col_offset
        if 0 <= r < mi_rows and 0 <= c < mi_cols:
            if add_candidate(r, c, 2, 2) and count_row_match:
                row_match = True

    if abs(max_row_offset) >= 1:
        scan_row(-1)
    if abs(max_col_offset) >= 1:
        scan_col(-1)
    if _mvp_has_top_right_rect(mi_row, mi_col, w4, h4, vert_a=vert_a):
        scan_blk(-1, w4)

    nearest_match = int(row_match) + int(col_match)
    nearest_count = len(stack)
    nearest_newmv = newmv_count
    for e in stack[:nearest_count]:
        e[1] += REF_CAT_LEVEL

    # temporal scan (spec add_tpl_ref_mv over the center 8x8 grid plus
    # 3 bottom-right sample positions; sets the GLOBALMV/zeromv context
    # bit when the co-located projection is absent or far from gm)
    tpl_zeromv_bit = [False]
    if state.tpl is not None:
        tpl_valid, tpl_mv = state.tpl_proj(ref_frame)

        def scan_tpl(br, bc, center):
            gr, gc = (mi_row + br) >> 1, (mi_col + bc) >> 1
            if not tpl_valid[gr, gc]:
                return False
            mv = (int(tpl_mv[gr, gc, 0]), int(tpl_mv[gr, gc, 1]))
            if center and (abs(mv[0] - gm_mv[0]) >= 16
                           or abs(mv[1] - gm_mv[1]) >= 16):
                tpl_zeromv_bit[0] = True
            for s in stack:
                if s[0] == mv:
                    s[1] += 2
                    return True
            if len(stack) < MAX_REF_MV_STACK_SIZE:
                stack.append([mv, 2])
            return True

        _scan_tpl_grid(scan_tpl, mi_row, mi_col, w4, h4, tpl_zeromv_bit)

    saved_newmv = newmv_count
    scan_blk(-1, -1)
    for idx in range(2, MVREF_ROWS + 1):
        row_offset = -(idx << 1) + 1
        col_offset = -(idx << 1) + 1
        if abs(row_offset) <= abs(max_row_offset) \
                and abs(row_offset) > processed_rows:
            scan_row(row_offset)
        if abs(col_offset) <= abs(max_col_offset) \
                and abs(col_offset) > processed_cols:
            scan_col(col_offset)
    newmv_count = saved_newmv  # outer scans use a dummy newmv counter

    ref_match = int(row_match) + int(col_match)
    mode_context = 0
    if nearest_match == 0:
        if ref_match >= 1:
            mode_context |= 1
        if ref_match == 1:
            mode_context |= 1 << 4
        elif ref_match >= 2:
            mode_context |= 2 << 4
    elif nearest_match == 1:
        mode_context |= 2 if nearest_newmv > 0 else 3
        if ref_match == 1:
            mode_context |= 3 << 4
        elif ref_match >= 2:
            mode_context |= 4 << 4
    else:
        mode_context |= 4 if nearest_newmv >= 1 else 5
        mode_context |= 5 << 4
    if tpl_zeromv_bit[0]:
        mode_context |= 1 << 3       # GLOBALMV_OFFSET (zeromv ctx)

    # sort: nearest region then outer region (reference bubble semantics)
    def _bubble(lo, hi):
        ln = hi
        while ln > lo:
            nr = lo
            for idx in range(lo + 1, ln):
                if stack[idx - 1][1] < stack[idx][1]:
                    stack[idx - 1], stack[idx] = stack[idx], stack[idx - 1]
                    nr = idx
            ln = nr

    _bubble(0, nearest_count)
    _bubble(nearest_count, len(stack))

    # single-ref extension: relaxed re-scan of row -1 / col -1
    mi_size = min(min(16, w4, mi_cols - mi_col),
                  min(16, h4, mi_rows - mi_row))

    def relaxed_scan(row: bool):
        i = 0
        while i < mi_size and len(stack) < MAX_MV_REF_CANDIDATES:
            r = (mi_row - 1, mi_col + i) if row else (mi_row + i, mi_col - 1)
            rr, cc = r
            for cref, cmv in ((state.ref[rr, cc], state.mv[rr, cc]),
                              (state.ref1[rr, cc], state.mv1[rr, cc])):
                if cref <= INTRA_FRAME \
                        or len(stack) >= MAX_MV_REF_CANDIDATES:
                    continue
                mv = (int(cmv[0]), int(cmv[1]))
                if all(e[0] != mv for e in stack):
                    stack.append([mv, 2])
            i += int(state.n8w[rr, cc] if row else state.n8h[rr, cc])

    if abs(max_row_offset) >= 1:
        relaxed_scan(True)
    if abs(max_col_offset) >= 1:
        relaxed_scan(False)

    fr0, fc0 = state.mi_off
    for e in stack:
        e[0] = _clamp_mv_ref(e[0], mi_row + fr0, mi_col + fc0, w4,
                             state.frame_mi_rows, state.frame_mi_cols, h4)

    ref_list = [gm_mv, gm_mv]
    for idx in range(min(MAX_MV_REF_CANDIDATES, len(stack))):
        ref_list[idx] = tuple(stack[idx][0])

    res = MvStackResult()
    res.stack = [(tuple(e[0]), e[1]) for e in stack]
    res.count = len(stack)
    res.mode_context = mode_context
    res.ref_list = ref_list
    res.nearest_count = nearest_count
    return res


def find_mv_stack_comp(state: MvpState, mi_row: int, mi_col: int,
                       s4: int, rf0: int = LAST_FRAME,
                       rf1: int = ALTREF_FRAME,
                       gm=((0, 0), (0, 0)),
                       h4: int = None,
                       vert_a: bool = False) -> MvStackResult:
    """Compound ref-MV stack for the (rf0, rf1) pair (reference
    setup_ref_mv_list compound path, EbAdaptiveMotionVectorPrediction.c:905
    + the under-2 fill :1110-1240). Stack entries are ((mv0, mv1), w);
    ref_list holds the two predictor *pairs*. The under-2 collect
    inverts candidates whose ref sits on the other temporal side
    (RefFrameSignBias, live once order hints are on)."""
    mi_rows, mi_cols = state.mi_rows, state.mi_cols
    w4 = s4
    h4 = s4 if h4 is None else h4
    stack = []          # [ (mv0, mv1), weight ]
    newmv_count = 0
    row_match = False
    col_match = False

    up_avail = mi_row > 0
    left_avail = mi_col > 0
    max_row_offset = max(-(MVREF_ROWS << 1), -mi_row) if up_avail else 0
    max_col_offset = max(-(MVREF_ROWS << 1), -mi_col) if left_avail else 0

    def add_candidate(r, c, len_, weight):
        nonlocal newmv_count
        if state.ref[r, c] != rf0 or state.ref1[r, c] != rf1:
            return False
        pair = ((int(state.mv[r, c, 0]), int(state.mv[r, c, 1])),
                (int(state.mv1[r, c, 0]), int(state.mv1[r, c, 1])))
        for e in stack:
            if e[0] == pair:
                e[1] += weight * len_
                break
        else:
            if len(stack) < MAX_REF_MV_STACK_SIZE:
                stack.append([pair, weight * len_])
        if _has_newmv(int(state.mode[r, c])):
            newmv_count += 1
        return True

    processed_rows = 0
    processed_cols = 0

    def scan_row(row_offset):
        nonlocal processed_rows, row_match
        end_mi = min(w4, mi_cols - mi_col, 16)
        col_off = 1 if abs(row_offset) > 1 else 0
        use_step_16 = w4 >= 16
        i = 0
        while i < end_mi:
            r = mi_row + row_offset
            c = mi_col + col_off + i
            if c >= mi_cols:
                break
            cand_w = int(state.n8w[r, c])
            cand_h = int(state.n8h[r, c])
            length = min(w4, cand_w)
            if use_step_16:
                length = max(4, length)
            elif abs(row_offset) > 1:
                length = max(length, 2)
            weight = 2
            if 2 <= w4 <= cand_w:
                inc = min(-max_row_offset + row_offset + 1, cand_h)
                weight = max(weight, inc)
                processed_rows = inc - row_offset - 1
            if add_candidate(r, c, length, weight):
                row_match = True
            i += length

    def scan_col(col_offset):
        nonlocal processed_cols, col_match
        end_mi = min(h4, mi_rows - mi_row, 16)
        row_off = 1 if abs(col_offset) > 1 else 0
        use_step_16 = h4 >= 16
        i = 0
        while i < end_mi:
            r = mi_row + row_off + i
            c = mi_col + col_offset
            if r >= mi_rows:
                break
            cand_w = int(state.n8w[r, c])
            cand_h = int(state.n8h[r, c])
            length = min(h4, cand_h)
            if use_step_16:
                length = max(4, length)
            elif abs(col_offset) > 1:
                length = max(length, 2)
            weight = 2
            if 2 <= h4 <= cand_h:
                inc = min(-max_col_offset + col_offset + 1, cand_w)
                weight = max(weight, inc)
                processed_cols = inc - col_offset - 1
            if add_candidate(r, c, length, weight):
                col_match = True
            i += length

    def scan_blk(row_offset, col_offset):
        nonlocal row_match
        r = mi_row + row_offset
        c = mi_col + col_offset
        if 0 <= r < mi_rows and 0 <= c < mi_cols:
            if add_candidate(r, c, 2, 2):
                row_match = True

    if abs(max_row_offset) >= 1:
        scan_row(-1)
    if abs(max_col_offset) >= 1:
        scan_col(-1)
    if _mvp_has_top_right_rect(mi_row, mi_col, w4, h4, vert_a=vert_a):
        scan_blk(-1, w4)

    nearest_match = int(row_match) + int(col_match)
    nearest_count = len(stack)
    nearest_newmv = newmv_count
    for e in stack[:nearest_count]:
        e[1] += REF_CAT_LEVEL

    # temporal scan: both MVs of the pair projected from the same
    # co-located entry (spec add_tpl_ref_mv compound arm)
    tpl_zeromv_bit = [False]
    if state.tpl is not None:
        v0, p0 = state.tpl_proj(rf0)
        v1, p1 = state.tpl_proj(rf1)

        def scan_tpl(br, bc, center):
            gr, gc = (mi_row + br) >> 1, (mi_col + bc) >> 1
            if not v0[gr, gc]:
                return False
            mv0 = (int(p0[gr, gc, 0]), int(p0[gr, gc, 1]))
            mv1 = (int(p1[gr, gc, 0]), int(p1[gr, gc, 1]))
            if center and (abs(mv0[0] - gm[0][0]) >= 16
                           or abs(mv0[1] - gm[0][1]) >= 16
                           or abs(mv1[0] - gm[1][0]) >= 16
                           or abs(mv1[1] - gm[1][1]) >= 16):
                tpl_zeromv_bit[0] = True
            pair = (mv0, mv1)
            for s in stack:
                if s[0] == pair:
                    s[1] += 2
                    return True
            if len(stack) < MAX_REF_MV_STACK_SIZE:
                stack.append([pair, 2])
            return True

        _scan_tpl_grid(scan_tpl, mi_row, mi_col, w4, h4, tpl_zeromv_bit)

    saved_newmv = newmv_count
    scan_blk(-1, -1)
    for idx in range(2, MVREF_ROWS + 1):
        row_offset = -(idx << 1) + 1
        col_offset = -(idx << 1) + 1
        if abs(row_offset) <= abs(max_row_offset) \
                and abs(row_offset) > processed_rows:
            scan_row(row_offset)
        if abs(col_offset) <= abs(max_col_offset) \
                and abs(col_offset) > processed_cols:
            scan_col(col_offset)
    newmv_count = saved_newmv

    ref_match = int(row_match) + int(col_match)
    mode_context = 0
    if nearest_match == 0:
        if ref_match >= 1:
            mode_context |= 1
        if ref_match == 1:
            mode_context |= 1 << 4
        elif ref_match >= 2:
            mode_context |= 2 << 4
    elif nearest_match == 1:
        mode_context |= 2 if nearest_newmv > 0 else 3
        if ref_match == 1:
            mode_context |= 3 << 4
        elif ref_match >= 2:
            mode_context |= 4 << 4
    else:
        mode_context |= 4 if nearest_newmv >= 1 else 5
        mode_context |= 5 << 4
    if tpl_zeromv_bit[0]:
        mode_context |= 1 << 3       # GLOBALMV_OFFSET (zeromv ctx)

    def _bubble(lo, hi):
        ln = hi
        while ln > lo:
            nr = lo
            for idx in range(lo + 1, ln):
                if stack[idx - 1][1] < stack[idx][1]:
                    stack[idx - 1], stack[idx] = stack[idx], stack[idx - 1]
                    nr = idx
            ln = nr

    _bubble(0, nearest_count)
    _bubble(nearest_count, len(stack))

    # under-2 fill (reference :1119-1230)
    if len(stack) < 2:
        ref_id = [[], []]
        ref_diff = [[], []]
        mi_size = min(min(16, w4, mi_cols - mi_col),
                      min(16, h4, mi_rows - mi_row))

        def collect(row: bool):
            i = 0
            while i < mi_size:
                rr, cc = (mi_row - 1, mi_col + i) if row \
                    else (mi_row + i, mi_col - 1)
                for cref, cmv in ((state.ref[rr, cc], state.mv[rr, cc]),
                                  (state.ref1[rr, cc],
                                   state.mv1[rr, cc])):
                    for cmp_idx, rf in ((0, rf0), (1, rf1)):
                        if cref == rf and len(ref_id[cmp_idx]) < 2:
                            ref_id[cmp_idx].append((int(cmv[0]),
                                                    int(cmv[1])))
                        elif cref > INTRA_FRAME \
                                and len(ref_diff[cmp_idx]) < 2:
                            # invert when the candidate's ref lies on
                            # the other temporal side of the target
                            # (spec: RefFrameSignBias comparison)
                            mvt = (int(cmv[0]), int(cmv[1]))
                            if state.sign_bias[cref] \
                                    != state.sign_bias[rf]:
                                mvt = (-mvt[0], -mvt[1])
                            ref_diff[cmp_idx].append(mvt)
                i += int(state.n8w[rr, cc] if row else state.n8h[rr, cc])

        if abs(max_row_offset) >= 1:
            collect(True)
        if abs(max_col_offset) >= 1:
            collect(False)

        comp_list = [[gm[0], gm[1]] for _ in range(3)]
        for idx in range(2):
            ci = 0
            for mv in ref_id[idx]:
                if ci >= 3:
                    break
                comp_list[ci][idx] = mv
                ci += 1
            for mv in ref_diff[idx]:
                if ci >= 3:
                    break
                comp_list[ci][idx] = mv
                ci += 1
        if len(stack) == 1:
            if tuple(comp_list[0]) == stack[0][0]:
                stack.append([(comp_list[1][0], comp_list[1][1]), 2])
            else:
                stack.append([(comp_list[0][0], comp_list[0][1]), 2])
        elif len(stack) == 0:
            for idx in range(MAX_MV_REF_CANDIDATES):
                stack.append([(comp_list[idx][0], comp_list[idx][1]), 2])

    fr0, fc0 = state.mi_off
    for e in stack:
        e[0] = (_clamp_mv_ref(e[0][0], mi_row + fr0, mi_col + fc0, w4,
                              state.frame_mi_rows, state.frame_mi_cols,
                              h4),
                _clamp_mv_ref(e[0][1], mi_row + fr0, mi_col + fc0, w4,
                              state.frame_mi_rows, state.frame_mi_cols,
                              h4))

    ref_list = [gm, gm]
    for idx in range(min(MAX_MV_REF_CANDIDATES, len(stack))):
        ref_list[idx] = stack[idx][0]

    res = MvStackResult()
    res.stack = [(e[0], e[1]) for e in stack]
    res.count = len(stack)
    res.mode_context = mode_context
    res.ref_list = ref_list
    res.nearest_count = nearest_count
    return res
