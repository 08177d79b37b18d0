"""Inter-frame mode syntax readers: is_inter, reference frames, inter mode,
DRL index, compound and interpolation filter, with their context
derivations from neighbouring blocks (reference writers: WriteInterMode
``EbEntropyCoding.c:1724``, WriteDrlIdx ``:1756``, WriteRefFrames
``:2560ff``).
"""

from __future__ import annotations

import numpy as np

from benchmark.avref.pipeline.mvp import (GLOBAL_GLOBALMV, GLOBALMV,
                                          INTRA_FRAME, LAST_FRAME, NEAR_NEARMV,
                                          NEAR_NEWMV, NEAREST_NEARESTMV,
                                          NEAREST_NEWMV, NEARESTMV, NEARMV,
                                          NEW_NEARESTMV, NEW_NEARMV, NEW_NEWMV,
                                          NEWMV, MvStackResult)

# ref frame enum (AV1)
LAST2_FRAME = 2
LAST3_FRAME = 3
GOLDEN_FRAME = 4
BWDREF_FRAME = 5
ALTREF2_FRAME = 6
ALTREF_FRAME = 7


def neighbor_ref_counts(state, mi_row: int, mi_col: int):
    """Counts of each ref frame among the above/left neighbors
    (av1_collect_neighbors_ref_counts)."""
    counts = np.zeros(8, dtype=np.int32)
    for rr, cc, ok in ((mi_row - 1, mi_col, mi_row > 0),
                       (mi_row, mi_col - 1, mi_col > 0)):
        if not ok:
            continue
        r = int(state.ref[rr, cc])
        if r > INTRA_FRAME:
            counts[r] += 1
        r1 = int(state.ref1[rr, cc])
        if r1 > INTRA_FRAME:
            counts[r1] += 1
    return counts


def _two_way_ctx(c0: int, c1: int) -> int:
    return 1 if c0 == c1 else (0 if c0 < c1 else 2)


def intra_inter_ctx(state, mi_row: int, mi_col: int) -> int:
    """Context for the is_inter flag (spec intra_inter_context)."""
    au = mi_row > 0
    al = mi_col > 0
    above_intra = au and state.ref[mi_row - 1, mi_col] == INTRA_FRAME
    left_intra = al and state.ref[mi_row, mi_col - 1] == INTRA_FRAME
    if au and al:
        return 3 if (above_intra and left_intra) \
            else int(above_intra or left_intra)
    if au or al:
        return 2 * int(above_intra if au else left_intra)
    return 0


def read_is_inter(r, fc, state, mi_row, mi_col) -> int:
    return r.read_symbol(fc.intra_inter[intra_inter_ctx(state, mi_row,
                                                        mi_col)], 2)


def read_single_ref(r, fc, state, mi_row, mi_col) -> int:
    counts = neighbor_ref_counts(state, mi_row, mi_col)
    fwd = counts[LAST_FRAME] + counts[LAST2_FRAME] + counts[LAST3_FRAME] \
        + counts[GOLDEN_FRAME]
    bwd = counts[BWDREF_FRAME] + counts[ALTREF2_FRAME] + counts[ALTREF_FRAME]
    if r.read_symbol(fc.single_ref[_two_way_ctx(fwd, bwd)][0], 2):
        p2_ctx = _two_way_ctx(counts[BWDREF_FRAME] + counts[ALTREF2_FRAME],
                              counts[ALTREF_FRAME])
        if r.read_symbol(fc.single_ref[p2_ctx][1], 2):
            return ALTREF_FRAME
        p6_ctx = _two_way_ctx(counts[BWDREF_FRAME], counts[ALTREF2_FRAME])
        return ALTREF2_FRAME if r.read_symbol(fc.single_ref[p6_ctx][5], 2) \
            else BWDREF_FRAME
    ll2 = counts[LAST_FRAME] + counts[LAST2_FRAME]
    l3g = counts[LAST3_FRAME] + counts[GOLDEN_FRAME]
    if r.read_symbol(fc.single_ref[_two_way_ctx(ll2, l3g)][2], 2):
        p5 = _two_way_ctx(counts[LAST3_FRAME], counts[GOLDEN_FRAME])
        return GOLDEN_FRAME if r.read_symbol(fc.single_ref[p5][4], 2) \
            else LAST3_FRAME
    p4 = _two_way_ctx(counts[LAST_FRAME], counts[LAST2_FRAME])
    return LAST2_FRAME if r.read_symbol(fc.single_ref[p4][3], 2) \
        else LAST_FRAME


def _new_mv_mode(mode: int) -> bool:
    """Modes that read the NEWMV-style DRL range (spec 5.11.25)."""
    return mode in (NEWMV, NEW_NEWMV, NEAREST_NEWMV, NEW_NEARESTMV)


def _near_mv_mode(mode: int) -> bool:
    return mode in (NEARMV, NEAR_NEARMV, NEAR_NEWMV, NEW_NEARMV)


def read_inter_mode(r, fc, res: MvStackResult) -> int:
    if not r.read_symbol(fc.newmv[res.newmv_ctx], 2):
        return NEWMV
    if not r.read_symbol(fc.zeromv[res.zeromv_ctx], 2):
        return GLOBALMV
    if not r.read_symbol(fc.refmv[res.refmv_ctx], 2):
        return NEARESTMV
    return NEARMV


def read_drl_idx(r, fc, mode: int, res: MvStackResult) -> int:
    drl = 0
    if _new_mv_mode(mode):
        for idx in range(2):
            if res.count > idx + 1:
                if not r.read_symbol(fc.drl[res.drl_ctx(idx)], 2):
                    return idx
                drl = idx + 1
            else:
                return drl
        return drl
    if _near_mv_mode(mode):
        for idx in range(1, 3):
            if res.count > idx + 1:
                if not r.read_symbol(fc.drl[res.drl_ctx(idx)], 2):
                    return idx - 1
                drl = idx
            else:
                return drl
        return drl
    return 0


# --- compound prediction syntax ----------------------------------------------

def _pred_kind(state, r, c):
    """'intra', 0 (uni fwd), 1 (uni bwd), or 2 (bi) for a coded neighbor."""
    ref = int(state.ref[r, c])
    if ref == INTRA_FRAME:
        return "intra"
    if int(state.ref1[r, c]) > INTRA_FRAME:
        return 2
    return 1 if ref >= BWDREF_FRAME else 0


def comp_inter_ctx(state, mi_row: int, mi_col: int) -> int:
    """Av1GetReferenceModeContext (EbEntropyCoding.c:2087)."""
    au = mi_row > 0
    al = mi_col > 0
    a = _pred_kind(state, mi_row - 1, mi_col) if au else None
    l = _pred_kind(state, mi_row, mi_col - 1) if al else None
    if au and al:
        a_bi = a == 2
        l_bi = l == 2
        if not a_bi and not l_bi:
            return int(a == 1) ^ int(l == 1)
        if not a_bi:
            return 2 + int(a == 1 or a == "intra")
        if not l_bi:
            return 2 + int(l == 1 or l == "intra")
        return 4
    if al:
        return 3 if l == 2 else int(l == 1)
    if au:
        return 3 if a == 2 else int(a == 1)
    return 1


def comp_ref_type_ctx(state, mi_row: int, mi_col: int) -> int:
    """Av1GetCompReferenceTypeContext (EbEntropyCoding.c:2163); the
    uni-compound branches collapse (has_uni_comp_refs always 0 here)."""
    au = mi_row > 0
    al = mi_col > 0
    a = _pred_kind(state, mi_row - 1, mi_col) if au else None
    l = _pred_kind(state, mi_row, mi_col - 1) if al else None
    if au and al:
        if a == "intra" and l == "intra":
            return 2
        if l == "intra":
            return 2 if a != 2 else 1
        if a == "intra":
            return 2 if l != 2 else 1
        a_sg = a != 2
        l_sg = l != 2
        if a_sg and l_sg:
            return 1 + 2 * int(not (int(a == 1) ^ int(l == 1)))
        if a_sg or l_sg:
            return 1      # single/comp, bidir neighbor
        return 0          # comp/comp (bidir/bidir)
    edge = l if al else (a if au else None)
    if edge is None:
        return 2
    if edge == "intra" or edge != 2:
        return 2
    return 0


def read_comp_inter(r, fc, state, mi_row, mi_col) -> int:
    return r.read_symbol(
        fc.comp_inter[comp_inter_ctx(state, mi_row, mi_col)], 2)


def read_comp_refs(r, fc, state, mi_row, mi_col):
    t = r.read_symbol(fc.comp_ref_type[comp_ref_type_ctx(state, mi_row,
                                                         mi_col)], 2)
    assert t == 1, "unidirectional compound unsupported"
    counts = neighbor_ref_counts(state, mi_row, mi_col)
    ll2 = counts[LAST_FRAME] + counts[LAST2_FRAME]
    l3g = counts[LAST3_FRAME] + counts[GOLDEN_FRAME]
    if r.read_symbol(fc.comp_ref[_two_way_ctx(ll2, l3g)][0], 2):
        ctx = _two_way_ctx(counts[LAST3_FRAME], counts[GOLDEN_FRAME])
        fwd = GOLDEN_FRAME if r.read_symbol(fc.comp_ref[ctx][2], 2) \
            else LAST3_FRAME
    else:
        ctx = _two_way_ctx(counts[LAST_FRAME], counts[LAST2_FRAME])
        fwd = LAST2_FRAME if r.read_symbol(fc.comp_ref[ctx][1], 2) \
            else LAST_FRAME
    brf2 = counts[BWDREF_FRAME] + counts[ALTREF2_FRAME]
    arf = counts[ALTREF_FRAME]
    if r.read_symbol(fc.comp_bwdref[_two_way_ctx(brf2, arf)][0], 2):
        bwd = ALTREF_FRAME
    else:
        ctx = _two_way_ctx(counts[BWDREF_FRAME], counts[ALTREF2_FRAME])
        bwd = ALTREF2_FRAME if r.read_symbol(fc.comp_bwdref[ctx][1], 2) \
            else BWDREF_FRAME
    return fwd, bwd


# compound_mode_ctx_map (EbEntropyCoding.c:1488)
_COMPOUND_MODE_CTX_MAP = (
    (0, 1, 1, 1, 1),
    (1, 2, 3, 4, 4),
    (4, 4, 5, 6, 7),
)


def compound_mode_ctx(res: MvStackResult) -> int:
    """Av1ModeContextAnalyzer compound branch (EbEntropyCoding.c:1494)."""
    return _COMPOUND_MODE_CTX_MAP[res.refmv_ctx >> 1][min(res.newmv_ctx, 4)]


def read_inter_compound_mode(r, fc, res: MvStackResult) -> int:
    return NEAREST_NEARESTMV + r.read_symbol(
        fc.inter_compound_mode[compound_mode_ctx(res)], 8)


# --- switchable interpolation filter (spec 5.11.26 read_interp_filter) --------

def needs_interp_filter(mode, bw: int, bh: int, gm0_is_trans: bool,
                        gm1_is_trans: bool = False) -> bool:
    """Spec needs_interp_filter(): large GLOBALMV blocks whose global
    model is IDENTITY skip the filter symbol (their MV is (0,0) —
    phase-0 MC is filter-independent). skip_mode / warped motion are
    not coded by this encoder."""
    large = min(bw, bh) >= 8
    if large and mode == GLOBALMV:
        return gm0_is_trans
    if large and mode == GLOBAL_GLOBALMV:
        return gm0_is_trans or gm1_is_trans
    return True


def interp_filter_ctx(state, mi_row: int, mi_col: int, ref_frame: int,
                      is_comp: bool) -> int:
    """Context for the interp_filter symbol (dir 0, dual_filter off;
    reference av1_get_pred_context_switchable_interp,
    EbEntropyCoding.c:1904): 4*is_comp plus the left/above neighbor
    filter types, counted only when the neighbor shares ref_frame."""
    SW = 3  # SWITCHABLE_FILTERS
    ctx = 4 if is_comp else 0
    left_type = above_type = SW
    if mi_col > 0:
        if state.ref[mi_row, mi_col - 1] == ref_frame \
                or state.ref1[mi_row, mi_col - 1] == ref_frame:
            left_type = int(state.interp[mi_row, mi_col - 1])
    if mi_row > 0:
        if state.ref[mi_row - 1, mi_col] == ref_frame \
                or state.ref1[mi_row - 1, mi_col] == ref_frame:
            above_type = int(state.interp[mi_row - 1, mi_col])
    if left_type == above_type:
        ctx += left_type
    elif left_type == SW:
        ctx += above_type
    elif above_type == SW:
        ctx += left_type
    else:
        ctx += SW
    return ctx


def read_interp_filter(r, fc, state, mi_row, mi_col, ref_frame: int,
                       is_comp: bool) -> int:
    ctx = interp_filter_ctx(state, mi_row, mi_col, ref_frame, is_comp)
    return r.read_symbol(fc.switchable_interp[ctx], 3)
