"""Deblocking loop filter (normative), vectorized (host NumPy oracle).

Reference behavior: ``EbDeblockingFilter.c`` — filter4 (:133), filter6
(:215), filter8 (:238), filter14 (:318), threshold derivation
update_sharpness (:719), and the edge/filter-length rules (:1040-1110).
With this encoder's shape (tx == block, square >= 8x8) every block edge is
both a TU and PU edge, so edges are filtered whenever the level is nonzero;
filter length comes from the min tx dim across the edge (4 -> 4; 8 -> 8
luma / 6 chroma; >= 16 -> 14 luma / 6 chroma).

All pixel rows of all edges of one (plane, direction, length) group are
filtered as one batched tensor op — the TPU-shaped replacement for the
reference's per-SB loops.
"""

from __future__ import annotations

import numpy as np


def thresholds(level: int, sharpness: int = 0):
    """(blimit, limit, thresh) per update_sharpness (:719)."""
    limit = level >> int((sharpness > 0) + (sharpness > 4))
    if sharpness > 0:
        limit = min(limit, 9 - sharpness)
    limit = max(limit, 1)
    return 2 * (level + 2) + limit, limit, level >> 4


def _filter4(p1, p0, q0, q1, mask, thresh, bd=8):
    """filter4 / highbd_filter4 (:133/:483). int32 [N] args; returns
    new (p1, p0, q0, q1). For bd > 8 the +-128 pivot and clamps scale by
    1 << (bd - 8)."""
    shift = bd - 8
    lo, hi, piv = -128 << shift, (128 << shift) - 1, 128 << shift

    def _sc(x):
        return np.clip(x, lo, hi)

    ps1, ps0 = p1 - piv, p0 - piv
    qs0, qs1 = q0 - piv, q1 - piv
    hev = (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)
    f = _sc(ps1 - qs1) * hev
    f = _sc(f + 3 * (qs0 - ps0)) * mask
    f1 = _sc(f + 4) >> 3
    f2 = _sc(f + 3) >> 3
    oq0 = _sc(qs0 - f1) + piv
    op0 = _sc(ps0 + f2) + piv
    f3 = ((f1 + 1) >> 1) * ~hev
    oq1 = _sc(qs1 - f3) + piv
    op1 = _sc(ps1 + f3) + piv
    return op1, op0, oq0, oq1


def _r3(x):
    return (x + 4) >> 3


def _r4(x):
    return (x + 8) >> 4


def _apply_len(s, mask_sel, length, blimit, limit, thresh, bd=8):
    """s: [N, 14] sample lines (p6..p0, q0..q6) int32. Filters in place
    for rows where mask_sel; returns s."""
    p = {i: s[:, 6 - i] for i in range(7)}
    q = {i: s[:, 7 + i] for i in range(7)}
    am = lambda a, b: np.abs(a - b)  # noqa: E731

    if length == 4:
        fmask = ~((am(p[1], p[0]) > limit) | (am(q[1], q[0]) > limit)
                  | (am(p[0], q[0]) * 2 + am(p[1], q[1]) // 2 > blimit))
        fmask &= mask_sel
        np1, np0, nq0, nq1 = _filter4(p[1], p[0], q[0], q[1], fmask, thresh,
                                      bd)
        for idx, v in ((5, np1), (6, np0), (7, nq0), (8, nq1)):
            s[:, idx] = np.where(fmask, v, s[:, idx])
        return s

    if length == 6:
        fmask = ~((am(p[2], p[1]) > limit) | (am(p[1], p[0]) > limit)
                  | (am(q[1], q[0]) > limit) | (am(q[2], q[1]) > limit)
                  | (am(p[0], q[0]) * 2 + am(p[1], q[1]) // 2 > blimit))
        fmask &= mask_sel
        ft = 1 << (bd - 8)
        flat = ~((am(p[1], p[0]) > ft) | (am(q[1], q[0]) > ft)
                 | (am(p[2], p[0]) > ft) | (am(q[2], q[0]) > ft))
        wide = fmask & flat
        o = {}
        o[5] = _r3(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0])
        o[6] = _r3(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1])
        o[7] = _r3(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2])
        o[8] = _r3(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3)
        np1, np0, nq0, nq1 = _filter4(p[1], p[0], q[0], q[1],
                                      fmask & ~flat, thresh, bd)
        nar = {5: np1, 6: np0, 7: nq0, 8: nq1}
        for idx in (5, 6, 7, 8):
            s[:, idx] = np.where(wide, o[idx],
                                 np.where(fmask & ~flat, nar[idx],
                                          s[:, idx]))
        return s

    # length 8 / 14 share the 8-wide masks
    fmask = ~((am(p[3], p[2]) > limit) | (am(p[2], p[1]) > limit)
              | (am(p[1], p[0]) > limit) | (am(q[1], q[0]) > limit)
              | (am(q[2], q[1]) > limit) | (am(q[3], q[2]) > limit)
              | (am(p[0], q[0]) * 2 + am(p[1], q[1]) // 2 > blimit))
    fmask &= mask_sel
    ft = 1 << (bd - 8)
    flat = ~((am(p[1], p[0]) > ft) | (am(q[1], q[0]) > ft)
             | (am(p[2], p[0]) > ft) | (am(q[2], q[0]) > ft)
             | (am(p[3], p[0]) > ft) | (am(q[3], q[0]) > ft))
    o8 = {}
    o8[4] = _r3(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0])
    o8[5] = _r3(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1])
    o8[6] = _r3(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2])
    o8[7] = _r3(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3])
    o8[8] = _r3(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2)
    o8[9] = _r3(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3)
    np1, np0, nq0, nq1 = _filter4(p[1], p[0], q[0], q[1],
                                  fmask & ~flat, thresh, bd)
    nar = {5: np1, 6: np0, 7: nq0, 8: nq1}

    if length == 8:
        for idx in (4, 5, 6, 7, 8, 9):
            s[:, idx] = np.where(fmask & flat, o8[idx], s[:, idx])
        for idx in (5, 6, 7, 8):
            s[:, idx] = np.where(fmask & ~flat, nar[idx], s[:, idx])
        return s

    # length 14
    flat2 = ~((am(p[4], p[0]) > ft) | (am(q[4], q[0]) > ft)
              | (am(p[5], p[0]) > ft) | (am(q[5], q[0]) > ft)
              | (am(p[6], p[0]) > ft) | (am(q[6], q[0]) > ft))
    o14 = {}
    o14[1] = _r4(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1]
                 + p[0] + q[0])
    o14[2] = _r4(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1]
                 + p[0] + q[0] + q[1])
    o14[3] = _r4(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1]
                 + p[0] + q[0] + q[1] + q[2])
    o14[4] = _r4(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2
                 + p[0] + q[0] + q[1] + q[2] + q[3])
    o14[5] = _r4(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2
                 + p[0] * 2 + q[0] + q[1] + q[2] + q[3] + q[4])
    o14[6] = _r4(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2
                 + q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5])
    o14[7] = _r4(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2
                 + q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6])
    o14[8] = _r4(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2
                 + q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2)
    o14[9] = _r4(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2
                 + q[3] * 2 + q[4] + q[5] + q[6] * 3)
    o14[10] = _r4(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2
                  + q[4] * 2 + q[5] + q[6] * 4)
    o14[11] = _r4(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2
                  + q[5] * 2 + q[6] * 5)
    o14[12] = _r4(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2
                  + q[6] * 7)
    wide14 = fmask & flat & flat2
    wide8 = fmask & flat & ~flat2
    for idx in range(1, 13):
        s[:, idx] = np.where(wide14, o14[idx], s[:, idx])
    for idx in (4, 5, 6, 7, 8, 9):
        s[:, idx] = np.where(wide8, o8[idx], s[:, idx])
    for idx in (5, 6, 7, 8):
        s[:, idx] = np.where(fmask & ~flat, nar[idx], s[:, idx])
    return s


def _edge_filter(plane, xs_edge, rows, lengths, level, sharpness,
                 vertical: bool, bd: int = 8):
    """Filter a set of edges: xs_edge [E] pixel coordinate of each edge
    line, rows [E] the pixel row (or col) of the line, lengths [E]."""
    blimit, limit, thresh = thresholds(level, sharpness)
    shift = bd - 8
    blimit <<= shift
    limit <<= shift
    thresh <<= shift
    wmax = plane.shape[1] - 1 if vertical else plane.shape[0] - 1
    write_range = {4: (5, 9), 6: (5, 9), 8: (4, 10), 14: (1, 13)}
    for L in (4, 6, 8, 14):
        sel = lengths == L
        if not sel.any():
            continue
        xe = xs_edge[sel]
        re = rows[sel]
        n = len(xe)
        s = np.empty((n, 14), dtype=np.int32)
        for k in range(14):
            # clip the gather — out-of-range taps are never used by this
            # length's masks/outputs, but must not fault or wrap
            off = np.clip(xe + (k - 7), 0, wmax)
            if vertical:
                s[:, k] = plane[re, off]
            else:
                s[:, k] = plane[off, re]
        s = _apply_len(s, np.ones(n, dtype=bool), L, blimit, limit,
                       thresh, bd)
        lo, hi = write_range[L]
        for k in range(lo, hi):
            off = k - 7
            if vertical:
                plane[re, xe + off] = s[:, k]
            else:
                plane[xe + off, re] = s[:, k]


def loop_filter_plane(plane: np.ndarray, tx_map, 
                      start_x: np.ndarray, start_y: np.ndarray,
                      level: int, w_eff: int, h_eff: int,
                      sharpness: int = 0, is_luma: bool = True,
                      bd: int = 8) -> None:
    """Filter one plane in place (both directions, vertical first — spec
    filters all vertical edges of the frame, then horizontal).

    tx_map: (txw_map, txh_map) [units_h, units_w] tx dims in px per 4px
    unit (vertical edges filter by tx WIDTH, horizontal by HEIGHT);
    start_x/start_y mark units that begin a transform block. w_eff/h_eff:
    coded plane dims (filtering stays inside).
    """
    if level == 0:
        return
    txw_map, txh_map = tx_map
    uh, uw = txw_map.shape
    uh = min(uh, h_eff // 4)
    uw = min(uw, w_eff // 4)

    def length_of(cur, prev):
        mn = np.minimum(cur, prev)
        if is_luma:
            return np.where(mn <= 4, 4, np.where(mn == 8, 8, 14))
        return np.where(mn <= 4, 4, 6)

    work = plane.astype(np.int32)
    # vertical edges
    exs, eys, elens = [], [], []
    for c in range(1, uw):
        runits = np.nonzero(start_x[:uh, c])[0]
        if len(runits) == 0:
            continue
        lens = length_of(txw_map[runits, c], txw_map[runits, c - 1])
        for k in range(4):  # each unit spans 4 pixel rows
            exs.append(np.full(len(runits), c * 4))
            eys.append(runits * 4 + k)
            elens.append(lens)
    if exs:
        _edge_filter(work, np.concatenate(exs), np.concatenate(eys),
                     np.concatenate(elens), level, sharpness, vertical=True,
                     bd=bd)
    # horizontal edges
    exs, eys, elens = [], [], []
    for r in range(1, uh):
        cunits = np.nonzero(start_y[r, :uw])[0]
        if len(cunits) == 0:
            continue
        lens = length_of(txh_map[r, cunits], txh_map[r - 1, cunits])
        for k in range(4):
            exs.append(np.full(len(cunits), r * 4))
            eys.append(cunits * 4 + k)
            elens.append(lens)
    if exs:
        _edge_filter(work, np.concatenate(exs), np.concatenate(eys),
                     np.concatenate(elens), level, sharpness,
                     vertical=False, bd=bd)
    np.clip(work, 0, (1 << bd) - 1, out=work)
    plane[:] = work.astype(plane.dtype)


def build_tx_maps(leaf_sizes: dict, mi_rows: int, mi_cols: int,
                  plane: int):
    """Per-plane tx maps from the leaf map: (tx_map, start_x, start_y) in
    plane 4px units."""
    from benchmark.avref.pipeline.common import leaf_wh
    ss = 0 if plane == 0 else 1
    uh = (mi_rows + ss) >> ss
    uw = (mi_cols + ss) >> ss
    txw_map = np.full((uh, uw), 64, dtype=np.int32)
    txh_map = np.full((uh, uw), 64, dtype=np.int32)
    start_x = np.zeros((uh, uw), dtype=bool)
    start_y = np.zeros((uh, uw), dtype=bool)
    for (r, c), v in leaf_sizes.items():
        bw, bh = leaf_wh(v)
        tw = bw if plane == 0 else min(32, bw >> 1)
        th = bh if plane == 0 else min(32, bh >> 1)
        r0, c0 = r >> ss, c >> ss
        mw = max(1, (bw >> 2) >> ss)
        mh = max(1, (bh >> 2) >> ss)
        step_x = max(1, tw // 4)
        step_y = max(1, th // 4)
        txw_map[r0:r0 + mh, c0:c0 + mw] = tw
        txh_map[r0:r0 + mh, c0:c0 + mw] = th
        start_x[r0:r0 + mh, c0:c0 + mw:step_x] = True
        start_y[r0:r0 + mh:step_y, c0:c0 + mw] = True
    return (txw_map, txh_map), start_x, start_y


def loop_filter_frame(recon_planes, leaf_sizes: dict, mi_rows: int,
                      mi_cols: int, levels, sharpness: int = 0,
                      bd: int = 8) -> None:
    """Apply DLF in place to [Y, U, V] padded recon planes.
    levels: (y_vert, y_horz, u, v) — y uses levels[0] (this encoder keeps
    vert == horz)."""
    if levels[0] == 0 and levels[1] == 0:
        return  # spec: loop filter disabled when both luma levels are 0
    for plane in range(3):
        level = levels[0] if plane == 0 else levels[1 + plane]
        if level == 0:
            continue
        tx_map, sx, sy = build_tx_maps(leaf_sizes, mi_rows, mi_cols, plane)
        ss = 0 if plane == 0 else 1
        loop_filter_plane(recon_planes[plane], tx_map, sx, sy, level,
                          (mi_cols * 4) >> ss, (mi_rows * 4) >> ss,
                          sharpness, is_luma=plane == 0, bd=bd)
