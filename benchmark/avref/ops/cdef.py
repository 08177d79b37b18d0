"""CDEF, the decoder's filter (spec 7.15): the direction search and the
primary and secondary taps of every non-skip 8x8 block of a frame.

A copy of the port's host filter (``ops/cdef.py``, ``cdef_frame``) with
the per-block Python loops taken out: the blocks of a frame are chosen,
cut out, given their strengths and written back as whole arrays; the
direction search is two float64 matrix products (exact: every partial
sum is an integer below 2**53), and the blocks of one direction are
filtered together with their taps as slices. The same integers in give
the same samples out.

Reference: cdef_directions (``EbCdef.c:113``), cdef_pri_taps /
cdef_sec_taps (``EbCdef.c:200``), cdef_find_dir_c's div_table
(``EbCdef.c:132``).
"""

from __future__ import annotations

import numpy as np

CDEF_VERY_LARGE = 0x4000

PRI_TAPS = ((4, 2), (3, 3))
SEC_TAPS = ((2, 1), (2, 1))

# (dy, dx) per direction, two taps (decomposed from cdef_directions :113)
DIR_OFFSETS = (
    ((-1, 1), (-2, 2)), ((0, 1), (-1, 2)), ((0, 1), (0, 2)),
    ((0, 1), (1, 2)), ((1, 1), (2, 2)), ((1, 0), (2, 1)),
    ((1, 0), (2, 0)), ((1, 0), (2, -1)),
)

_DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105])


def _dir_tables():
    """The direction search as two matrices: [64, 8 * 15] 0/1 line sums
    of each direction, and [8, 15] the weight of each line's square in
    the direction's cost (cdef_find_dir_c)."""
    i = np.arange(8)[:, None] * np.ones(8, dtype=int)[None, :]
    j = np.ones(8, dtype=int)[:, None] * np.arange(8)[None, :]
    idx = [i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j,
           3 - i // 2 + j, j, i // 2 + j]
    proj = np.zeros((8, 15, 64))
    for d in range(8):
        proj[d, idx[d].reshape(-1), np.arange(64)] = 1
    wt = np.zeros((8, 15))
    for d in (2, 6):
        wt[d, :8] = _DIV_TABLE[8]
    for d in (0, 4):
        wt[d, :7] = _DIV_TABLE[1:8]
        wt[d, 14:7:-1] = _DIV_TABLE[1:8]
        wt[d, 7] = _DIV_TABLE[8]
    for d in (1, 3, 5, 7):
        wt[d, 3:8] = _DIV_TABLE[8]
        wt[d, :3] = _DIV_TABLE[2:8:2]
        wt[d, 10:7:-1] = _DIV_TABLE[2:8:2]
    return proj.reshape(8 * 15, 64).T, wt


_DIR_PROJ, _DIR_WEIGHT = _dir_tables()


def _msb(v: np.ndarray) -> np.ndarray:
    """floor(log2(v)) of positive integers below 2**53, exactly."""
    return np.frexp(np.asarray(v, dtype=np.float64))[1].astype(np.int64) - 1


def adjust_strength(strength: np.ndarray, var: np.ndarray) -> np.ndarray:
    """The primary strength scaled by the block's variance (per block)."""
    v6 = var >> 6
    i = np.where(v6 > 0, np.minimum(_msb(np.maximum(v6, 1)), 12), 0)
    return np.where(var != 0, (strength * (4 + i) + 8) >> 4, 0)


def _padded_copy(plane: np.ndarray, w_eff: int, h_eff: int) -> np.ndarray:
    """int32 copy with a 3px CDEF_VERY_LARGE border; samples beyond the
    coded (mi) area are also VERY_LARGE."""
    pad = 3
    out = np.full((h_eff + 2 * pad, w_eff + 2 * pad), CDEF_VERY_LARGE,
                  dtype=np.int32)
    out[pad:pad + h_eff, pad:pad + w_eff] = plane[:h_eff, :w_eff]
    return out


def find_dir_batch(blocks: np.ndarray, coeff_shift: int):
    """[B, 8, 8] -> (direction [B], variance [B]) of cdef_find_dir. The
    line sums and costs are float64 products of integers, exact: a cost
    is below 15 * 1024**2 * 840 < 2**53."""
    B = blocks.shape[0]
    x = (blocks.astype(np.int64) >> coeff_shift) - 128
    part = (x.reshape(B, 64).astype(np.float64) @ _DIR_PROJ) \
        .reshape(B, 8, 15)
    cost = np.einsum("bdt,dt->bd", part * part, _DIR_WEIGHT) \
        .astype(np.int64)
    best = np.argmax(cost, axis=1)
    bc = np.take_along_axis(cost, best[:, None], axis=1)[:, 0]
    oc = np.take_along_axis(cost, ((best + 4) & 7)[:, None], axis=1)[:, 0]
    return best.astype(np.int32), ((bc - oc) >> 10).astype(np.int64)


def _constrain(diff: np.ndarray, thr: np.ndarray,
               shift: np.ndarray) -> np.ndarray:
    """constrain(): 0 where ``thr`` is 0, since then ``thr - |diff| >>
    shift`` is never above 0."""
    a = np.abs(diff)
    v = np.minimum(a, np.maximum(0, thr - (a >> shift)))
    return np.where(diff < 0, -v, v)


def _shift(thr: np.ndarray, damping: int) -> np.ndarray:
    return np.maximum(0, damping - np.where(thr > 0,
                                            _msb(np.maximum(thr, 1)), 0))


def filter_blocks_batch(src: np.ndarray, ys, xs, h: int, w: int, pri,
                        sec, dirs, pri_damping: int, sec_damping: int,
                        coeff_shift: int) -> np.ndarray:
    """Filter every block: per-block strengths and directions (src is the
    padded pre-CDEF copy, so blocks are independent). The blocks of one
    direction take their taps as slices of their windows."""
    B = len(ys)
    ys = np.asarray(ys)
    xs = np.asarray(xs)
    pri = np.asarray(pri, dtype=np.int64)
    sec = np.asarray(sec, dtype=np.int64)
    dirs = np.asarray(dirs, dtype=np.int64)
    iy = ys[:, None, None] + np.arange(h + 6)[None, :, None]
    ix = xs[:, None, None] + np.arange(w + 6)[None, None, :]
    win = src[iy, ix]                                   # [B, h+6, w+6]
    tap_idx = (pri >> coeff_shift) & 1
    pri_t = np.array(PRI_TAPS, dtype=np.int32)[tap_idx][:, :, None, None]
    sec_t = np.array(SEC_TAPS, dtype=np.int32)[tap_idx][:, :, None, None]
    p_thr = pri.astype(np.int32)[:, None, None]
    s_thr = sec.astype(np.int32)[:, None, None]
    p_sh = _shift(pri, pri_damping).astype(np.int32)[:, None, None]
    s_sh = _shift(sec, sec_damping).astype(np.int32)[:, None, None]
    out = np.empty((B, h, w), dtype=np.int32)
    for d in range(8):
        sel = np.nonzero(dirs == d)[0]
        if not len(sel):
            continue
        wd = win[sel]
        x = wd[:, 3:3 + h, 3:3 + w]
        s_acc = np.zeros(x.shape, dtype=np.int32)
        mx = x.copy()
        mn = x.copy()

        def tap(dy, dx):
            return wd[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]

        pt, st = pri_t[sel], sec_t[sel]
        pth, psh, sth, ssh = p_thr[sel], p_sh[sel], s_thr[sel], s_sh[sel]
        for k in range(2):
            for sgn in (1, -1):
                dy, dx = DIR_OFFSETS[d][k]
                p = tap(sgn * dy, sgn * dx)
                s_acc += pt[:, k] * _constrain(p - x, pth, psh)
                mx = np.maximum(mx, np.where(p == CDEF_VERY_LARGE, mx, p))
                mn = np.minimum(mn, p)
                for od in (2, 6):
                    dy, dx = DIR_OFFSETS[(d + od) & 7][k]
                    q = tap(sgn * dy, sgn * dx)
                    s_acc += st[:, k] * _constrain(q - x, sth, ssh)
                    mx = np.maximum(mx, np.where(q == CDEF_VERY_LARGE, mx,
                                                 q))
                    mn = np.minimum(mn, q)
        out[sel] = np.clip(x + ((8 + s_acc - (s_acc < 0)) >> 4), mn, mx)
    return out


def _put_blocks(plane: np.ndarray, ys, xs, blocks: np.ndarray,
                peak: int) -> None:
    """Write [B, n, n] blocks at block rows ``ys`` and columns ``xs``."""
    n = blocks.shape[1]
    r = ys[:, None, None] * n + np.arange(n)[None, :, None]
    c = xs[:, None, None] * n + np.arange(n)[None, None, :]
    plane[r, c] = np.clip(blocks, 0, peak)


def cdef_frame(recon_planes, skip8: np.ndarray, cdef_idx: np.ndarray,
               y_strengths, uv_strengths, damping: int, mi_rows: int,
               mi_cols: int, bd: int = 8) -> None:
    """Apply CDEF in place. skip8: [h8, w8] bool (all-skip 8x8 luma units);
    cdef_idx: [sb_rows, sb_cols] int (-1 = uncoded/skipped SB)."""
    cs = bd - 8
    w_eff, h_eff = mi_cols * 4, mi_rows * 4     # multiples of 8
    srcs = [_padded_copy(recon_planes[0], w_eff, h_eff),
            _padded_copy(recon_planes[1], w_eff // 2, h_eff // 2),
            _padded_copy(recon_planes[2], w_eff // 2, h_eff // 2)]
    h8, w8 = h_eff // 8, w_eff // 8
    # every non-skip 8x8 of every coded SB whose strengths are not all 0
    y_s = np.asarray(y_strengths, dtype=np.int64)
    uv_s = np.asarray(uv_strengths, dtype=np.int64)
    lvl_t, sec_t = y_s // 4, y_s % 4
    sec_t += sec_t == 3
    ulvl_t, usec_t = uv_s // 4, uv_s % 4
    usec_t += usec_t == 3
    on_t = (lvl_t | sec_t | ulvl_t | usec_t) != 0
    idx = cdef_idx[np.arange(h8)[:, None] // 8, np.arange(w8)[None, :] // 8]
    sel = (idx >= 0) & ~skip8[:h8, :w8] & on_t[np.maximum(idx, 0)]
    bys, bxs = np.nonzero(sel)
    if not len(bys):
        return
    bidx = idx[bys, bxs]
    lvls, secs = lvl_t[bidx], sec_t[bidx]
    ulvls, usecs = ulvl_t[bidx], usec_t[bidx]
    blk = srcs[0][3:3 + h_eff, 3:3 + w_eff].reshape(h8, 8, w8, 8) \
        .transpose(0, 2, 1, 3)[bys, bxs]
    dirs, var = find_dir_batch(blk, cs)
    pris = adjust_strength(lvls << cs, var)
    dirs = np.where((lvls << cs) == 0, 0, dirs)
    out = filter_blocks_batch(srcs[0], bys * 8, bxs * 8, 8, 8, pris,
                              secs << cs, dirs, damping + cs,
                              damping + cs, cs)
    peak = (1 << bd) - 1
    _put_blocks(recon_planes[0], bys, bxs, out, peak)
    csel = np.nonzero((ulvls > 0) | (usecs > 0))[0]
    if len(csel):
        duv = np.where((ulvls[csel] << cs) != 0, dirs[csel], 0)
        for p in (1, 2):
            outc = filter_blocks_batch(
                srcs[p], bys[csel] * 4, bxs[csel] * 4, 4, 4,
                ulvls[csel] << cs, usecs[csel] << cs, duv,
                damping + cs - 1, damping + cs - 1, cs)
            _put_blocks(recon_planes[p], bys[csel], bxs[csel], outc, peak)
