"""CDEF constants, the signaled strength presets and the host filter.

The port's copy of the JAX package's ``ops/cdef.py``: the primary and
secondary taps, the per-direction tap offsets, the direction search's
divisor table and the 4-entry strength sets scaled with quality. The
encoder's search and filter run on the torch device
(``ops/device_cdef.py``); the host NumPy filter here (``cdef_frame``,
batched direction search and filter, the JAX package's code unchanged)
is the mirror decoder's (``pipeline/decode.py``).

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


def strength_presets(qindex: int):
    """4-entry (y, uv) strength sets (pri*4 + sec six-bit codes), scaled
    with quality; entry 0 is always off."""
    if qindex < 80:
        y = (0, 1 * 4 + 0, 2 * 4 + 1, 4 * 4 + 1)
    elif qindex < 160:
        y = (0, 2 * 4 + 1, 4 * 4 + 1, 7 * 4 + 2)
    else:
        y = (0, 2 * 4 + 1, 5 * 4 + 2, 9 * 4 + 2)
    uv = tuple(min(63, (s // 4 // 2) * 4 + min(s % 4, 3)) for s in y)
    return y, uv



# --- the host filter (the mirror decoder's CDEF) ---------------------------
def _get_msb(v: int) -> int:
    return max(0, int(v).bit_length() - 1)


def adjust_strength(strength: int, var: int) -> int:
    i = min(_get_msb(var >> 6), 12) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4 if var else 0


def _padded_copy(plane: np.ndarray, w_eff: int, h_eff: int) -> np.ndarray:
    """int32 copy with a 3px CDEF_VERY_LARGE border; samples beyond the
    coded (mi) area are also VERY_LARGE."""
    pad = 3
    out = np.full((h_eff + 2 * pad, w_eff + 2 * pad), CDEF_VERY_LARGE,
                  dtype=np.int64)
    out[pad:pad + h_eff, pad:pad + w_eff] = plane[:h_eff, :w_eff]
    return out


def find_dir_batch(blocks: np.ndarray, coeff_shift: int):
    """Batched find_dir: [B, 8, 8] -> (dirs [B], vars [B]) — identical
    math to find_dir via one-hot projection sums."""
    B = blocks.shape[0]
    x = (blocks.astype(np.int64) >> coeff_shift) - 128
    i = np.arange(8)[:, None] * np.ones(8, dtype=int)[None, :]
    j = np.ones(8, dtype=int)[:, None] * np.arange(8)[None, :]
    idx = [i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j,
           3 - i // 2 + j, j, i // 2 + j]
    global _DIR_PROJ
    try:
        proj = _DIR_PROJ
    except NameError:
        proj = np.zeros((8, 15, 64), dtype=np.int64)
        for d in range(8):
            flat = idx[d].reshape(-1)
            for k, t in enumerate(flat):
                proj[d, t, k] = 1
        _DIR_PROJ = proj
    part = np.einsum("dtk,bk->bdt", proj, x.reshape(B, 64))
    cost = np.zeros((B, 8), dtype=np.int64)
    for d in (2, 6):
        cost[:, d] = np.sum(part[:, d, :8] ** 2, axis=1) * _DIV_TABLE[8]
    for d in (0, 4):
        c = np.sum((part[:, d, :7] ** 2 + part[:, d, 14:7:-1] ** 2)
                   * _DIV_TABLE[1:8], axis=1)
        cost[:, d] = c + part[:, d, 7] ** 2 * _DIV_TABLE[8]
    for d in (1, 3, 5, 7):
        c = np.sum(part[:, d, 3:8] ** 2, axis=1) * _DIV_TABLE[8]
        cost[:, d] = c + np.sum(
            (part[:, d, :3] ** 2 + part[:, d, 10:7:-1] ** 2)
            * _DIV_TABLE[2:8:2], axis=1)
    best = np.argmax(cost, axis=1)
    bc = np.take_along_axis(cost, best[:, None], axis=1)[:, 0]
    oc = np.take_along_axis(cost, ((best + 4) & 7)[:, None], axis=1)[:, 0]
    return best.astype(np.int32), ((bc - oc) >> 10).astype(np.int64)


def filter_blocks_batch(src: np.ndarray, ys, xs, h: int, w: int, pri,
                        sec, dirs, pri_damping: int, sec_damping: int,
                        coeff_shift: int) -> np.ndarray:
    """Batched filter_block: per-block strengths/directions, all blocks
    in one pass (identical math; src is the padded pre-CDEF copy so
    blocks are independent)."""
    B = len(ys)
    ys = np.asarray(ys)
    xs = np.asarray(xs)
    pri = np.asarray(pri, dtype=np.int64)
    sec = np.asarray(sec, dtype=np.int64)
    dirs = np.asarray(dirs, dtype=np.int64)
    Wp = src.shape[1]
    flat = src.reshape(-1).astype(np.int64)
    iy = ys[:, None, None] + np.arange(-3, h + 3)[None, :, None] + 3
    ix = xs[:, None, None] + np.arange(-3, w + 3)[None, None, :] + 3
    win = flat[(iy * Wp + ix).reshape(B, -1)].reshape(B, h + 6, w + 6)
    x = win[:, 3:3 + h, 3:3 + w]
    tap_idx = (pri >> coeff_shift) & 1
    offs = np.array(DIR_OFFSETS, dtype=np.int64)       # [8, 2, 2]
    d_off = offs[dirs]                                  # [B, 2, 2]
    pri_t = np.array(PRI_TAPS, dtype=np.int64)[tap_idx]  # [B, 2]
    sec_t = np.array(SEC_TAPS, dtype=np.int64)[tap_idx]
    s_acc = np.zeros((B, h, w), dtype=np.int64)
    mx = x.copy()
    mn = x.copy()

    def gather(dy, dx):
        gy = iy[:, 3:3 + h, :1] + dy[:, None, None]
        gx = ix[:, :1, 3:3 + w] + dx[:, None, None]
        return flat[(gy * Wp + gx).reshape(B, -1)].reshape(B, h, w)

    def constrain_arr(diff, thr, damping):
        thr = np.asarray(thr)
        shift = np.maximum(0, damping - np.where(
            thr > 0, np.floor(np.log2(np.maximum(thr, 1))), 0)
            .astype(np.int64))
        v = np.minimum(np.abs(diff),
                       np.maximum(0, thr - (np.abs(diff) >> shift)))
        return np.where(thr == 0, 0, np.sign(diff) * v)

    pb = pri[:, None, None]
    sb = sec[:, None, None]
    for k in range(2):
        pt = pri_t[:, k, None, None]
        st = sec_t[:, k, None, None]
        for sgn in (1, -1):
            p = gather(sgn * d_off[:, k, 0], sgn * d_off[:, k, 1])
            s_acc += pt * constrain_arr(p - x, pb, pri_damping)
            mx = np.maximum(mx, np.where(p == CDEF_VERY_LARGE, mx, p))
            mn = np.minimum(mn, p)
            for od in (2, 6):
                d2 = offs[(dirs + od) & 7]
                q = gather(sgn * d2[:, k, 0], sgn * d2[:, k, 1])
                s_acc += st * constrain_arr(q - x, sb, sec_damping)
                mx = np.maximum(mx, np.where(q == CDEF_VERY_LARGE, mx, q))
                mn = np.minimum(mn, q)
    out = x + ((8 + s_acc - (s_acc < 0)) >> 4)
    return np.clip(out, mn, mx)


def cdef_frame(recon_planes, skip8: np.ndarray, cdef_idx: np.ndarray,
               y_strengths, uv_strengths, damping: int, mi_rows: int,
               mi_cols: int, bd: int = 8) -> None:
    """Apply CDEF in place. skip8: [h8, w8] bool (all-skip 8x8 luma units);
    cdef_idx: [sb_rows, sb_cols] int (-1 = uncoded/skipped SB)."""
    cs = bd - 8
    w_eff, h_eff = mi_cols * 4, mi_rows * 4
    srcs = [_padded_copy(recon_planes[0], w_eff, h_eff),
            _padded_copy(recon_planes[1], w_eff // 2, h_eff // 2),
            _padded_copy(recon_planes[2], w_eff // 2, h_eff // 2)]
    h8, w8 = (h_eff + 7) // 8, (w_eff + 7) // 8
    sb_rows, sb_cols = cdef_idx.shape
    # collect every non-skip 8x8 of every coded SB with its strengths
    bys, bxs, lvls, secs, ulvls, usecs = [], [], [], [], [], []
    for sbr in range(sb_rows):
        for sbc in range(sb_cols):
            idx = int(cdef_idx[sbr, sbc])
            if idx < 0:
                continue
            lvl = y_strengths[idx] // 4
            sec = y_strengths[idx] % 4
            sec += int(sec == 3)
            uv_lvl = uv_strengths[idx] // 4
            uv_sec = uv_strengths[idx] % 4
            uv_sec += int(uv_sec == 3)
            if lvl == 0 and sec == 0 and uv_lvl == 0 and uv_sec == 0:
                continue
            for by in range(sbr * 8, min(sbr * 8 + 8, h8)):
                for bx in range(sbc * 8, min(sbc * 8 + 8, w8)):
                    if skip8[by, bx]:
                        continue
                    bys.append(by)
                    bxs.append(bx)
                    lvls.append(lvl)
                    secs.append(sec)
                    ulvls.append(uv_lvl)
                    usecs.append(uv_sec)
    if not bys:
        return
    bys = np.array(bys)
    bxs = np.array(bxs)
    lvls = np.array(lvls, dtype=np.int64)
    secs = np.array(secs, dtype=np.int64)
    ulvls = np.array(ulvls, dtype=np.int64)
    usecs = np.array(usecs, dtype=np.int64)
    B = len(bys)
    blk = np.stack([srcs[0][3 + y * 8:11 + y * 8, 3 + x * 8:11 + x * 8]
                    for y, x in zip(bys, bxs)])
    dirs, var = find_dir_batch(blk, cs)
    pris = np.array([adjust_strength(int(lvls[i]) << cs, int(var[i]))
                     for i in range(B)], dtype=np.int64)
    dirs = np.where((lvls << cs) == 0, 0, dirs)
    out = filter_blocks_batch(srcs[0], bys * 8, bxs * 8, 8, 8, pris,
                              secs << cs, dirs, damping + cs,
                              damping + cs, cs)
    peak = (1 << bd) - 1
    for i in range(B):
        yl = min(8, h_eff - int(bys[i]) * 8)
        xl = min(8, w_eff - int(bxs[i]) * 8)
        recon_planes[0][bys[i] * 8:bys[i] * 8 + yl,
                        bxs[i] * 8:bxs[i] * 8 + xl] = \
            np.clip(out[i, :yl, :xl], 0, peak)
    csel = np.nonzero((ulvls > 0) | (usecs > 0))[0]
    if len(csel):
        duv = np.where((ulvls[csel] << cs) != 0, dirs[csel], 0)
        for p in (1, 2):
            outc = filter_blocks_batch(
                srcs[p], bys[csel] * 4, bxs[csel] * 4, 4, 4,
                ulvls[csel] << cs, usecs[csel] << cs, duv,
                damping + cs - 1, damping + cs - 1, cs)
            for j, i in enumerate(csel):
                cyl = min(4, h_eff // 2 - int(bys[i]) * 4)
                cxl = min(4, w_eff // 2 - int(bxs[i]) * 4)
                recon_planes[p][bys[i] * 4:bys[i] * 4 + cyl,
                                bxs[i] * 4:bxs[i] * 4 + cxl] = \
                    np.clip(outc[j, :cyl, :cxl], 0, peak)
