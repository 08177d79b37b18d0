"""PyTorch twin of the JAX package's device CDEF (``svt_av1_tpu/ops/device_cdef.py``).

One call per frame does what the JAX program ``_build_cdef`` does: the 8x8
direction search, the filtered SSE of all four signaled strength presets
(luma 8x8 blocks and both chroma 4x4 planes), the per-64x64-SB argmin and
the final pass with the chosen strengths, written into the recon planes in
place. Only the SB index map comes back to the host. Everything is integer,
so the index map and the filtered planes equal the host pair
``cdef_search`` + ``cdef_frame`` of the JAX package.

Layout: the JAX program filters the padded plane densely once per
direction (static shifted slices) and lets each pixel select its block's
direction afterwards. Here each pixel reads only its own direction's 12
taps: per tap slot one gather at the pixel's offset (``_tap_offsets``),
and the four presets run as one leading batch dimension. The sums, the
maxima and the minima are those of the pixel's direction, so the
integers are the JAX program's, in about 1/8 of the tensor operations.

Exactness notes: the direction search's projection is a matmul of
samples in [-128, 16256] with a 0/1 matrix; CUDA torch has no integer
matmul, so it runs in fp64, where every partial sum (|sum| < 2^20) is
exact. ``argmax`` over the 8 direction costs and ``argmin`` over the 4
presets keep the first extremum, as JAX does.

Reference: cdef_find_dir_c / cdef_filter_block_c / cdef_seg_search
(``EbCdef.c:132,205``; segment fan-out ``EbCdefProcess.c:469``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from svt_av1_tpu_torch.ops import cdef as tables
from svt_av1_tpu_torch.ops.device import const, plane_i32, write_plane

VERY_LARGE = tables.CDEF_VERY_LARGE


def _msb_clip(v, kmax: int):
    """floor(log2(v)) for v >= 1, exact, clipped to kmax (0 for v == 0)."""
    out = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for k in range(1, kmax + 1):
        out += (v >= (1 << k)).to(torch.int32)
    return out


def _damp_shift(thr, damping: int):
    """The constrain's shift, max(0, damping - floor(log2(thr)))."""
    return (damping - _msb_clip(thr, 6)).clamp_min(0)


def _constrain_j(diff, thr, shift):
    """Per-pixel constrain with threshold ``thr`` and its ``_damp_shift``
    (int32; both broadcast against ``diff``)."""
    a = diff.abs()
    mag = torch.minimum(a, (thr - (a >> shift)).clamp_min(0))
    return torch.where(thr == 0, 0, torch.sign(diff) * mag)


@functools.lru_cache(maxsize=1)
def _dir_proj() -> np.ndarray:
    """[120, 64] 0/1 projection: partial[d*15+t] = sum of block pixels on
    diagonal t of direction d (host find_dir's np.add.at as a matmul)."""
    i = np.arange(8)[:, None] * np.ones(8, dtype=int)[None, :]
    j = np.ones(8, dtype=int)[:, None] * np.arange(8)[None, :]
    idx = [i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j,
           3 - i // 2 + j, j, i // 2 + j]
    proj = np.zeros((8 * 15, 64), dtype=np.int32)
    for d in range(8):
        for k, t in enumerate(idx[d].reshape(-1)):
            proj[d * 15 + t, k] = 1
    return proj


@functools.lru_cache(maxsize=1)
def _dir_weights() -> np.ndarray:
    """[8, 15] divisor weight of each partial sum's square in its
    direction's cost (cdef_find_dir_c's cost terms, as one table)."""
    div = tables._DIV_TABLE
    wt = np.zeros((8, 15), dtype=np.int64)
    for d in (2, 6):
        wt[d, :8] = div[8]
    for d in (0, 4):
        wt[d, :7] = div[1:8]
        wt[d, 8:15] = div[7:0:-1]        # part[14 - k] weighs div[1 + k]
        wt[d, 7] = div[8]
    for d in (1, 3, 5, 7):
        wt[d, 3:8] = div[8]
        wt[d, 0:3] = div[2:8:2]
        wt[d, 8:11] = div[6:1:-2]        # part[10 - k] weighs div[2 + 2k]
    return wt


@functools.lru_cache(maxsize=8)
def _dir_consts(device: torch.device):
    return (const(_dir_proj().T, device, torch.float64),
            const(_dir_weights(), device))


def _find_dir_dense(x8, cs: int):
    """x8: [hb, wb, 8, 8] int32 blocks from the padded copy.
    Returns (dirs [hb, wb] int64, var [hb, wb] int64)."""
    hb, wb = x8.shape[:2]
    proj, wt = _dir_consts(x8.device)
    x = ((x8 >> cs) - 128).reshape(hb * wb, 64).to(torch.float64)
    part = (x @ proj).to(torch.int64).reshape(hb * wb, 8, 15)
    cost = (part * part * wt).sum(dim=2)
    best = torch.argmax(cost, dim=1)                 # first maximum
    bc = cost.gather(1, best[:, None])[:, 0]
    oc = cost.gather(1, ((best + 4) & 7)[:, None])[:, 0]
    return best.reshape(hb, wb), ((bc - oc) >> 10).reshape(hb, wb)


@functools.lru_cache(maxsize=16)
def _tap_offsets(pitch: int, device: torch.device):
    """[12, 8] flat offsets, in a padded plane of row pitch ``pitch``, of
    the 12 taps of every direction in the JAX filter's order: for k, for
    sign, the primary tap of d, then the secondary taps of d+2 and d+6."""
    off = np.zeros((12, 8), dtype=np.int64)
    for d in range(8):
        j = 0
        for k in range(2):
            for sgn in (1, -1):
                for dd in (d, (d + 2) & 7, (d + 6) & 7):
                    dy, dx = tables.DIR_OFFSETS[dd][k]
                    off[j, d] = sgn * (dy * pitch + dx)
                    j += 1
    return const(off, device)


def _expand(m, blk: int):
    """[..., hb, wb] -> [..., hb*blk, wb*blk] (each block constant)."""
    return m.repeat_interleave(blk, dim=-2).repeat_interleave(blk, dim=-1)


def _filter(P, dirs, pri, sec, damping: int, cs: int, blk: int):
    """CDEF of one padded plane P ([Hd+6, Wd+6] int32, VERY_LARGE border)
    under n strength sets at once. dirs / pri: [n, hb, wb] per-block
    direction and primary strength; sec: [n] secondary strengths (python
    ints). Returns the unclipped filtered planes [n, Hd, Wd] int32 (host
    filter_blocks_batch over every block, fused)."""
    Hd, Wd = P.shape[0] - 6, P.shape[1] - 6
    pitch = Wd + 6
    dev = P.device
    x = P[3:3 + Hd, 3:3 + Wd]
    flat = P.reshape(-1)
    base = ((torch.arange(Hd, device=dev)[:, None] + 3) * pitch
            + torch.arange(Wd, device=dev)[None, :] + 3)
    dir_px = _expand(dirs, blk)
    offs = _tap_offsets(pitch, dev)
    pri_px = _expand(pri, blk)
    pshift = _expand(_damp_shift(pri, damping), blk)
    odd = _expand((pri >> cs) & 1, blk) == 1
    pri_w = [torch.where(odd, tables.PRI_TAPS[1][k], tables.PRI_TAPS[0][k])
             .to(torch.int32) for k in range(2)]
    sec_t = const(np.asarray(sec, np.int32), dev)[:, None, None]
    sshift = _damp_shift(sec_t, damping)
    n = dirs.shape[0]
    s_acc = torch.zeros((n, Hd, Wd), dtype=torch.int32, device=dev)
    mx = x.expand(n, Hd, Wd)
    mn = mx
    for j in range(12):
        k = j // 6
        p = flat[base + offs[j][dir_px]]
        if j % 3 == 0:
            s_acc += pri_w[k] * _constrain_j(p - x, pri_px, pshift)
        else:
            s_acc += tables.SEC_TAPS[0][k] * _constrain_j(p - x, sec_t,
                                                          sshift)
        mx = torch.maximum(mx, torch.where(p == VERY_LARGE, mx, p))
        mn = torch.minimum(mn, p)
    v = x + ((8 + s_acc - (s_acc < 0).to(torch.int32)) >> 4)
    return torch.minimum(torch.maximum(v, mn), mx)


def _padded(plane, He: int, We: int, Hg: int, Wg: int):
    P = torch.full((Hg + 6, Wg + 6), VERY_LARGE, dtype=torch.int32,
                   device=plane.device)
    P[3:3 + He, 3:3 + We] = plane[:He, :We]
    return P


def _block_sse(out, src, mask, blk: int):
    """Per-block masked SSE: [n, Hd, Wd] -> [n, hb, wb] int64."""
    n, Hd, Wd = out.shape
    d = ((out - src) * mask).to(torch.int64)
    return (d * d).reshape(n, Hd // blk, blk, Wd // blk, blk).sum(dim=(2, 4))


def _sb_sum(m, sb_rows: int, sb_cols: int):
    """[..., h8, w8] -> per-SB sums [..., sb_rows, sb_cols] (the 8x8-block
    grid padded with zeros to SB multiples)."""
    h8, w8 = m.shape[-2:]
    m = torch.nn.functional.pad(m, (0, sb_cols * 8 - w8, 0, sb_rows * 8 - h8))
    return m.reshape(*m.shape[:-2], sb_rows, 8, sb_cols, 8).sum(dim=(-3, -1))


def _sec_of(code: int) -> int:
    s = code % 4
    return s + (s == 3)


def cdef_search_apply_dev(recon_planes, src_planes, skip8, mi_rows: int,
                          mi_cols: int, qindex: int, bd: int = 8,
                          device="cuda"):
    """CDEF strength search + apply on ``device`` (host cdef_search +
    cdef_frame twin). recon_planes: numpy planes, or tensors (which stay
    on their device); written in place. src_planes: numpy or tensors.
    skip8: [h8, w8] bool, the all-skip 8x8 luma units. Returns (cdef_idx
    [sb_rows, sb_cols] int32 numpy, y_strengths, uv_strengths, damping),
    integers identical to the host pair."""
    y_str, uv_str = tables.strength_presets(qindex)
    damping = 3 + (qindex >> 6)
    cs = bd - 8
    peak = (1 << bd) - 1
    h_eff, w_eff = mi_rows * 4, mi_cols * 4
    h8, w8 = (h_eff + 7) // 8, (w_eff + 7) // 8
    sb_rows, sb_cols = (mi_rows + 15) // 16, (mi_cols + 15) // 16
    Hd, Wd = h8 * 8, w8 * 8            # luma grid (>= h_eff/w_eff)
    Hc, Wc = h8 * 4, w8 * 4            # chroma grid
    hc_eff, wc_eff = h_eff // 2, w_eff // 2
    y, u, v = (plane_i32(p, device) for p in recon_planes)
    dev = y.device
    Py = _padded(y, h_eff, w_eff, Hd, Wd)
    Pu = _padded(u, hc_eff, wc_eff, Hc, Wc)
    Pv = _padded(v, hc_eff, wc_eff, Hc, Wc)
    x8 = Py[3:3 + Hd, 3:3 + Wd].reshape(h8, 8, w8, 8).permute(0, 2, 1, 3)
    dirs, var = _find_dir_dense(x8, cs)

    sk = np.zeros((h8, w8), dtype=bool)
    sk[:skip8.shape[0], :skip8.shape[1]] = skip8[:h8, :w8]
    nskip = ~const(sk, dev)
    val_y = torch.zeros((Hd, Wd), dtype=torch.bool, device=dev)
    val_y[:h_eff, :w_eff] = True
    val_c = torch.zeros((Hc, Wc), dtype=torch.bool, device=dev)
    val_c[:hc_eff, :wc_eff] = True
    mask_y = (val_y & _expand(nskip, 8)).to(torch.int32)
    mask_c = (val_c & _expand(nskip, 4)).to(torch.int32)
    srcs = []
    for p, (He, We, Hg, Wg) in zip(src_planes,
                                   ((h_eff, w_eff, Hd, Wd),
                                    (hc_eff, wc_eff, Hc, Wc),
                                    (hc_eff, wc_eff, Hc, Wc))):
        s = torch.zeros((Hg, Wg), dtype=torch.int32, device=dev)
        s[:He, :We] = plane_i32(p, dev)[:He, :We]
        srcs.append(s)

    # adjust_strength over the whole direction grid, the 4 presets as a
    # leading batch dimension
    adj = _msb_clip(var >> 6, 13).clamp_max(12)
    lvl = const(np.asarray([(s // 4) << cs for s in y_str], np.int64),
                dev)[:, None, None]
    pri = torch.where(var != 0, (lvl * (4 + adj) + 8) >> 4, 0)
    pri = torch.where(lvl == 0, 0, pri).to(torch.int32)
    oy = _filter(Py, torch.where(lvl != 0, dirs, 0), pri,
                 [_sec_of(s) << cs for s in y_str], damping + cs, cs, 8)
    oy = oy.clamp(0, peak)
    sse = _block_sse(oy, srcs[0], mask_y, 8)
    uvl = const(np.asarray([(s // 4) << cs for s in uv_str], np.int64),
                dev)[:, None, None]
    duv = torch.where(uvl != 0, dirs, 0)
    pri_c = (uvl + torch.zeros_like(dirs)).to(torch.int32)
    sec_c = [_sec_of(s) << cs for s in uv_str]
    ouv = []
    for P, src in ((Pu, srcs[1]), (Pv, srcs[2])):
        o = _filter(P, duv, pri_c, sec_c, damping + cs - 1, cs,
                    4).clamp(0, peak)
        sse = sse + _block_sse(o, src, mask_c, 4)
        ouv.append(o)

    tot = _sb_sum(sse, sb_rows, sb_cols)                 # [4, sbr, sbc]
    nblk = _sb_sum(nskip.to(torch.int32), sb_rows, sb_cols)
    best = torch.argmin(tot, dim=0)                      # first minimum
    idx_map = torch.where(nblk > 0, best, -1)

    # apply = select the chosen preset per SB (skip blocks, uncoded SBs
    # and samples outside the coded area keep the original pixels)
    sel8 = _expand(idx_map, 8)[:h8, :w8]
    wr = (sel8 >= 0) & nskip
    sel8 = sel8.clamp_min(0)
    for dst, plane, outs, blk, val, (Hg, Wg) in (
            (recon_planes[0], y, oy, 8, val_y, (Hd, Wd)),
            (recon_planes[1], u, ouv[0], 4, val_c, (Hc, Wc)),
            (recon_planes[2], v, ouv[1], 4, val_c, (Hc, Wc))):
        pick = outs.gather(0, _expand(sel8, blk)[None])[0]
        out = torch.where(_expand(wr, blk) & val, pick, plane[:Hg, :Wg])
        write_plane(dst, out, Hg, Wg)
    return (idx_map.to(torch.int32).cpu().numpy(), y_str, uv_str, damping)
