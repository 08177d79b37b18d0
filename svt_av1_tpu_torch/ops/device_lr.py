"""PyTorch twin of the JAX package's device loop restoration
(``svt_av1_tpu/ops/device_lr.py``): statistics, exact SSEs, apply.

Three passes per frame, each over all three planes, as the JAX package's
three programs, all from one set of operands per plane (``lr_planes``:
the filter windows, the source tiles and the SGR parts of every swept
ep, built once and kept alive across the host solves):

  A. ``lr_stats_dev`` — per-unit integer statistics: the Wiener
     autocorrelation and cross Gram (H, M), the SGR projection stats
     (ata, atb) of every swept ep, and the unfiltered SSE.
  B. ``lr_sse_dev`` — exact SSEs of the quantized candidates (Wiener taps
     and each swept ep's xqd) through the real stripe filters.
  C. ``lr_apply_dev`` — the final filter pass with the chosen per-unit
     parameters, written into the recon planes in place.

Between them the float solves and the RD decision run on the host
(``pipeline/lr_search.py``) from the same integers, so the parameters and
the stream equal the JAX package's.

Layout: the plane is tiled into (stripe x unit-column) pieces, gathered
into one [P, mh+6, mw+6] window tensor (rows from the plane and the
saved boundary lines, then columns with edge clamping); every filter runs
batched over the pieces, and per-unit sums are an ``index_add_`` over
the pieces' unit ids.

Exactness notes: CUDA torch has no integer matmul. The Wiener Gram and
cross statistics (int8 x int8 dots with int32 accumulation in the JAX
program, through a 5-bit hi/lo split) are fp64 ``bmm``s of the samples
themselves here: every partial sum is a non-negative integer below
1023^2 * mh * mw < 2^35, exact in fp64 in any summation order, and fp64
never runs in TF32. The planes are done one at a time, so the largest
operand (the 1080p luma window stack [P, 49, mh*mw]) is alive alone.

Reference: av1_compute_stats / get_proj_subspace / search_wiener_unit /
search_sgrproj_unit (``EbRestorationPick.c:340,580,1100-1500``),
av1_loop_restoration_filter_unit (``EbRestoration.c:1173``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from svt_av1_tpu_torch.ops import restoration as rst
from svt_av1_tpu_torch.ops.device import const, plane_i32, write_plane

EP_SWEEP = (0, 3, 6, 9, 11, 14)
UNIT_SIZE_Y = 256   # luma restoration unit size; chroma max(64, 256 >> 1)


# --- static geometry ---------------------------------------------------------

class _Geom:
    __slots__ = ("lims", "hn", "vn", "nu", "P", "mh", "mw", "S", "row_idx",
                 "col_idx", "org_row", "org_col", "mask", "unit_of",
                 "flat_map", "H", "W")


@functools.lru_cache(maxsize=32)
def _plane_geom(W: int, H: int, size: int, ss: int) -> _Geom:
    g = _Geom()
    g.H, g.W = H, W
    g.lims, g.hn, g.vn = rst.unit_limits(W, H, size, ss)
    g.nu = len(g.lims)
    stripe_h = rst.RESTORATION_PROC_UNIT_SIZE >> ss
    off = rst.RESTORATION_UNIT_OFFSET >> ss
    nstripes = 0
    while max(0, nstripes * stripe_h - off) < H:
        nstripes += 1
    g.S = nstripes
    pieces = []   # (unit_id, y, h, h0, w, stripe)
    for ui, lim in enumerate(g.lims):
        v0, v1, h0, h1 = lim
        for (y, h) in rst.unit_stripe_pieces(lim, ss):
            s = (y + off) // stripe_h
            pieces.append((ui, y, h, h0, h1 - h0, s))
    g.P = len(pieces)
    g.mh = max(p[2] for p in pieces)
    g.mw = max(p[4] for p in pieces)
    row_idx = np.zeros((g.P, g.mh + 6), dtype=np.int64)
    org_row = np.zeros((g.P, g.mh), dtype=np.int64)
    col_idx = np.zeros((g.P, g.mw + 6), dtype=np.int64)
    org_col = np.zeros((g.P, g.mw), dtype=np.int64)
    mask = np.zeros((g.P, g.mh, g.mw), dtype=bool)
    unit_of = np.zeros(g.P, dtype=np.int64)
    for i, (ui, y, h, h0, w, s) in enumerate(pieces):
        unit_of[i] = ui
        # rows of the combined [plane; 2S above; 2S below] stack
        if y == 0:
            top = [0, 0, 0]
        else:
            a = H + 2 * s
            top = [a, a, a + 1]
        if y + h >= H:
            bot = [H - 1, H - 1, H - 1]
        else:
            b = H + 2 * g.S + 2 * s
            bot = [b, b + 1, b + 1]
        rows = top + list(range(y, y + h)) + bot
        rows += [rows[-1]] * (g.mh - h)
        row_idx[i] = rows
        org_row[i] = list(range(y, y + h)) + [y + h - 1] * (g.mh - h)
        cols = np.clip(np.arange(h0 - 3, h0 - 3 + g.mw + 6), 0, W - 1)
        # edge clamp at the right unit boundary only happens at frame
        # edge; interior pieces read real neighbour pixels
        cols = np.minimum(cols, np.where(
            np.arange(g.mw + 6) < w + 6, W - 1, h0 + w - 1))
        col_idx[i] = cols
        org_col[i] = np.clip(np.arange(h0, h0 + g.mw), 0, W - 1)
        mask[i, :h, :w] = True
    g.row_idx = row_idx
    g.col_idx = col_idx
    g.org_row = org_row
    g.org_col = org_col
    g.mask = mask
    g.unit_of = unit_of
    # apply scatter: plane pixel -> flat index into [P, mh, mw]
    flat_map = np.zeros((H, W), dtype=np.int64)
    for i, (ui, y, h, h0, w, s) in enumerate(pieces):
        yy = np.arange(y, y + h)[:, None]
        xx = np.arange(h0, h0 + w)[None, :]
        flat_map[y:y + h, h0:h0 + w] = (i * g.mh + (yy - y)) * g.mw \
            + (xx - h0)
    g.flat_map = flat_map
    return g


class _GeomT(NamedTuple):
    """A geometry's index tensors on one device (mask as int64)."""
    row_idx: torch.Tensor
    col_idx: torch.Tensor
    org_row: torch.Tensor
    org_col: torch.Tensor
    mask: torch.Tensor
    unit_of: torch.Tensor
    flat_map: torch.Tensor


@functools.lru_cache(maxsize=32)
def _geom_t(W: int, H: int, size: int, ss: int,
            device: torch.device) -> _GeomT:
    g = _plane_geom(W, H, size, ss)
    return _GeomT(*(const(a, device) for a in (
        g.row_idx, g.col_idx, g.org_row, g.org_col,
        g.mask.astype(np.int64), g.unit_of, g.flat_map)))


def deblock_bounds_dev(plane, H: int, W: int, ss_y: int):
    """rst.save_deblock_boundary_lines of a device-resident plane (or a
    numpy one): every stripe's 2 + 2 saved rows in one gather and one
    fetch. Returns {stripe: (above [2, W] or None, below [2, W] or None)}
    of numpy rows."""
    stripe_h = rst.RESTORATION_PROC_UNIT_SIZE >> ss_y
    off = rst.RESTORATION_UNIT_OFFSET >> ss_y
    spans = []
    s = 0
    while True:
        y0 = max(0, s * stripe_h - off)
        if y0 >= H:
            break
        y1 = min((s + 1) * stripe_h - off, H)
        spans.append((s, y0, y1))
        s += 1
    rows = []
    for s, y0, y1 in spans:
        rows += [max(y0 - 2, 0), max(y0 - 1, 0),
                 min(y1, H - 1), min(y1 + 1, H - 1)]
    if isinstance(plane, torch.Tensor):
        idx = torch.as_tensor(rows, device=plane.device)
        got = plane[:H, :W].index_select(0, idx).cpu().numpy()
    else:
        got = np.asarray(plane)[:H, :W][rows]
    out = {}
    for i, (s, y0, y1) in enumerate(spans):
        above = got[4 * i:4 * i + 2].copy() if s > 0 else None
        below = got[4 * i + 2:4 * i + 4].copy() if y1 < H else None
        out[s] = (above, below)
    return out


def _bounds_arrays(bounds: dict, S: int, W: int):
    """dict {s: (above2, below2)} -> stacked [2S, W] above + [2S, W]
    below rows (zeros where the stripe has no saved lines)."""
    ab = np.zeros((2 * S, W), dtype=np.int32)
    be = np.zeros((2 * S, W), dtype=np.int32)
    for s in range(S):
        a, b = bounds.get(s, (None, None))
        if a is not None:
            ab[2 * s:2 * s + 2] = a
        if b is not None:
            be[2 * s:2 * s + 2] = b
    return ab, be


# --- batched piece filters ---------------------------------------------------

def _round2j(x, n: int):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _winsum_j(x, r: int):
    """Batched full-window sums [B, H, W] -> [B, H-2r, W-2r]."""
    n = 2 * r + 1
    v = torch.cumsum(x, dim=1)
    v = torch.cat([v[:, n - 1:n], v[:, n:] - v[:, :-n]], dim=1)
    hs = torch.cumsum(v, dim=2)
    return torch.cat([hs[:, :, n - 1:n], hs[:, :, n:] - hs[:, :, :-n]],
                     dim=2)


@functools.lru_cache(maxsize=8)
def _sgr_tables(device: torch.device):
    return const(rst._X_BY_XPLUS1, device, torch.int64)


def _sgr_ab_j(dgd_ext, r: int, s: int, h: int, w: int, bd: int):
    """The self-guided filter's A and B over [B, h+2, w+2] (twin of
    rst._sgr_ab)."""
    d = dgd_ext.to(torch.int64)
    a_full = _winsum_j(d * d, r)
    b_full = _winsum_j(d, r)
    i0 = 2 - r
    A = a_full[:, i0:i0 + h + 2, i0:i0 + w + 2]
    B = b_full[:, i0:i0 + h + 2, i0:i0 + w + 2]
    n = (2 * r + 1) * (2 * r + 1)
    a = _round2j(A, 2 * (bd - 8))
    b = _round2j(B, bd - 8)
    p = (a * n - b * b).clamp_min(0)
    z = _round2j(p * s, rst.SGRPROJ_MTABLE_BITS)
    A2 = _sgr_tables(d.device)[z.clamp_max(255)]
    B2 = _round2j((256 - A2) * B * int(rst._ONE_BY_X[n - 1]),
                  rst.SGRPROJ_RECIP_BITS)
    return A2, B2


def _windows(plane, above, below, geom: _Geom, gt):
    """[P, mh+6, mw+6] int32 stripe-piece filter windows."""
    combined = torch.cat([plane[:geom.H, :geom.W], above, below], dim=0)
    return combined[gt.row_idx[:, :, None], gt.col_idx[:, None, :]]


def _org_tiles(src, geom: _Geom, gt):
    return src[:geom.H, :geom.W][gt.org_row[:, :, None],
                                 gt.org_col[:, None, :]]


def _unit_sum(x, geom: _Geom, gt):
    """[P, ...] int64 piece values -> per-unit sums [nu, ...]."""
    out = torch.zeros((geom.nu,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, gt.unit_of, x)


def _gram(win, mask, offs, geom: _Geom, gt):
    """Exact Wiener stats: H[u, k1, k2] = sum of d_k1 d_k2 over the unit's
    pixels, as one fp64 batched product (see the module notes). Returns
    (H per unit, the masked window stack [P, K^2, mh*mw] fp64)."""
    mh, mw = geom.mh, geom.mw
    D = torch.stack([win[:, 3 + dy:3 + dy + mh, 3 + dx:3 + dx + mw]
                     for (dy, dx) in offs], dim=1) \
        .reshape(geom.P, len(offs), mh * mw).to(torch.float64)
    Dm = D * mask.reshape(geom.P, 1, mh * mw)
    G = torch.bmm(Dm, D.transpose(1, 2)).to(torch.int64)
    return _unit_sum(G, geom, gt), Dm


def _sgr_parts(win, d, u, ep: int, bd: int, geom: _Geom):
    """(f0 - u, f1 - u) for one ep over the piece batch (int64; None for
    absent radii). Mirrors rst._sgr_flt_fast/_sgr_flt_full."""
    (r0, r1), (s0, s1) = rst.SGR_PARAMS[ep]
    mh, mw = geom.mh, geom.mw
    f0 = f1 = None
    m = slice(1, mw + 1)
    lf, rt = slice(0, mw), slice(2, mw + 2)
    if r0 > 0:
        A, B = _sgr_ab_j(win, r0, s0, mh, mw, bd)
        out = torch.zeros((geom.P, mh, mw), dtype=torch.int64,
                          device=win.device)
        # even rows read A/B rows y and y+2; odd rows their own row y+1
        ev, ev2 = slice(0, mh, 2), slice(2, mh + 2, 2)
        a = (A[:, ev, m] + A[:, ev2, m]) * 6 + \
            (A[:, ev, lf] + A[:, ev, rt] + A[:, ev2, lf] + A[:, ev2, rt]) * 5
        bb = (B[:, ev, m] + B[:, ev2, m]) * 6 + \
            (B[:, ev, lf] + B[:, ev, rt] + B[:, ev2, lf] + B[:, ev2, rt]) * 5
        out[:, 0::2] = _round2j(
            a * d[:, 0::2] + bb,
            rst.SGRPROJ_SGR_BITS + 5 - rst.SGRPROJ_RST_BITS)
        od = slice(2, mh + 1, 2)
        a = A[:, od, m] * 6 + (A[:, od, lf] + A[:, od, rt]) * 5
        bb = B[:, od, m] * 6 + (B[:, od, lf] + B[:, od, rt]) * 5
        out[:, 1::2] = _round2j(
            a * d[:, 1::2] + bb,
            rst.SGRPROJ_SGR_BITS + 4 - rst.SGRPROJ_RST_BITS)
        f0 = out - u
    if r1 > 0:
        A, B = _sgr_ab_j(win, r1, s1, mh, mw, bd)
        c = slice(1, mh + 1)
        up, dn = slice(0, mh), slice(2, mh + 2)
        a = (A[:, c, m] + A[:, c, lf] + A[:, c, rt] + A[:, up, m]
             + A[:, dn, m]) * 4 + \
            (A[:, up, lf] + A[:, up, rt] + A[:, dn, lf] + A[:, dn, rt]) * 3
        bb = (B[:, c, m] + B[:, c, lf] + B[:, c, rt] + B[:, up, m]
              + B[:, dn, m]) * 4 + \
            (B[:, up, lf] + B[:, up, rt] + B[:, dn, lf] + B[:, dn, rt]) * 3
        f1 = _round2j(a * d + bb,
                      rst.SGRPROJ_SGR_BITS + 5 - rst.SGRPROJ_RST_BITS) - u
    return f0, f1


def _sgr_project(f0, f1, u, xq, peak: int):
    """The SGR output of one ep with per-piece decoded xq [P, 2]."""
    v = u << rst.SGRPROJ_PRJ_BITS
    if f0 is not None:
        v = v + xq[:, 0, None, None] * f0
    if f1 is not None:
        v = v + xq[:, 1, None, None] * f1
    return _round2j(v, rst.SGRPROJ_PRJ_BITS + rst.SGRPROJ_RST_BITS) \
        .clamp(0, peak)


def _wiener_traced(win, fv, fh, bd: int, geom: _Geom):
    """wiener_filter with per-piece 7-tap vectors [P, 7]."""
    mh, mw = geom.mh, geom.mw
    r0 = 3 if bd < 12 else 5
    r1 = 2 * rst.WIENER_FILT_PREC_BITS - r0
    s = win.to(torch.int64)
    hsum = torch.full((geom.P, mh + 6, mw),
                      1 << (bd + rst.WIENER_FILT_PREC_BITS - 1),
                      dtype=torch.int64, device=win.device)
    for k in range(7):
        hsum = hsum + fh[:, k, None, None] * s[:, :, k:k + mw]
    mid = _round2j(hsum, r0).clamp(
        0, (1 << (bd + 1 + rst.WIENER_FILT_PREC_BITS - r0)) - 1)
    vsum = torch.zeros((geom.P, mh, mw), dtype=torch.int64,
                       device=win.device)
    for k in range(7):
        vsum = vsum + fv[:, k, None, None] * mid[:, k:k + mh]
    vsum = vsum - (1 << (bd + r1 - 1))
    return _round2j(vsum, r1).clamp(0, (1 << bd) - 1)


def _offs(K: int):
    hw = K // 2
    return tuple((dy, dx) for dy in range(-hw, hw + 1)
                 for dx in range(-hw, hw + 1))


def _masked_sse(out, org, mask64):
    d = (out - org) * mask64
    return (d * d).sum(dim=(1, 2))


# --- the per-plane operands, built once for the three passes ---------------

class LrPlane(NamedTuple):
    """One plane's operands, shared by the three passes of a frame: the
    [P, mh+6, mw+6] int32 filter windows, the source tiles, the degraded
    samples d and u = d << RST_BITS (int64 [P, mh, mw]), and per swept ep
    its SGR parts (f0 - u, f1 - u; None for an absent radius)."""
    H: int
    W: int
    K: int
    size: int
    bd: int
    geom: _Geom
    gt: _GeomT
    win: torch.Tensor
    org: torch.Tensor
    d: torch.Tensor
    u: torch.Tensor
    parts: tuple


def lr_planes(recon, src, bounds, width, height, bd, device="cuda"):
    """The three planes' LrPlane operands from the (post-CDEF) recon
    planes, the source planes (numpy, or tensors) and the per-plane saved
    deblock boundary lines."""
    out = []
    for p in range(3):
        ss = 1 if p else 0
        W = (width + ss) >> ss
        H = (height + ss) >> ss
        size = max(64, UNIT_SIZE_Y >> ss)
        plane = plane_i32(recon[p], device)
        dev = plane.device
        geom = _plane_geom(W, H, size, ss)
        gt = _geom_t(W, H, size, ss, dev)
        ab, be = _bounds_arrays(bounds[p], geom.S, W)
        win = _windows(plane, const(ab, dev), const(be, dev), geom, gt)
        org = _org_tiles(plane_i32(src[p], dev), geom, gt).to(torch.int64)
        d = win[:, 3:3 + geom.mh, 3:3 + geom.mw].to(torch.int64)
        u = d << rst.SGRPROJ_RST_BITS
        parts = tuple(_sgr_parts(win, d, u, ep, bd, geom)
                      for ep in EP_SWEEP)
        out.append(LrPlane(H, W, 7 if p == 0 else 5, size, bd, geom, gt,
                           win, org, d, u, parts))
    return out


# --- the three passes (per plane) --------------------------------------------

def _stats_plane(pl: LrPlane):
    geom, gt, org, d = pl.geom, pl.gt, pl.org, pl.d
    mask64 = gt.mask
    Hm, Dm = _gram(pl.win, mask64, _offs(pl.K), geom, gt)
    o = org.reshape(geom.P, geom.mh * geom.mw, 1).to(torch.float64)
    Mv = _unit_sum(torch.bmm(Dm, o)[..., 0].to(torch.int64), geom, gt)
    del Dm
    sse_none = _unit_sum(_masked_sse(d, org, mask64), geom, gt)
    b = ((org - d) * mask64) << (rst.SGRPROJ_RST_BITS + rst.SGRPROJ_PRJ_BITS)
    zero = torch.zeros_like(d)
    atas, atbs = [], []
    for f0, f1 in pl.parts:
        fs = [f0 if f0 is not None else zero,
              f1 if f1 is not None else zero]
        a00 = ((fs[0] * mask64) * fs[0]).sum(dim=(1, 2))
        a01 = ((fs[0] * mask64) * fs[1]).sum(dim=(1, 2))
        a11 = ((fs[1] * mask64) * fs[1]).sum(dim=(1, 2))
        b0 = (fs[0] * b).sum(dim=(1, 2))
        b1 = (fs[1] * b).sum(dim=(1, 2))
        atas.append(torch.stack([a00, a01, a01, a11], dim=-1))
        atbs.append(torch.stack([b0, b1], dim=-1))
    return (Hm, Mv, sse_none, _unit_sum(torch.stack(atas, dim=1), geom, gt),
            _unit_sum(torch.stack(atbs, dim=1), geom, gt))


def _sse_plane(pl: LrPlane, fv, fh, xq):
    geom, gt = pl.geom, pl.gt
    mask64, uof = gt.mask, gt.unit_of
    peak = (1 << pl.bd) - 1
    wout = _wiener_traced(pl.win, fv[uof], fh[uof], pl.bd, geom)
    sse_w = _unit_sum(_masked_sse(wout, pl.org, mask64), geom, gt)
    sses = []
    for ie, (f0, f1) in enumerate(pl.parts):
        out = _sgr_project(f0, f1, pl.u, xq[uof, ie], peak)
        sses.append(_unit_sum(_masked_sse(out, pl.org, mask64), geom, gt))
    return sse_w, torch.stack(sses, dim=1)


def _apply_plane(pl: LrPlane, rtype, fv, fh, esel, xq):
    uof = pl.gt.unit_of
    peak = (1 << pl.bd) - 1
    rt = rtype[uof][:, None, None]
    wout = _wiener_traced(pl.win, fv[uof], fh[uof], pl.bd, pl.geom)
    xqp = xq[uof]
    es = esel[uof][:, None, None]
    sout = pl.d
    for ie, (f0, f1) in enumerate(pl.parts):
        sout = torch.where(es == ie, _sgr_project(f0, f1, pl.u, xqp, peak),
                           sout)
    piece = torch.where(rt == rst.RESTORE_WIENER, wout,
                        torch.where(rt == rst.RESTORE_SGRPROJ, sout, pl.d))
    return piece.reshape(-1)[pl.gt.flat_map]


# --- numpy-facing wrappers ---------------------------------------------------

def lr_stats_dev(planes):
    """Pass A: per-plane per-unit integer stats. Returns a list of
    (H [nu, K^2, K^2], M [nu, K^2], sse_none [nu], ata [nu, 6, 4],
    atb [nu, 6, 2]) numpy int64 tuples, one per plane."""
    return [tuple(t.cpu().numpy() for t in _stats_plane(pl))
            for pl in planes]


def lr_sse_dev(planes, fvs, fhs, xqs):
    """Pass B: exact candidate SSEs. fvs/fhs: per plane [nu, 7] int64 full
    Wiener taps; xqs: per plane [nu, 6, 2] decoded xq. Returns per plane
    (sse_wiener [nu], sse_sgr [nu, 6]) int64 numpy."""
    out = []
    for pl, fv, fh, xq in zip(planes, fvs, fhs, xqs):
        dev = pl.win.device
        sse_w, sse_s = _sse_plane(pl, *(const(a, dev, torch.int64)
                                        for a in (fv, fh, xq)))
        out.append((sse_w.cpu().numpy(), sse_s.cpu().numpy()))
    return out


def lr_apply_dev(recon, planes, rtypes, fvs, fhs, epsel, xqs):
    """Pass C: the final filter pass; writes the recon planes the
    operands were built from in place (numpy planes, or tensors, which
    stay on their device)."""
    for p, pl in enumerate(planes):
        dev = pl.win.device
        out = _apply_plane(pl, *(const(a, dev, torch.int64) for a in (
            rtypes[p], fvs[p], fhs[p], epsel[p], xqs[p])))
        write_plane(recon[p], out, pl.H, pl.W)
