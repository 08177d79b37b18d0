"""Loop-restoration parameter search (encoder side) on the torch device.

The port of the JAX package's ``pipeline/lr_search.py`` device path
(``search_restoration_dev``): per restoration unit, the integer statistics
and the exact candidate SSEs come from the device passes of
``ops/device_lr.py``; between them the host fits Wiener taps by
alternating separable least squares and SGR projections by 2x2 least
squares over an ep sweep, scores NONE / WIENER / SGRPROJ and picks each
plane's frame restoration type by total RD. The solves and the decision
are NumPy float64, line for line the JAX package's: the same integers in
give the same taps, the same choice and the same stream.

Deviations from the reference (encoder-side only; any choice emits a
conformant stream): tap rates are counted against the frame-default
predictor rather than the running ref, and the ep sweep uses a fixed
subset refined by exact evaluation.

Reference: search_wiener_unit / search_sgrproj_unit / restoration_search
(``EbRestorationPick.c:1100-1500``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from svt_av1_tpu_torch.entropy import lr as lr_syntax
from svt_av1_tpu_torch.entropy.cdf import FrameContext
from svt_av1_tpu_torch.ops import device_lr as dlr
from svt_av1_tpu_torch.ops import restoration as rst


def _cdf_bits(icdf: np.ndarray, s: int, nsyms: int) -> float:
    hi = 32768 if s == 0 else int(icdf[s - 1])
    p = max(hi - int(icdf[s]), 1)
    return float(np.log2(32768.0 / p))


def _dir_solve(Hh, Mh, hw: int):
    """One direction of the separable fit from projected stats: solve the
    symmetric-tap normal equations (cols = pair_j - 2*base, tgt = org -
    base; pair_j = z[m-j] + z[m+j], base = z[m])."""
    m = hw
    js = list(range(hw, 0, -1))
    P = np.array([[Hh[m - a, m - b] + Hh[m - a, m + b]
                   + Hh[m + a, m - b] + Hh[m + a, m + b] for b in js]
                  for a in js])
    pb = np.array([Hh[m - a, m] + Hh[m + a, m] for a in js])
    bb = Hh[m, m]
    G = P - 2 * pb[:, None] - 2 * pb[None, :] + 4 * bb
    po = np.array([Mh[m - a] + Mh[m + a] for a in js])
    r = (po - pb) - 2 * (Mh[m] - bb)
    try:
        return np.linalg.solve(G + np.eye(len(js)) * 1e-6, r)
    except np.linalg.LinAlgError:
        return np.zeros(len(js))


def _solve_wiener_from_stats(Hm, Mv, K: int):
    """Alternating separable solve in the normalized-tap domain, from the
    exact unit stats (wiener_decompose_sep_sym analogue). Returns
    quantized 3-tap tuples (tap0 = 0 for the 5-tap chroma window)."""
    hw = K // 2
    H4 = Hm.reshape(K, K, K, K)   # [vi, hi, vj, hj]
    M2 = Mv.reshape(K, K)
    lo = 3 - hw                    # leading zero taps for chroma

    def full(g):
        f = np.zeros(K)
        for i, j in enumerate(range(hw, 0, -1)):
            f[hw - j] = f[hw + j] = g[i]
        f[hw] = 1 - 2 * g.sum()
        return f

    mid = np.array(rst.WIENER_TAP_MID, dtype=np.float64)[lo:] / 128.0
    gv = mid.copy()
    gh = mid.copy()
    for _ in range(3):
        fh = full(gh)
        gv = _dir_solve(np.einsum("abcd,b,d->ac", H4, fh, fh), M2 @ fh,
                        hw)
        fv = full(gv)
        gh = _dir_solve(np.einsum("abcd,a,c->bd", H4, fv, fv), fv @ M2,
                        hw)
    out = []
    for g in (gv, gh):
        g3 = np.zeros(3)
        g3[lo:] = g
        t = [int(np.clip(round(g3[i] * 128),
                         rst.WIENER_TAP_MIN[i], rst.WIENER_TAP_MAX[i]))
             for i in range(3)]
        if lo:
            t[0] = 0
        out.append(tuple(t))
    return out[0], out[1]


def _solve_sgr_xqd(ata, atb, ep: int):
    """Quantized xqd from exact projection stats (identical rounding to
    the reference's get_proj_subspace + quantization path)."""
    r, _s = rst.SGR_PARAMS[ep]
    keep = [i for i in range(2) if r[i] > 0]
    A = ata[np.ix_(keep, keep)].astype(np.float64)
    bvec = atb[keep].astype(np.float64)
    try:
        xq = np.linalg.solve(A + np.eye(len(keep)) * 1e-9, bvec)
    except np.linalg.LinAlgError:
        xq = np.zeros(len(keep))
    if r[0] == 0:
        xq1 = int(round(xq[0]))
        xqd1 = int(np.clip((1 << rst.SGRPROJ_PRJ_BITS) - xq1,
                           rst.SGRPROJ_PRJ_MIN1, rst.SGRPROJ_PRJ_MAX1))
        return (0, xqd1)
    if r[1] == 0:
        xqd0 = int(np.clip(round(xq[0]),
                           rst.SGRPROJ_PRJ_MIN0, rst.SGRPROJ_PRJ_MAX0))
        return (xqd0, 0)
    xqd0 = int(np.clip(round(xq[0]),
                       rst.SGRPROJ_PRJ_MIN0, rst.SGRPROJ_PRJ_MAX0))
    xqd1 = int(np.clip((1 << rst.SGRPROJ_PRJ_BITS) - xqd0 - round(xq[1]),
                       rst.SGRPROJ_PRJ_MIN1, rst.SGRPROJ_PRJ_MAX1))
    return (xqd0, xqd1)


def _decide_plane(per_unit, fc, lam: float, size: int, hn: int, vn: int):
    """Frame-type decision by unit totals (the JAX package's host and
    device searches share it: the same integers give the same choice)."""
    b_sw = [_cdf_bits(fc.switchable_restore, t, 3) for t in range(3)]
    b_w = [_cdf_bits(fc.wiener_restore, t, 2) for t in range(2)]
    b_s = [_cdf_bits(fc.sgrproj_restore, t, 2) for t in range(2)]
    tot = {rst.RESTORE_NONE: 0.0, rst.RESTORE_WIENER: 0.0,
           rst.RESTORE_SGRPROJ: 0.0, rst.RESTORE_SWITCHABLE: 0.0}
    choice = {rst.RESTORE_WIENER: [], rst.RESTORE_SGRPROJ: [],
              rst.RESTORE_SWITCHABLE: []}
    for sse_none, (sse_w, bits_w, rui_w), (sse_s, bits_s, rui_s) \
            in per_unit:
        tot[rst.RESTORE_NONE] += sse_none
        cn = sse_none + lam * b_w[0]
        cw = sse_w + lam * (b_w[1] + bits_w)
        if cw < cn:
            tot[rst.RESTORE_WIENER] += cw
            choice[rst.RESTORE_WIENER].append(rui_w)
        else:
            tot[rst.RESTORE_WIENER] += cn
            choice[rst.RESTORE_WIENER].append(
                rst.RestorationUnitInfo(rst.RESTORE_NONE))
        cn = sse_none + lam * b_s[0]
        cs = sse_s + lam * (b_s[1] + bits_s)
        if cs < cn:
            tot[rst.RESTORE_SGRPROJ] += cs
            choice[rst.RESTORE_SGRPROJ].append(rui_s)
        else:
            tot[rst.RESTORE_SGRPROJ] += cn
            choice[rst.RESTORE_SGRPROJ].append(
                rst.RestorationUnitInfo(rst.RESTORE_NONE))
        cands = [(sse_none + lam * b_sw[rst.RESTORE_NONE],
                  rst.RestorationUnitInfo(rst.RESTORE_NONE)),
                 (sse_w + lam * (b_sw[rst.RESTORE_WIENER] + bits_w),
                  rui_w),
                 (sse_s + lam * (b_sw[rst.RESTORE_SGRPROJ] + bits_s),
                  rui_s)]
        c, rui = min(cands, key=lambda t: t[0])
        tot[rst.RESTORE_SWITCHABLE] += c
        choice[rst.RESTORE_SWITCHABLE].append(rui)
    ftype = min(tot, key=tot.get)
    ri = rst.RestorationInfo(frame_restoration_type=ftype,
                             unit_size=size, hunits=hn, vunits=vn)
    if ftype != rst.RESTORE_NONE:
        ri.units = choice[ftype]
    return ri


def search_restoration_dev(recon, src, bounds, width: int, height: int,
                           bd: int, base_q_idx: int, lam: float,
                           device="cuda") -> List[rst.RestorationInfo]:
    """Search + apply: the stats and exact SSEs come from the device
    passes of ``ops/device_lr.py`` on ``device``; the solves and the RD
    decision run here. recon: post-CDEF padded planes (numpy, or tensors
    on their device), filtered in place; src: padded source; bounds: per
    plane the saved deblock boundary lines. Returns one RestorationInfo
    per plane (units populated for non-NONE types)."""
    fc = FrameContext(base_q_idx)
    planes = dlr.lr_planes(recon, src, bounds, width, height, bd, device)
    stats = dlr.lr_stats_dev(planes)
    fvs, fhs, xqs = [], [], []
    plane_fit = []
    for pl, (Hm, Mv, sse_none, ata, atb) in zip(planes, stats):
        nu = Hm.shape[0]
        taps, eps_xqd = [], []
        fv = np.zeros((nu, 7), dtype=np.int64)
        fh = np.zeros((nu, 7), dtype=np.int64)
        xq = np.zeros((nu, len(dlr.EP_SWEEP), 2), dtype=np.int64)
        for u in range(nu):
            tv, th = _solve_wiener_from_stats(
                Hm[u].astype(np.float64), Mv[u].astype(np.float64), pl.K)
            taps.append((tv, th))
            fv[u] = rst.wiener_taps7(tv)
            fh[u] = rst.wiener_taps7(th)
            row = []
            for ie, ep in enumerate(dlr.EP_SWEEP):
                xqd = _solve_sgr_xqd(ata[u, ie].reshape(2, 2),
                                     atb[u, ie], ep)
                row.append(xqd)
                xq[u, ie] = rst.decode_xq(xqd, ep)
            eps_xqd.append(row)
        plane_fit.append((sse_none, taps, eps_xqd))
        fvs.append(fv)
        fhs.append(fh)
        xqs.append(xq)
    sses = dlr.lr_sse_dev(planes, fvs, fhs, xqs)
    out = []
    rtypes, epsel, xq_sel = [], [], []
    for p, pl in enumerate(planes):
        sse_none, taps, eps_xqd = plane_fit[p]
        sse_w, sse_sgr = sses[p]
        nu = len(taps)
        per_unit = []
        for u in range(nu):
            tv, th = taps[u]
            rui_w = rst.RestorationUnitInfo(rst.RESTORE_WIENER, tv, th)
            bits_w = lr_syntax.count_wiener(tv, th,
                                            lr_syntax.LrRefState(),
                                            p > 0)
            ie = int(np.argmin(sse_sgr[u]))
            rui_s = rst.RestorationUnitInfo(
                rst.RESTORE_SGRPROJ, sgr_ep=dlr.EP_SWEEP[ie],
                sgr_xqd=eps_xqd[u][ie])
            bits_s = lr_syntax.count_sgrproj(rui_s.sgr_ep, rui_s.sgr_xqd,
                                             lr_syntax.LrRefState())
            per_unit.append((float(sse_none[u]),
                             (float(sse_w[u]), bits_w, rui_w),
                             (float(sse_sgr[u, ie]), bits_s, rui_s)))
        ri = _decide_plane(per_unit, fc, lam, pl.size, pl.geom.hn,
                           pl.geom.vn)
        out.append(ri)
        rt = np.zeros(nu, dtype=np.int64)
        es = np.zeros(nu, dtype=np.int64)
        xs = np.zeros((nu, 2), dtype=np.int64)
        if ri.frame_restoration_type != rst.RESTORE_NONE:
            for u, rui in enumerate(ri.units):
                rt[u] = rui.restoration_type
                if rui.restoration_type == rst.RESTORE_SGRPROJ:
                    es[u] = dlr.EP_SWEEP.index(rui.sgr_ep)
                    xs[u] = rst.decode_xq(rui.sgr_xqd, rui.sgr_ep)
                elif rui.restoration_type == rst.RESTORE_WIENER:
                    fvs[p][u] = rst.wiener_taps7(rui.wiener_v)
                    fhs[p][u] = rst.wiener_taps7(rui.wiener_h)
        rtypes.append(rt)
        epsel.append(es)
        xq_sel.append(xs)
    if any(ri.frame_restoration_type != rst.RESTORE_NONE for ri in out):
        dlr.lr_apply_dev(recon, planes, rtypes, fvs, fhs, epsel, xq_sel)
    return out
