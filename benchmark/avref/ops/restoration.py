"""Loop restoration, the decoder's filter (spec 7.17): Wiener and
self-guided (SGR) filters over 64-row stripes, with the unit geometry
and the saved deblocked boundary lines.

A copy of the port's ``ops/restoration.py`` with its loop over units and
stripes cut to one over the columns of units: the stripes of a column's
units that take one filter are filtered in one batch, each with its
unit's coefficients. A stripe lies inside one row of units (units start
on stripe boundaries), so each stripe gets the window the unit-by-unit
filter gives it. The same integers in give the same samples out.

Structure (spec 7.17.2; reference ``EbRestoration.c:320-363``):
- the frame is processed in 64-px (luma) stripes offset upward by 8, so
  the first stripe is 56 rows; chroma 4:2:0 uses 32/28 with offset 4;
- across interior stripe boundaries the filter context is NOT the
  post-CDEF neighbour rows: 2 saved *deblocked* (pre-CDEF) rows are
  duplicated into the 3 border rows ([a0,a0,a1] above, [b0,b1,b1]
  below); frame top/bottom and left/right use edge replication;
- restoration units are ``unit_size`` squares; the last column/row unit
  extends up to 1.5x (foreach_rest_unit_in_tile :1345).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

# --- constants (reference EbRestoration.h:35-161) ----------------------------
RESTORE_NONE = 0
RESTORE_WIENER = 1
RESTORE_SGRPROJ = 2
RESTORE_SWITCHABLE = 3
RESTORE_SWITCHABLE_TYPES = 3

RESTORATION_UNIT_OFFSET = 8
RESTORATION_PROC_UNIT_SIZE = 64

WIENER_FILT_PREC_BITS = 7
# tap midpoints and coded ranges (EbRestoration.h:135-161)
WIENER_TAP_MID = (3, -7, 15)
WIENER_TAP_BITS = (4, 5, 6)
WIENER_TAP_MIN = tuple(m - (1 << b) // 2
                       for m, b in zip(WIENER_TAP_MID, WIENER_TAP_BITS))
WIENER_TAP_MAX = tuple(m - 1 + (1 << b) // 2
                       for m, b in zip(WIENER_TAP_MID, WIENER_TAP_BITS))
WIENER_FILT_SUBEXP_K = (1, 2, 3)  # TAP0/1/2_SUBEXP_K

SGRPROJ_PARAMS_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_RST_BITS = 4
SGRPROJ_SGR_BITS = 8
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12
SGRPROJ_PRJ_MIN0 = -(1 << SGRPROJ_PRJ_BITS) * 3 // 4      # -96
SGRPROJ_PRJ_MAX0 = SGRPROJ_PRJ_MIN0 + (1 << SGRPROJ_PRJ_BITS) - 1  # 31
SGRPROJ_PRJ_MIN1 = -(1 << SGRPROJ_PRJ_BITS) // 4          # -32
SGRPROJ_PRJ_MAX1 = SGRPROJ_PRJ_MIN1 + (1 << SGRPROJ_PRJ_BITS) - 1  # 95
SGRPROJ_PRJ_SUBEXP_K = 4

# (r0, r1), (s0, s1) per ep (reference EbRestoration.c:167)
SGR_PARAMS = (
    ((2, 1), (140, 3236)), ((2, 1), (112, 2158)), ((2, 1), (93, 1618)),
    ((2, 1), (80, 1438)), ((2, 1), (70, 1295)), ((2, 1), (58, 1177)),
    ((2, 1), (47, 1079)), ((2, 1), (37, 996)), ((2, 1), (30, 925)),
    ((2, 1), (25, 863)), ((0, 1), (-1, 2589)), ((0, 1), (-1, 1618)),
    ((0, 1), (-1, 1177)), ((0, 1), (-1, 925)), ((2, 0), (56, -1)),
    ((2, 0), (22, -1)),
)

# x -> round(256*x/(x+1)) with two normative fixups: [0] = 1 (so the
# blend never fully discards the pixel) and [255] = 256 (reference :755)
_X_BY_XPLUS1 = np.array([round(256 * x / (x + 1)) for x in range(256)],
                        dtype=np.int64)
_X_BY_XPLUS1[0] = 1
_X_BY_XPLUS1[255] = 256

# round(2^12 / n) for n = 1..25 (reference :775)
_ONE_BY_X = np.array([4096, 2048, 1365, 1024, 819, 683, 585, 512, 455, 410,
                      372, 341, 315, 293, 273, 256, 241, 228, 216, 205, 195,
                      186, 178, 171, 164], dtype=np.int64)


def _round2(x, n):
    """ROUND_POWER_OF_TWO for (possibly negative) ints/arrays."""
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


@dataclasses.dataclass
class RestorationUnitInfo:
    """Per-unit filter choice (reference RestorationUnitInfo)."""
    restoration_type: int = RESTORE_NONE
    # Wiener: 3 coded taps per direction (tap3 derived); chroma tap0 == 0
    wiener_v: Tuple[int, int, int] = WIENER_TAP_MID
    wiener_h: Tuple[int, int, int] = WIENER_TAP_MID
    # SGR: ep index + coded projection pair
    sgr_ep: int = 0
    sgr_xqd: Tuple[int, int] = (0, 0)


def default_sgr_xqd() -> Tuple[int, int]:
    """set_default_sgrproj (EbRestoration.h:243)."""
    return ((SGRPROJ_PRJ_MIN0 + SGRPROJ_PRJ_MAX0) // 2,
            (SGRPROJ_PRJ_MIN1 + SGRPROJ_PRJ_MAX1) // 2)


@dataclasses.dataclass
class RestorationInfo:
    """Per-plane frame restoration state."""
    frame_restoration_type: int = RESTORE_NONE
    unit_size: int = 256            # plane-resolution unit size
    units: List[RestorationUnitInfo] = dataclasses.field(default_factory=list)
    hunits: int = 0
    vunits: int = 0


# --- unit geometry (reference :199-204, :1330-1390) --------------------------

def count_units(size: int, dim: int) -> int:
    return max((dim + (size >> 1)) // size, 1)


def _unit_spans(n: int, size: int):
    """[start, end) of each unit along one dimension of ``n`` samples."""
    ext = size * 3 // 2
    out = []
    x0 = 0
    while x0 < n:
        rem = n - x0
        w = rem if rem < ext else size
        out.append((x0, x0 + w))
        x0 += w
    return out


def unit_limits(W: int, H: int, size: int, ss_y: int):
    """Rectangles [v0,v1,h0,h1) of every restoration unit in raster order,
    with the 8-px upward stripe offset applied to rows
    (foreach_rest_unit_in_tile, reference :1345-1390)."""
    voff = RESTORATION_UNIT_OFFSET >> ss_y
    rows = []
    for v0, v1 in _unit_spans(H, size):
        rows.append((max(0, v0 - voff), v1 - voff if v1 < H else v1))
    cols = _unit_spans(W, size)
    out = [(v0, v1, h0, h1) for (v0, v1) in rows for (h0, h1) in cols]
    return out, len(cols), len(rows)


def units_in_sb(mi_row: int, mi_col: int, sb_mi: int, plane_W: int,
                plane_H: int, size: int, ss_x: int, ss_y: int):
    """Restoration-unit index ranges whose syntax is coded at this SB
    (av1_loop_restoration_corners_in_sb, reference :1818)."""
    hunits = count_units(size, plane_W)
    vunits = count_units(size, plane_H)
    mi_sz_x = 4 >> ss_x
    mi_sz_y = 4 >> ss_y
    rcol0 = (mi_col * mi_sz_x + size - 1) // size
    rrow0 = (mi_row * mi_sz_y + size - 1) // size
    rcol1 = min(((mi_col + sb_mi) * mi_sz_x + size - 1) // size, hunits)
    rrow1 = min(((mi_row + sb_mi) * mi_sz_y + size - 1) // size, vunits)
    if rcol0 >= rcol1 or rrow0 >= rrow1:
        return []
    return [r * hunits + c for r in range(rrow0, rrow1)
            for c in range(rcol0, rcol1)]


# --- boundary lines (reference save_tile_row_boundary_lines :1691) -----------

def _stripes(H: int, ss_y: int):
    """[y0, y1) of every stripe of a plane of ``H`` rows."""
    stripe_h = RESTORATION_PROC_UNIT_SIZE >> ss_y
    off = RESTORATION_UNIT_OFFSET >> ss_y
    out = []
    s = 0
    while max(0, s * stripe_h - off) < H:
        out.append((max(0, s * stripe_h - off),
                    min((s + 1) * stripe_h - off, H)))
        s += 1
    return out


def save_deblock_boundary_lines(plane: np.ndarray, H: int, ss_y: int):
    """2 deblocked rows above/below every interior stripe boundary.

    Returns {stripe_index: (above2 [2,W] or None, below2 [2,W] or None)}."""
    out = {}
    for s, (y0, y1) in enumerate(_stripes(H, ss_y)):
        above = plane[y0 - 2:y0].copy() if s > 0 else None
        below = plane[y1:y1 + 2].copy() if y1 < H else None
        out[s] = (above, below)
    return out


# --- filters over a batch of stripes ----------------------------------------
# Shapes: ``x`` [S, h+6, w+6] int64 (each stripe of one column of units
# with its 3 border rows and 3 columns a side), coefficients [S, 1, 1].

def wiener_taps7(t: Tuple[int, int, int]) -> np.ndarray:
    """3 coded taps -> full 7-tap kernel with derived center
    (spec 7.17.1; sum == 128 including the add-src 128)."""
    t0, t1, t2 = t
    return np.array([t0, t1, t2, 128 - 2 * (t0 + t1 + t2), t2, t1, t0],
                    dtype=np.int64)


def _wiener(x: np.ndarray, fv: np.ndarray, fh: np.ndarray,
            bd: int) -> np.ndarray:
    """7-tap separable Wiener with per-stripe taps ``fv``/``fh``
    [7, S, 1, 1] (av1_wiener_convolve_add_src_c, convolve.c:115:
    horizontal pass with round0 and intermediate clamp, vertical pass
    with round1)."""
    r0 = 3 if bd < 12 else 5
    r1 = 2 * WIENER_FILT_PREC_BITS - r0
    h = x.shape[1] - 6
    w = x.shape[2] - 6
    hsum = np.zeros((x.shape[0], h + 6, w), dtype=np.int64)
    for k in range(7):
        hsum += fh[k] * x[:, :, k:k + w]
    hsum += 1 << (bd + WIENER_FILT_PREC_BITS - 1)
    mid = np.clip(_round2(hsum, r0), 0,
                  (1 << (bd + 1 + WIENER_FILT_PREC_BITS - r0)) - 1)
    vsum = np.zeros((x.shape[0], h, w), dtype=np.int64)
    for k in range(7):
        vsum += fv[k] * mid[:, k:k + h]
    vsum -= 1 << (bd + r1 - 1)
    return np.clip(_round2(vsum, r1), 0, (1 << bd) - 1)


def _winsum(x: np.ndarray, r: int) -> np.ndarray:
    """(2r+1)x(2r+1) full-window sums over axes 1 and 2; output reduced by
    2r per axis."""
    n = 2 * r + 1
    v = x.cumsum(1)
    v = np.concatenate([v[:, n - 1:n], v[:, n:] - v[:, :-n]], axis=1)
    hsum = v.cumsum(2)
    return np.concatenate([hsum[:, :, n - 1:n],
                           hsum[:, :, n:] - hsum[:, :, :-n]], axis=2)


def _sgr_ab(x: np.ndarray, r: int, s: np.ndarray, bd: int):
    """A/B grids on rows/cols [-1, h] x [-1, w] of each stripe's interior
    (selfguided_restoration_internal, reference :906-1005)."""
    h, w = x.shape[1] - 6, x.shape[2] - 6
    i0 = 2 - r          # offset of the centre (-1, -1) window
    a = _winsum(x * x, r)[:, i0:i0 + h + 2, i0:i0 + w + 2]
    b = _winsum(x, r)[:, i0:i0 + h + 2, i0:i0 + w + 2]
    n = (2 * r + 1) * (2 * r + 1)
    p = np.maximum(_round2(a, 2 * (bd - 8)) * n
                   - _round2(b, bd - 8) ** 2, 0)
    A = _X_BY_XPLUS1[np.minimum(_round2(p * s, SGRPROJ_MTABLE_BITS), 255)]
    B = _round2((256 - A) * b * _ONE_BY_X[n - 1], SGRPROJ_RECIP_BITS)
    return A, B


def _sgr_full(x: np.ndarray, s: np.ndarray, bd: int) -> np.ndarray:
    """Radius-1 box filter on every row (reference :906, :1005-1022)."""
    h, w = x.shape[1] - 6, x.shape[2] - 6
    A, B = _sgr_ab(x, 1, s, bd)
    d = x[:, 3:3 + h, 3:3 + w]
    c, m = slice(1, h + 1), slice(1, w + 1)
    up, dn, lf, rt = slice(0, h), slice(2, h + 2), slice(0, w), \
        slice(2, w + 2)

    def mix(G):
        return (G[:, c, m] + G[:, c, lf] + G[:, c, rt] + G[:, up, m]
                + G[:, dn, m]) * 4 + (G[:, up, lf] + G[:, up, rt]
                                      + G[:, dn, lf] + G[:, dn, rt]) * 3
    return _round2(mix(A) * d + mix(B),
                   SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)


def _sgr_fast(x: np.ndarray, s: np.ndarray, bd: int) -> np.ndarray:
    """Radius-2 box filter computed on odd rows only (reference :776-905):
    even output rows blend the grid rows above and below."""
    h, w = x.shape[1] - 6, x.shape[2] - 6
    A, B = _sgr_ab(x, 2, s, bd)
    d = x[:, 3:3 + h, 3:3 + w]
    out = np.zeros(d.shape, dtype=np.int64)
    m, lf, rt = slice(1, w + 1), slice(0, w), slice(2, w + 2)
    ev = slice(0, h, 2)
    ev2 = slice(2, h + 2, 2)
    od = slice(2, h + 1, 2)

    def even(G):
        return (G[:, ev, m] + G[:, ev2, m]) * 6 + \
            (G[:, ev, lf] + G[:, ev, rt] + G[:, ev2, lf]
             + G[:, ev2, rt]) * 5

    def odd(G):
        return G[:, od, m] * 6 + (G[:, od, lf] + G[:, od, rt]) * 5
    out[:, 0::2] = _round2(even(A) * d[:, 0::2] + even(B),
                           SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
    out[:, 1::2] = _round2(odd(A) * d[:, 1::2] + odd(B),
                           SGRPROJ_SGR_BITS + 4 - SGRPROJ_RST_BITS)
    return out


def decode_xq(xqd, ep) -> Tuple[int, int]:
    """reference decode_xq (:741)."""
    r = SGR_PARAMS[ep][0]
    if r[0] == 0:
        return 0, (1 << SGRPROJ_PRJ_BITS) - xqd[1]
    if r[1] == 0:
        return xqd[0], 0
    return xqd[0], (1 << SGRPROJ_PRJ_BITS) - xqd[0] - xqd[1]


def _sgr(x: np.ndarray, par: dict, bd: int) -> np.ndarray:
    """Self-guided restoration (apply_selfguided_restoration_c, reference
    :1040) with per-stripe parameters; a pass whose projection weight is
    0 in every stripe is skipped (its term is then 0)."""
    h, w = x.shape[1] - 6, x.shape[2] - 6
    u = x[:, 3:3 + h, 3:3 + w] << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    if np.any(par["xq0"]):
        v = v + par["xq0"] * (_sgr_fast(x, par["s0"], bd) - u)
    if np.any(par["xq1"]):
        v = v + par["xq1"] * (_sgr_full(x, par["s1"], bd) - u)
    return np.clip(_round2(v, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS), 0,
                   (1 << bd) - 1)


# --- the frame ---------------------------------------------------------------

def _unit_params(ri: RestorationInfo, n: int) -> dict:
    """Per-unit coefficient arrays [n] in raster order."""
    par = {k: np.zeros(n, dtype=np.int64)
           for k in ("type", "s0", "s1", "xq0", "xq1")}
    par["fv"] = np.zeros((7, n), dtype=np.int64)
    par["fh"] = np.zeros((7, n), dtype=np.int64)
    for i, rui in enumerate(ri.units):
        t = rui.restoration_type
        par["type"][i] = t
        if t == RESTORE_WIENER:
            par["fv"][:, i] = wiener_taps7(rui.wiener_v)
            par["fh"][:, i] = wiener_taps7(rui.wiener_h)
        elif t == RESTORE_SGRPROJ:
            (r0, r1), (s0, s1) = SGR_PARAMS[rui.sgr_ep]
            xq0, xq1 = decode_xq(rui.sgr_xqd, rui.sgr_ep)
            par["s0"][i], par["xq0"][i] = (s0, xq0) if r0 else (0, 0)
            par["s1"][i], par["xq1"][i] = (s1, xq1) if r1 else (0, 0)
    return par


def _stripe_rows(plane: np.ndarray, bounds: dict, s: int, y0: int, y1: int,
                 rows: int) -> np.ndarray:
    """A stripe's ``rows`` + 6 input rows: the saved deblocked lines (or
    the replicated frame edge) around its post-CDEF rows, the last row
    repeated below a stripe shorter than ``rows``
    (setup_processing_stripe_boundary, reference :378)."""
    H = plane.shape[0]
    if y0 == 0:
        top = [plane[0:1]] * 3
    else:
        a = bounds[s][0]
        top = [a[0:1], a[0:1], a[1:2]]
    if y1 >= H:
        bot = [plane[H - 1:H]] * 3
    else:
        b = bounds[s][1]
        bot = [b[0:1], b[1:2], b[1:2]]
    win = np.concatenate(top + [plane[y0:y1]] + bot, axis=0)
    short = rows - (y1 - y0)
    if short:
        win = np.concatenate([win] + [win[-1:]] * short, axis=0)
    return win


def loop_restoration_filter_frame(planes: List[np.ndarray],
                                  rinfos: List[RestorationInfo],
                                  bounds: List[dict], width: int,
                                  height: int, bd: int) -> None:
    """Apply LR in place to the cropped-resolution region of each plane
    (av1_loop_restoration_filter_frame, reference :1283): per column of
    units, the stripes of its units of each kind in one batch."""
    for p in range(3):
        ri = rinfos[p]
        if ri.frame_restoration_type == RESTORE_NONE:
            continue
        ss = 1 if p else 0
        W = (width + ss) >> ss
        H = (height + ss) >> ss
        plane = planes[p][:H, :W].astype(np.int64)
        lims, hn, vn = unit_limits(W, H, ri.unit_size, ss)
        assert len(ri.units) == len(lims), (len(ri.units), len(lims))
        par = _unit_params(ri, len(lims))
        if not np.any(par["type"]):
            continue
        # the unit row of each stripe: units start on stripe boundaries
        row_v = [lims[r * hn][:2] for r in range(vn)]
        stripes = _stripes(H, ss)
        urow = []
        for y0, y1 in stripes:
            r = [i for i, (v0, v1) in enumerate(row_v) if v0 <= y0 < v1]
            assert len(r) == 1 and y1 <= row_v[r[0]][1], (y0, y1, row_v)
            urow.append(r[0])
        urow = np.array(urow)
        rows = RESTORATION_PROC_UNIT_SIZE >> ss
        x = np.stack([_stripe_rows(plane, bounds[p], s, y0, y1, rows)
                      for s, (y0, y1) in enumerate(stripes)])
        x = np.pad(x, ((0, 0), (0, 0), (3, 3)), mode="edge")
        out = x[:, 3:3 + rows, 3:-3].copy()
        for j, (_, _, h0, h1) in enumerate(lims[:hn]):
            unit = urow * hn + j
            kind = par["type"][unit]
            for t in (RESTORE_WIENER, RESTORE_SGRPROJ):
                sel = np.nonzero(kind == t)[0]
                if not len(sel):
                    continue
                xs = x[sel, :, h0:h1 + 6]
                u = unit[sel][:, None, None]
                if t == RESTORE_WIENER:
                    got = _wiener(xs, par["fv"][:, u], par["fh"][:, u], bd)
                else:
                    got = _sgr(xs, {k: par[k][u]
                                    for k in ("s0", "s1", "xq0", "xq1")},
                               bd)
                out[sel, :, h0:h1] = got
        dst = plane.copy()
        for s, (y0, y1) in enumerate(stripes):
            dst[y0:y1] = out[s, :y1 - y0]
        planes[p][:H, :W] = dst.astype(planes[p].dtype)
