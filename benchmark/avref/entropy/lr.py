"""Loop-restoration syntax, the reading side: the per-unit restore type
and coefficients and the finite subexponential primitives they ride
(spec 5.11.57-5.11.58 read_lr_unit, 4.10.7-4.10.10 decode_subexp).

A copy of the port's ``entropy/lr.py`` cut to what the decoder reads.
The restore-type symbol uses an adapted CDF; the coefficients are raw
equiprobable bits, each predicted from the plane's last coded unit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from benchmark.avref.ops import restoration as rst


def _inv_recenter_nonneg(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _inv_recenter_finite_nonneg(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _inv_recenter_nonneg(r, v)
    return n - 1 - _inv_recenter_nonneg(n - 1 - r, v)


def read_primitive_quniform(r, n: int) -> int:
    if n <= 1:
        return 0
    l = (n - 1).bit_length()
    m = (1 << l) - n
    v = r.read_literal(l - 1)
    if v < m:
        return v
    return (v << 1) - m + r.read_bit()


def read_primitive_subexpfin(r, n: int, k: int) -> int:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            return read_primitive_quniform(r, n - mk) + mk
        if r.read_bit():
            i += 1
            mk += a
        else:
            return r.read_literal(b) + mk


def read_primitive_refsubexpfin(r, n: int, k: int, ref: int) -> int:
    return _inv_recenter_finite_nonneg(n, ref,
                                       read_primitive_subexpfin(r, n, k))


@dataclasses.dataclass
class LrRefState:
    """Predictors for LR coefficient coding, reset per frame at the first
    SB (the spec's RefLrWiener / RefSgrXqd defaults)."""
    wiener_v: Tuple[int, int, int] = rst.WIENER_TAP_MID
    wiener_h: Tuple[int, int, int] = rst.WIENER_TAP_MID
    sgr_xqd: Tuple[int, int] = dataclasses.field(
        default_factory=rst.default_sgr_xqd)


def _wiener_taps_io(is_chroma: bool):
    """(tap_index, n, k) triples actually coded; chroma tap0 fixed at 0."""
    out = []
    for t in ((1, 2) if is_chroma else (0, 1, 2)):
        n = rst.WIENER_TAP_MAX[t] - rst.WIENER_TAP_MIN[t] + 1
        out.append((t, n, rst.WIENER_FILT_SUBEXP_K[t]))
    return out


def read_wiener(r, ref: LrRefState, is_chroma: bool):
    out = []
    for rtaps in (ref.wiener_v, ref.wiener_h):
        taps = [0, 0, 0]
        for t, n, k in _wiener_taps_io(is_chroma):
            taps[t] = read_primitive_refsubexpfin(
                r, n, k, rtaps[t] - rst.WIENER_TAP_MIN[t]) \
                + rst.WIENER_TAP_MIN[t]
        out.append(tuple(taps))
    ref.wiener_v, ref.wiener_h = out[0], out[1]
    return out[0], out[1]


def read_sgrproj(r, ref: LrRefState):
    ep = r.read_literal(rst.SGRPROJ_PARAMS_BITS)
    r0, r1 = rst.SGR_PARAMS[ep][0]
    xqd = list(ref.sgr_xqd)
    if r0 == 0:
        xqd[0] = 0
        xqd[1] = read_primitive_refsubexpfin(
            r, rst.SGRPROJ_PRJ_MAX1 - rst.SGRPROJ_PRJ_MIN1 + 1,
            rst.SGRPROJ_PRJ_SUBEXP_K,
            ref.sgr_xqd[1] - rst.SGRPROJ_PRJ_MIN1) + rst.SGRPROJ_PRJ_MIN1
    elif r1 == 0:
        xqd[0] = read_primitive_refsubexpfin(
            r, rst.SGRPROJ_PRJ_MAX0 - rst.SGRPROJ_PRJ_MIN0 + 1,
            rst.SGRPROJ_PRJ_SUBEXP_K,
            ref.sgr_xqd[0] - rst.SGRPROJ_PRJ_MIN0) + rst.SGRPROJ_PRJ_MIN0
        xqd[1] = 0
    else:
        xqd[0] = read_primitive_refsubexpfin(
            r, rst.SGRPROJ_PRJ_MAX0 - rst.SGRPROJ_PRJ_MIN0 + 1,
            rst.SGRPROJ_PRJ_SUBEXP_K,
            ref.sgr_xqd[0] - rst.SGRPROJ_PRJ_MIN0) + rst.SGRPROJ_PRJ_MIN0
        xqd[1] = read_primitive_refsubexpfin(
            r, rst.SGRPROJ_PRJ_MAX1 - rst.SGRPROJ_PRJ_MIN1 + 1,
            rst.SGRPROJ_PRJ_SUBEXP_K,
            ref.sgr_xqd[1] - rst.SGRPROJ_PRJ_MIN1) + rst.SGRPROJ_PRJ_MIN1
    ref.sgr_xqd = tuple(xqd)
    return ep, tuple(xqd)


def read_lr_unit(r, fc, frame_rtype: int, ref: LrRefState,
                 is_chroma: bool):
    rui = rst.RestorationUnitInfo()
    if frame_rtype == rst.RESTORE_SWITCHABLE:
        t = r.read_symbol(fc.switchable_restore, rst.RESTORE_SWITCHABLE_TYPES)
        rui.restoration_type = t
        if t == rst.RESTORE_WIENER:
            rui.wiener_v, rui.wiener_h = read_wiener(r, ref, is_chroma)
        elif t == rst.RESTORE_SGRPROJ:
            rui.sgr_ep, rui.sgr_xqd = read_sgrproj(r, ref)
    elif frame_rtype == rst.RESTORE_WIENER:
        if r.read_symbol(fc.wiener_restore, 2):
            rui.restoration_type = rst.RESTORE_WIENER
            rui.wiener_v, rui.wiener_h = read_wiener(r, ref, is_chroma)
    elif frame_rtype == rst.RESTORE_SGRPROJ:
        if r.read_symbol(fc.sgrproj_restore, 2):
            rui.restoration_type = rst.RESTORE_SGRPROJ
            rui.sgr_ep, rui.sgr_xqd = read_sgrproj(r, ref)
    return rui
