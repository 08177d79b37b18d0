"""Transform-coefficient syntax reader (AV1 residual coding, spec 5.11.39;
the reference's writer is Av1WriteCoeffsTxb1D ``EbEntropyCoding.c:497-680``).
"""

from __future__ import annotations

import numpy as np

from benchmark.avref.entropy import coeff_ctx as cc
from benchmark.avref.entropy import tx_sets
from benchmark.avref.entropy.writer import SymbolReader
from benchmark.avref.utils.blocks import (DCT_DCT, TX_32X32, TX_TYPE_CLASS,
                                          TX_CLASS_2D, TX_CLASS_VERT,
                                          get_scan)


def read_tx_type(r: SymbolReader, fc, tx_size: int, intra_dir: int,
                 is_inter: bool, reduced_tx_set: bool,
                 base_qindex: int) -> int:
    if tx_sets.num_ext_tx_types(tx_size, is_inter, reduced_tx_set) <= 1 \
            or base_qindex == 0:
        return DCT_DCT
    set_type = tx_sets.ext_tx_set_type(tx_size, is_inter, reduced_tx_set)
    eset = tx_sets.ext_tx_set(tx_size, is_inter, reduced_tx_set)
    from benchmark.avref.utils.blocks import TX_SIZE_SQR
    sqr = int(TX_SIZE_SQR[tx_size])
    nsyms = tx_sets.NUM_EXT_TX_SET[set_type]
    if is_inter:
        sym = r.read_symbol(fc.inter_ext_tx[eset][sqr], nsyms)
    else:
        sym = r.read_symbol(fc.intra_ext_tx[eset][sqr][intra_dir], nsyms)
    return int(tx_sets.EXT_TX_INV[set_type][sym])


def _read_golomb(r: SymbolReader) -> int:
    length = 1
    while r.read_bit() == 0:
        length += 1
        assert length < 32
    x = 1
    for _ in range(length - 1):
        x = (x << 1) | r.read_bit()
    return x - 1


# min((mag + 1) >> 1, 4) of the nz context, mag <= 5 * 3
_NZ_CTX = tuple(min((m + 1) >> 1, 4) for m in range(16))


def read_coeffs_txb(r: SymbolReader, fc, tx_size: int, plane_type: int,
                    txb_skip_ctx: int, dc_sign_ctx: int, intra_dir: int = 0,
                    is_inter: bool = False, reduced_tx_set: bool = False,
                    base_qindex: int = 0, signal_tx_type: bool = True,
                    uv_tx_type: int = DCT_DCT):
    """Mirror-decoder side. Returns (qcoeff [h,w] raster, tx_type, cul_level).

    For chroma the tx type is derived by the caller (pass uv_tx_type).
    """
    tw, th, bwl = cc.txb_dims(tx_size)
    tsc = cc.txs_ctx(tx_size)
    all_zero = r.read_symbol(fc.txb_skip[tsc][txb_skip_ctx], 2)
    if all_zero:
        return np.zeros((th, tw), dtype=np.int32), DCT_DCT, 0

    if plane_type == 0:
        tx_type = (read_tx_type(r, fc, tx_size, intra_dir, is_inter,
                                reduced_tx_set, base_qindex)
                   if signal_tx_type else DCT_DCT)
    else:
        tx_type = uv_tx_type
    scan = get_scan(tx_size, tx_type)
    tx_class = int(TX_TYPE_CLASS[tx_type])

    ems = cc.eob_multi_size(tx_size)
    emc = 0 if tx_class == TX_CLASS_2D else 1
    eob_cdf = getattr(fc, f"eob_pt_{16 << ems}")
    eob_pt = r.read_symbol(eob_cdf[plane_type][emc], 5 + ems) + 1
    eob = int(cc.EOB_GROUP_START[eob_pt])
    bits = int(cc.EOB_OFFSET_BITS[eob_pt])
    if bits > 0:
        b0 = r.read_symbol(fc.eob_extra[tsc][plane_type][eob_pt], 2)
        extra = b0 << (bits - 1)
        for i in range(1, bits):
            extra |= r.read_bit() << (bits - 1 - i)
        eob += extra

    n = tw * th
    qcoeff = np.zeros(n, dtype=np.int64)
    # the levels in lists padded by 4 columns and 4 rows of zeros, so the
    # neighbours of coeff_ctx.nz_map_ctx_at and br_ctx_at need no bounds
    # test: ``lev`` capped at 127 (br), ``lev3`` capped at 3 (nz)
    pw = tw + 4
    lev = [0] * ((th + 4) * pw)
    lev3 = [0] * ((th + 4) * pw)
    off2d = cc.nz_map_ctx_offset_2d(tw, th).tolist() \
        if tx_class == TX_CLASS_2D else None
    vert = tx_class == TX_CLASS_VERT
    scan_l = scan.tolist()
    base_cdfs = fc.coeff_base[tsc][plane_type]
    br_cdfs = fc.coeff_br[min(tsc, TX_32X32)][plane_type]
    read = r.read_symbol
    nbase, brange, brsize = cc.NUM_BASE_LEVELS, cc.COEFF_BASE_RANGE, \
        cc.BR_CDF_SIZE
    for c in range(eob - 1, -1, -1):
        pos = scan_l[c]
        row, col = divmod(pos, tw)
        p = row * pw + col
        if c == eob - 1:
            ctx = int(cc.eob_base_ctx(np.array(c), n))
            level = read(fc.coeff_base_eob[tsc][plane_type][ctx], 3) + 1
        else:
            mag = lev3[p + 1] + lev3[p + pw]
            if off2d is not None:
                mag += lev3[p + pw + 1] + lev3[p + 2] + lev3[p + 2 * pw]
                ctx = 0 if pos == 0 else _NZ_CTX[mag] + off2d[pos]
            elif vert:
                mag += lev3[p + 2 * pw] + lev3[p + 3 * pw] + lev3[p + 4 * pw]
                ctx = _NZ_CTX[mag] + cc.SIG_COEF_CONTEXTS_2D \
                    + 5 * min(row, 2)
            else:
                mag += lev3[p + 2] + lev3[p + 3] + lev3[p + 4]
                ctx = _NZ_CTX[mag] + cc.SIG_COEF_CONTEXTS_2D \
                    + 5 * min(col, 2)
            level = read(base_cdfs[ctx], 4)
        if level > nbase:
            mag = lev[p + 1] + lev[p + pw]
            if off2d is not None:
                mag += lev[p + pw + 1]
                near = row < 2 and col < 2
            elif vert:
                mag += lev[p + 2 * pw]
                near = row == 0
            else:
                mag += lev[p + 2]
                near = col == 0
            bctx = min((mag + 1) >> 1, 6)
            if pos != 0:
                bctx += 7 if near else 14
            for _ in range(0, brange, brsize - 1):
                k = read(br_cdfs[bctx], brsize)
                level += k
                if k < brsize - 1:
                    break
        lev[p] = level if level < 127 else 127
        lev3[p] = level if level < 3 else 3
        qcoeff[pos] = level

    # signs + golomb
    cul_level = 0
    for c in range(eob):
        pos = int(scan[c])
        level = int(qcoeff[pos])
        if level:
            if c == 0:
                sign = r.read_symbol(fc.dc_sign[plane_type][dc_sign_ctx], 2)
            else:
                sign = r.read_bit()
            if level > cc.COEFF_BASE_RANGE + cc.NUM_BASE_LEVELS:
                level += _read_golomb(r)
                qcoeff[pos] = level
            cul_level += level
            if sign:
                qcoeff[pos] = -level
        # note: cul_level accumulates |level| including golomb part

    cul_level = min(cc.COEFF_CONTEXT_MASK, cul_level)
    dc = int(qcoeff[0])
    if dc < 0:
        cul_level |= 1 << cc.COEFF_CONTEXT_BITS
    elif dc > 0:
        cul_level += 2 << cc.COEFF_CONTEXT_BITS
    return qcoeff.reshape(th, tw).astype(np.int32), tx_type, cul_level
