"""Quantization / dequantization (batched, host NumPy oracle).

Quantizer matches the reference encoder (``EbFullLoop.c:46``
quantize_b_helper_c_II with log_scale = av1_get_tx_scale; parameter derivation
``EbModeDecisionConfigurationProcess.c:417`` av1_build_quantizer). The
dequant side is normative (spec 7.13.3): ``dq = (level * q) >> tx_scale``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from benchmark.avref.entropy.cdf import default_tables
from benchmark.avref.utils.blocks import TX_HEIGHT, TX_WIDTH


def qlookup(bit_depth: int):
    t = default_tables()
    s = {8: "8", 10: "10", 12: "12"}[bit_depth]
    return t["dc_qlookup_" + s], t["ac_qlookup_" + s]


def dc_quant(qindex: int, delta: int, bit_depth: int = 8) -> int:
    dc, _ = qlookup(bit_depth)
    return int(dc[np.clip(qindex + delta, 0, 255)])


def ac_quant(qindex: int, delta: int, bit_depth: int = 8) -> int:
    _, ac = qlookup(bit_depth)
    return int(ac[np.clip(qindex + delta, 0, 255)])


def tx_scale(tx_size: int) -> int:
    """av1_get_tx_scale: 0 / 1 / 2 for <=256 / <=1024 / more pels."""
    pels = int(TX_WIDTH[tx_size]) * int(TX_HEIGHT[tx_size])
    return (pels > 256) + (pels > 1024)


def _invert_quant(d: int):
    """reference invert_quant: reciprocal in Q16 + shift."""
    t, l = d, 0
    while t > 1:
        t >>= 1
        l += 1
    m = 1 + (1 << (16 + l)) // d
    return m - (1 << 16), 1 << (16 - l)


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Per-plane quantizer vectors, index 0 = DC, 1 = AC."""
    zbin: tuple
    round: tuple
    quant: tuple
    quant_shift: tuple
    dequant: tuple
    qindex: int = 0


@functools.lru_cache(maxsize=256)
def make_quant_params(qindex: int, dc_delta: int = 0, ac_delta: int = 0,
                      bit_depth: int = 8) -> QuantParams:
    q = qindex
    dcq = dc_quant(q, dc_delta, bit_depth)
    acq = ac_quant(q, ac_delta, bit_depth)
    # get_qzbin_factor
    thresh = {8: 148, 10: 592, 12: 2368}[bit_depth]
    qzbin = 64 if q == 0 else (84 if dc_quant(q, 0, bit_depth) < thresh else 80)
    qround = 64 if q == 0 else 48
    zbin, rnd, quant, qshift, deq = [], [], [], [], []
    for qv in (dcq, acq):
        m, s = _invert_quant(qv)
        quant.append(m)
        qshift.append(s)
        zbin.append((qzbin * qv + 64) >> 7)
        rnd.append((qround * qv) >> 7)
        deq.append(qv)
    return QuantParams(tuple(zbin), tuple(rnd), tuple(quant), tuple(qshift),
                       tuple(deq), qindex)


def dequantize(qcoeff: np.ndarray, qp: QuantParams, log_scale: int):
    """Normative dequant (mirror-decoder side): [B, n] raster order."""
    n = qcoeff.shape[1]
    deq = np.full(n, qp.dequant[1], dtype=np.int64)
    deq[0] = qp.dequant[0]
    c = qcoeff.astype(np.int64)
    sign = np.where(c < 0, -1, 1)
    return (sign * ((np.abs(c) * deq[None, :]) >> log_scale)).astype(np.int32)
