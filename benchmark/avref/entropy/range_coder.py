"""AV1 multi-symbol range decoder (daala ``od_ec``; the AV1 spec's symbol
decoder, section 8.2) and the CDF update shared by every symbol.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
CDF_PROB_TOP = 1 << 15
WINDOW = 32  # od_ec_window bits
_WMASK = (1 << WINDOW) - 1
LOTS_OF_BITS = 0x4000


class RangeDecoder:
    """Spec-equivalent symbol decoder (AV1 spec 8.2 / daala od_ec_dec)."""

    def __init__(self, data: bytes):
        self.data = data
        self.bptr = 0
        self.dif = (1 << (WINDOW - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self) -> None:
        s = WINDOW - 9 - (self.cnt + 15)
        while s >= 0 and self.bptr < len(self.data):
            self.dif ^= self.data[self.bptr] << s
            self.cnt += 8
            s -= 8
            self.bptr += 1
        if self.bptr >= len(self.data):
            self.cnt = LOTS_OF_BITS

    def _normalize(self, dif: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & _WMASK
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()

    def decode_symbol(self, icdf: Sequence[int], nsyms: int) -> int:
        dif = self.dif
        r = self.rng
        n = nsyms - 1
        c = dif >> (WINDOW - 16)
        v = r
        ret = -1
        while True:
            ret += 1
            u = v
            v = ((r >> 8) * (int(icdf[ret]) >> EC_PROB_SHIFT)) \
                >> (7 - EC_PROB_SHIFT)
            v += EC_MIN_PROB * (n - ret)
            if c >= v:
                break
        dif -= v << (WINDOW - 16)
        self._normalize(dif, u - v)
        return ret

    def decode_bool(self, f_q15: int) -> int:
        dif = self.dif
        r = self.rng
        v = (((r >> 8) * (f_q15 >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
            + EC_MIN_PROB
        c = dif >> (WINDOW - 16)
        if c < v:
            ret = 1
            r = v
        else:
            ret = 0
            dif -= v << (WINDOW - 16)
            r = r - v
        self._normalize(dif, r)
        return ret

    def decode_literal(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bool(16384)
        return v


# --- CDF adaptation -----------------------------------------------------------

# update rate speed-up per alphabet size (AV1 spec: 1 for nsyms==2, else 2;
# expressed as libaom's nsymbs2speed table)
_NSYMBS2SPEED = (0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2)


def update_cdf(cdf: np.ndarray, val: int, nsyms: int) -> None:
    """Adapt a CDF in place after coding symbol ``val``.

    ``cdf`` has ``nsyms + 1`` entries; the last is the adaptation counter.
    Matches the normative decoder-side update (AV1 spec 8.2.5 update_cdf).
    """
    count = int(cdf[nsyms])
    rate = 3 + (count > 15) + (count > 31) + _NSYMBS2SPEED[nsyms]
    tmp = CDF_PROB_TOP
    for i in range(nsyms - 1):
        if i == val:
            tmp = 0
        cur = int(cdf[i])
        if tmp < cur:
            cdf[i] = cur - ((cur - tmp) >> rate)
        else:
            cdf[i] = cur + ((tmp - cur) >> rate)
    cdf[nsyms] = count + (count < 32)


