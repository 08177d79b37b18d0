"""Symbol reader: the range decoder plus CDF adaptation (aom_read_symbol
semantics: the CDF is updated after each symbol unless updates are
disabled).
"""

from __future__ import annotations

import numpy as np

from benchmark.avref.entropy.range_coder import (CDF_PROB_TOP, EC_MIN_PROB,
                                                 EC_PROB_SHIFT, WINDOW,
                                                 _NSYMBS2SPEED, _WMASK,
                                                 update_cdf)


class SymbolReader:
    """Reads the symbols of one tile from its range-coded bytes."""

    def __init__(self, data: bytes, disable_cdf_update: bool = False):
        from benchmark.avref.entropy.range_coder import RangeDecoder
        self.ec = RangeDecoder(data)
        self.disable_cdf_update = disable_cdf_update

    def read_symbol(self, cdf: np.ndarray, nsyms: int) -> int:
        """``RangeDecoder.decode_symbol`` then ``update_cdf``, the same
        integer steps on a list copy of the CDF, written back once."""
        icdf = cdf[:nsyms + 1].tolist()
        ec = self.ec
        dif = ec.dif
        r8 = ec.rng >> 8
        c = dif >> (WINDOW - 16)
        n = nsyms - 1
        v = ec.rng
        ret = -1
        while True:
            ret += 1
            u = v
            v = ((r8 * (icdf[ret] >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (n - ret)
            if c >= v:
                break
        # RangeDecoder._normalize
        rng = u - v
        d = 16 - rng.bit_length()
        ec.cnt -= d
        ec.dif = (((dif - (v << (WINDOW - 16)) + 1) << d) - 1) & _WMASK
        ec.rng = rng << d
        if ec.cnt < 0:
            ec._refill()
        if not self.disable_cdf_update:
            count = icdf[nsyms]
            rate = 3 + (count > 15) + (count > 31) + _NSYMBS2SPEED[nsyms]
            tmp = CDF_PROB_TOP
            for i in range(n):
                if i == ret:
                    tmp = 0
                cur = icdf[i]
                if tmp < cur:
                    icdf[i] = cur - ((cur - tmp) >> rate)
                else:
                    icdf[i] = cur + ((tmp - cur) >> rate)
            icdf[nsyms] = count + (count < 32)
            cdf[:nsyms + 1] = icdf
        return ret

    def read_bit(self) -> int:
        return self.ec.decode_bool(16384)

    def read_literal(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.read_bit()
        return v
