"""Bit-level reading of the uncompressed AV1 header syntax: plain
MSB-first bit packing, independent of the arithmetic coder.
"""

from __future__ import annotations


class BitReader:
    """MSB-first bit reader (the f(n) descriptor of the AV1 spec)."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0  # bit position

    def read_bit(self) -> int:
        byte = self._data[self._pos >> 3]
        bit = (byte >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return bit

    def read_literal(self, nbits: int) -> int:
        return self.read(nbits)

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.read_bit()
        return v

    def read_uvlc(self) -> int:
        leading = 0
        while self.read_bit() == 0:
            leading += 1
            if leading >= 32:
                raise ValueError("uvlc overflow")
        v = self.read(leading)
        return v + (1 << leading) - 1

    def read_su(self, nbits: int) -> int:
        v = self.read(nbits)
        sign = 1 << (nbits - 1)
        return (v ^ sign) - sign

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_pos(self) -> int:
        return self._pos


def read_uleb128(data: bytes, pos: int):
    """Returns (value, new_pos)."""
    value = 0
    for i in range(8):
        byte = data[pos + i]
        value |= (byte & 0x7F) << (7 * i)
        if not byte & 0x80:
            return value, pos + i + 1
    raise ValueError("leb128 too long")
