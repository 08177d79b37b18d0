"""The card's peaks and the work a stage needs, counted from its shapes.

Peaks are NVIDIA's H100 SXM data sheet figures at the full 700 W power
limit; a run writes the card's own limit beside every share of them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (data sheet)


def quant_stage_bytes(rows: int, n: int, rate: bool, trim: bool) -> int:
    """Bytes the quantization stage needs for ``rows`` rows of ``n``
    coefficients, each input read once and each output written once:
    4 B read and 8 B written per coefficient (quantized and dequantized
    int32); per row the qindex in and the eob out, plus the rate out
    (with the rate) and the lambda in (with the RDOQ-lite trim); the
    packed parameter table and the inverse scan once, and with the rate
    the level-cost and eob-bits tables once. The arithmetic of the
    program's ``chip_smoke._bound``."""
    nbytes = rows * n * 12 + rows * (8 + 8 * rate + 8 * trim) + 16384 + 4 * n
    if rate:
        nbytes += 4096 + 4 * (n + 1)
    return nbytes
