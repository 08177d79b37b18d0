"""Delta-QP syntax (spec 5.9.17 delta_q_params / 5.11.5
read_delta_qindex; reference Av1writeDeltaQindex in EbEntropyCoding.c
and the QPM machinery Av1QpModulationLcu, EbCodingLoop.c:2222).

The per-SB delta is coded at the first block of each superblock unless
that block is a full-SB skip; the running qindex accumulates
``delta * (1 << delta_q_res)`` clamped to [1, 255].
"""

from __future__ import annotations

DELTA_Q_SMALL = 3


def read_delta_qindex(r, fc) -> int:
    abs_v = r.read_symbol(fc.delta_q, DELTA_Q_SMALL + 1)
    if abs_v == DELTA_Q_SMALL:
        rem_bits = r.read_literal(3) + 1
        abs_v = r.read_literal(rem_bits) + (1 << rem_bits) + 1
    if abs_v == 0:
        return 0
    return -abs_v if r.read_bit() else abs_v


def apply_delta(prev_qindex: int, delta: int, delta_q_res: int) -> int:
    """CurrentQIndex update (spec 5.11.5): clamp keeps 0 (lossless)
    unreachable."""
    q = prev_qindex + (delta << delta_q_res)
    return max(1, min(255, q))
