"""Delta-QP syntax (spec 5.9.17 delta_q_params / 5.11.5
read_delta_qindex; reference Av1writeDeltaQindex in EbEntropyCoding.c
and the QPM machinery Av1QpModulationLcu, EbCodingLoop.c:2222).

The per-SB delta is coded at the first block of each superblock unless
that block is a full-SB skip; the running qindex accumulates
``delta * (1 << delta_q_res)`` clamped to [1, 255].
"""

from __future__ import annotations

DELTA_Q_SMALL = 3


def write_delta_qindex(w, fc, delta: int) -> None:
    """delta in delta_q_res steps (signed)."""
    abs_v = abs(delta)
    small = min(abs_v, DELTA_Q_SMALL)
    w.write_symbol(small, fc.delta_q, DELTA_Q_SMALL + 1)
    if abs_v >= DELTA_Q_SMALL:
        rem_bits = max(abs_v - 1, 1).bit_length() - 1
        # spec: delta_q_rem_bits f(3) stores rem_bits - 1
        w.write_literal(rem_bits - 1, 3)
        w.write_literal(abs_v - (1 << rem_bits) - 1, rem_bits)
    if abs_v > 0:
        w.write_bit(int(delta < 0))


def read_delta_qindex(r, fc) -> int:
    abs_v = r.read_symbol(fc.delta_q, DELTA_Q_SMALL + 1)
    if abs_v == DELTA_Q_SMALL:
        rem_bits = r.read_literal(3) + 1
        abs_v = r.read_literal(rem_bits) + (1 << rem_bits) + 1
    if abs_v == 0:
        return 0
    return -abs_v if r.read_bit() else abs_v


def write_delta_to(w, fc, cur_qindex: int, target: int,
                   delta_q_res: int) -> int:
    """Code the SB delta that moves the running qindex from
    ``cur_qindex`` to ``target`` (a multiple of 1 << delta_q_res away);
    returns the new running qindex."""
    d = (target - cur_qindex) >> delta_q_res
    write_delta_qindex(w, fc, d)
    new = apply_delta(cur_qindex, d, delta_q_res)
    assert new == target
    return new


def write_sb_delta(w, fc, cur_qindex: int, target: int, size: int,
                   skip: bool, delta_q_res: int) -> int:
    """The SB's delta at its first block (``size``: that block's square
    size, 0 for a rect): a full-SB skip block codes nothing and leaves
    the running qindex unchanged (spec 5.11.5). Returns the running
    qindex."""
    if size == 64 and skip:
        return cur_qindex
    return write_delta_to(w, fc, cur_qindex, target, delta_q_res)


def apply_delta(prev_qindex: int, delta: int, delta_q_res: int) -> int:
    """CurrentQIndex update (spec 5.11.5): clamp keeps 0 (lossless)
    unreachable."""
    q = prev_qindex + (delta << delta_q_res)
    return max(1, min(255, q))
