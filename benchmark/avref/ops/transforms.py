"""2D AV1 inverse transforms, batched (host NumPy).

Normative and bit-exact (AV1 spec 7.13.2; reference
Av1InverseTransformTwoDCore_c ``EbTransforms.c:7251``): rows first, clamp
to bd+8 bits on row input, max(bd+6,16) on column input, stage clamps at
16 bits (bd=8), final shifts from the inv_shift table.

All functions operate on batches: x is [batch, H, W].
"""

from __future__ import annotations

import numpy as np

from benchmark.avref.ops import txfm1d
from benchmark.avref.ops.txfm1d import (NEW_INV_SQRT2, NEW_SQRT2_BITS,
                                        round_shift)

# fwd/inv shift tables per TX size (reference EbTransforms.h:119-274)
FWD_SHIFT = {
    (4, 4): (2, 0, 0), (8, 8): (2, -1, 0), (16, 16): (2, -2, 0),
    (32, 32): (2, -4, 0), (64, 64): (0, -2, -2), (4, 8): (2, -1, 0),
    (8, 4): (2, -1, 0), (8, 16): (2, -2, 0), (16, 8): (2, -2, 0),
    (16, 32): (2, -4, 0), (32, 16): (2, -4, 0), (32, 64): (0, -2, -2),
    (64, 32): (2, -4, -2), (4, 16): (2, -1, 0), (16, 4): (2, -1, 0),
    (8, 32): (2, -2, 0), (32, 8): (2, -2, 0), (16, 64): (0, -2, 0),
    (64, 16): (2, -4, 0),
}
INV_SHIFT = {
    (4, 4): (0, -4), (8, 8): (-1, -4), (16, 16): (-2, -4),
    (32, 32): (-2, -4), (64, 64): (-2, -4), (4, 8): (0, -4),
    (8, 4): (0, -4), (8, 16): (-1, -4), (16, 8): (-1, -4),
    (16, 32): (-1, -4), (32, 16): (-1, -4), (32, 64): (-1, -4),
    (64, 32): (-1, -4), (4, 16): (-1, -4), (16, 4): (-1, -4),
    (8, 32): (-2, -4), (32, 8): (-2, -4), (16, 64): (-2, -4),
    (64, 16): (-2, -4),
}
# fwd cos bits [txw_idx][txh_idx] (reference EbTransforms.h:138-152)
FWD_COS_BIT_COL = [[13, 13, 13, 0, 0], [13, 13, 13, 12, 0],
                   [13, 13, 13, 12, 13], [0, 13, 13, 12, 13],
                   [0, 0, 13, 12, 13]]
FWD_COS_BIT_ROW = [[13, 13, 12, 0, 0], [13, 13, 13, 12, 0],
                   [13, 13, 12, 13, 12], [0, 12, 13, 12, 11],
                   [0, 0, 12, 11, 10]]
INV_COS_BIT = 12  # inverse uses cos_bit 12 for all sizes

# tx_type -> (vertical 1D kind, horizontal 1D kind, ud_flip, lr_flip)
_DCT, _ADST, _FLIP, _IDT = "dct", "adst", "flipadst", "identity"
_TX1D = [
    (_DCT, _DCT), (_ADST, _DCT), (_DCT, _ADST), (_ADST, _ADST),
    (_FLIP, _DCT), (_DCT, _FLIP), (_FLIP, _FLIP), (_ADST, _FLIP),
    (_FLIP, _ADST), (_IDT, _IDT), (_DCT, _IDT), (_IDT, _DCT),
    (_ADST, _IDT), (_IDT, _ADST), (_FLIP, _IDT), (_IDT, _FLIP),
]


def tx_cfg(tx_type: int, w: int, h: int):
    vk, hk = _TX1D[tx_type]
    ud_flip = vk == _FLIP
    lr_flip = hk == _FLIP
    vk = _ADST if vk == _FLIP else vk
    hk = _ADST if hk == _FLIP else hk
    return vk, hk, ud_flip, lr_flip


def _rect_type(w: int, h: int) -> int:
    if w == h:
        return 0
    r = (w / h) if w > h else (h / w)
    return int(np.log2(r)) * (1 if w > h else -1)


def _apply_shift(x: np.ndarray, shift: int) -> np.ndarray:
    """Reference av1_round_shift_array(arr, -shift): positive shift
    multiplies, negative shift rounds down."""
    if shift == 0:
        return x
    if shift > 0:
        return x << shift
    return round_shift(x, -shift)


def inverse_tx2d(coeff: np.ndarray, tx_type: int, w: int, h: int,
                 bd: int = 8) -> np.ndarray:
    """Normative inverse 2D transform: coeffs [B, H, W] -> residual [B, H, W].

    Coefficients beyond 32 in either dimension must already be zero
    (64-point transforms code only a 32x32 corner).
    """
    assert coeff.shape[1] == h and coeff.shape[2] == w
    vk, hk, ud_flip, lr_flip = tx_cfg(tx_type, w, h)
    shift = INV_SHIFT[(w, h)]
    clamp_stage = {8: 16, 10: 18, 12: 20}[bd]  # row opt_range
    clamp_stage_col = {8: 16, 10: 16, 12: 18}[bd]
    b = coeff.shape[0]
    x = coeff.astype(np.int64)
    # row pass first (length-w)
    rows = x.reshape(b * h, w)
    if abs(_rect_type(w, h)) == 1:
        rows = round_shift(rows * NEW_INV_SQRT2, NEW_SQRT2_BITS)
    rows = np.clip(rows, -(1 << (bd + 7)), (1 << (bd + 7)) - 1)
    rows = txfm1d.run_1d(rows, hk, w, INV_COS_BIT, inverse=True,
                         clamp_bit=clamp_stage)
    rows = _apply_shift(rows, shift[0])
    buf = rows.reshape(b, h, w)
    if lr_flip:
        buf = buf[:, :, ::-1]
    # column pass (length-h)
    cb = max(bd + 6, 16)
    cols = buf.transpose(0, 2, 1).reshape(b * w, h)
    cols = np.clip(cols, -(1 << (cb - 1)), (1 << (cb - 1)) - 1)
    cols = txfm1d.run_1d(cols, vk, h, INV_COS_BIT, inverse=True,
                         clamp_bit=clamp_stage_col)
    cols = _apply_shift(cols, shift[1])
    out = cols.reshape(b, w, h).transpose(0, 2, 1)
    if ud_flip:
        out = out[:, ::-1, :]
    return out


def recon_add(pred: np.ndarray, resid: np.ndarray, bd: int = 8) -> np.ndarray:
    """Clip(pred + residual) to pixel range."""
    return np.clip(pred.astype(np.int64) + resid, 0,
                   (1 << bd) - 1).astype(np.uint16 if bd > 8 else np.uint8)
