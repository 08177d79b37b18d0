"""Chroma-from-luma (CfL) prediction, batched (host NumPy).

Normative prediction (AV1 spec 7.11.5): the chroma block is predicted as
its DC prediction plus a scaled version of the co-located reconstructed
luma's AC (mean-removed, Q3) signal. 4:2:0 subsampling only.
"""

from __future__ import annotations

import numpy as np

CFL_SIGN_ZERO = 0
CFL_SIGN_NEG = 1
CFL_SIGN_POS = 2


def luma_ac_420(luma: np.ndarray):
    """[B, 2h, 2w] reconstructed luma -> Q3 AC [B, h, w] (subsample + mean
    removal, spec cfl_luma_subsampling_420 + compute the average)."""
    l32 = luma.astype(np.int32)
    sub = (l32[:, 0::2, 0::2] + l32[:, 0::2, 1::2]
           + l32[:, 1::2, 0::2] + l32[:, 1::2, 1::2]) << 1
    b, h, w = sub.shape
    n_log2 = int(np.log2(h * w))
    avg = (sub.reshape(b, -1).sum(axis=1) + (1 << (n_log2 - 1))) >> n_log2
    return sub - avg[:, None, None]


def predict(dc_pred: np.ndarray, ac: np.ndarray, alpha_q3,
            bd: int = 8) -> np.ndarray:
    """dc_pred [B, h, w] (the chroma DC prediction), ac [B, h, w] Q3,
    alpha_q3 [B] signed. (spec cfl_predict)."""
    a = np.asarray(alpha_q3, dtype=np.int64)[:, None, None]
    scaled = a * ac.astype(np.int64)
    # Round2Signed(x, 6)
    scaled = np.where(scaled >= 0, (scaled + 32) >> 6, -((-scaled + 32) >> 6))
    return np.clip(dc_pred.astype(np.int64) + scaled, 0, (1 << bd) - 1)


# --- joint sign / alpha index coding helpers (spec 5.11.45) --------------------


def signs_from_joint(js: int):
    return (js + 1) // 3, (js + 1) % 3


def ctx_u(js: int) -> int:
    return js + 1 - 3


def ctx_v(js: int) -> int:
    sign_u, sign_v = signs_from_joint(js)
    return sign_v * 3 + sign_u - 3


def alpha_from_idx(idx: int, sign: int) -> int:
    if sign == CFL_SIGN_ZERO:
        return 0
    mag = idx + 1
    return mag if sign == CFL_SIGN_POS else -mag


def read_cfl_alphas(r, fc):
    js = r.read_symbol(fc.cfl_sign, 8)
    su, sv = signs_from_joint(js)
    alpha_u = alpha_v = 0
    if su != CFL_SIGN_ZERO:
        alpha_u = alpha_from_idx(r.read_symbol(fc.cfl_alpha[ctx_u(js)], 16),
                                 su)
    if sv != CFL_SIGN_ZERO:
        alpha_v = alpha_from_idx(r.read_symbol(fc.cfl_alpha[ctx_v(js)], 16),
                                 sv)
    return alpha_u, alpha_v
