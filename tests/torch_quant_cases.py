"""Inputs of the quantization-stage checks, made with numpy from a seed
(no JAX, no torch), shared by tests/test_torch_quant_stage.py (the port
against the JAX package on the CPU) and tests/test_torch_cuda.py (the
kernel against its plain version on the card).
"""

import numpy as np

from svt_av1_tpu_torch.pipeline import md, rd
from svt_av1_tpu_torch.utils.blocks import (TX_4X4, TX_8X4, TX_8X8,
                                            TX_16X8, TX_16X16, TX_16X32,
                                            TX_32X32, TX_64X16, TX_64X64,
                                            get_scan)

# every row length the full loop gives the stage: the squares' coded
# coefficients and the rectangles' (32, 128 and 512)
ROW_LENGTHS = (16, 32, 64, 128, 256, 512, 1024)
# the rows at the front of every case
ZERO_ROW, BIG_ROW, NEG_BIG_ROW, CLAMP_ROW, INT_MIN_ROW, DC_ROW = range(6)
TIE_ROWS = range(6, 10)
N_SPECIAL = 10


def tx_size_for(n: int, log_scale: int) -> int:
    """A tx size with n coded coefficients (64x64 for n=1024 at
    log_scale 2, so gq12 takes all three of its values over the grid, and
    64x16, whose 64-point side keeps 32, for n=512 at log_scale 2)."""
    if n == 1024 and log_scale == 2:
        return TX_64X64
    if n == 512 and log_scale == 2:
        return TX_64X16
    return {16: TX_4X4, 32: TX_8X4, 64: TX_8X8, 128: TX_16X8,
            256: TX_16X16, 512: TX_16X32, 1024: TX_32X32}[n]


def stage_case(n: int, log_scale: int, b: int, seed: int):
    """(coeff [b, n] int32 raster, qv [b] int32, lam [b] int64, scan,
    tx_size). Rows: all zero; +-2^20 everywhere; +-32767; INT32_MIN and
    small values; DC only; four zero-lambda rows of level-1
    coefficients at qindex 1 (their trim costs tie wherever dq*dq*gq12
    < 4096); then rows of large low-frequency and isolated small
    coefficients deep in the scan (the tail the trim drops), sparse rows
    of log-uniform magnitudes and dense rows in +-2^17. qindex is random
    with 0 (lossless: no trim) and 255 present; lambda is the encoder's
    for the row's qindex, with two rows (the -2^20 row and row 11) near
    2^61 so the trim's products wrap."""
    if b < N_SPECIAL + 2:
        raise ValueError(f"stage_case needs at least {N_SPECIAL + 2} rows")
    tx_size = tx_size_for(n, log_scale)
    scan = get_scan(tx_size, 0)
    rng = np.random.default_rng(seed)
    in_scan = np.zeros((b, n), np.int64)
    head = max(2, n // 16)
    for i in range(N_SPECIAL, b):
        kind = i % 3
        if kind == 0:
            in_scan[i, :head] = rng.integers(-3000, 3001, head)
            deep = rng.choice(np.arange(head, n), 3, replace=False)
            in_scan[i, deep] = rng.choice([-400, -90, 90, 400], 3)
        elif kind == 1:
            mask = rng.random(n) < 0.3
            mag = np.exp(rng.uniform(0.0, 10.0, n)).astype(np.int64)
            sign = rng.choice([-1, 1], n)
            in_scan[i] = np.where(mask, mag * sign, 0)
        else:
            in_scan[i] = rng.integers(-(1 << 17), (1 << 17) + 1, n)
    # |c| that quantizes to level 1 at qindex 1 (dequant 8, so dq is
    # 8 >> log_scale)
    lo, hi = ((5, 12), (3, 5), (1, 2))[log_scale]
    for i in TIE_ROWS:
        pos = rng.choice(n, max(2, n // 8), replace=False)
        in_scan[i, pos] = rng.choice([-1, 1], len(pos)) * rng.integers(
            lo, hi + 1, len(pos))
    coeff = np.zeros((b, n), np.int64)
    coeff[:, scan] = in_scan
    coeff[BIG_ROW] = 1 << 20
    coeff[NEG_BIG_ROW] = -(1 << 20)
    coeff[CLAMP_ROW] = np.where(np.arange(n) % 2, 32767, -32767)
    coeff[INT_MIN_ROW] = np.where(np.arange(n) % 3, -(1 << 31), 700)
    coeff[DC_ROW] = 0
    coeff[DC_ROW, 0] = 5000
    qv = rng.integers(0, 256, b).astype(np.int32)
    qv[[ZERO_ROW, BIG_ROW, CLAMP_ROW]] = (37, 0, 255)
    qv[TIE_ROWS] = 1
    qv[N_SPECIAL] = 0
    qv[-1] = 255
    lam = np.array([md.lam_to_q(rd.rd_lambda(int(q), 8)) for q in qv],
                   np.int64)
    lam[TIE_ROWS] = 0
    lam[[NEG_BIG_ROW, N_SPECIAL + 1]] = (1 << 61) + 12345
    return coeff.astype(np.int32), qv, lam, scan, tx_size


def stage_rows(n: int, log_scale: int, b: int, seed: int):
    """stage_case's outputs for any b >= 0: the first b rows of a case of
    at least 37, so that a batch holds the first b special rows (from
    b = 8: all zero, +-2^20, qindex 0 and 255, INT32_MIN, DC only, a
    wrapping lambda and two zero-lambda tie rows; from b = 12 all of
    them)."""
    coeff, qv, lam, scan, tx_size = stage_case(n, log_scale, max(b, 37),
                                               seed)
    return coeff[:b], qv[:b], lam[:b], scan, tx_size
