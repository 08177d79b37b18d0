"""PyTorch twins of the JAX package's device kernels (``svt_av1_tpu/ops/device.py``).

Transforms, the quantizer, the intra predictors, the analysis entry
steps (``intra_analysis_step``, ``inter_core_step``,
``inter_core_subpel_step``) and the whole-frame deblocking program as
integer tensor code that runs on any torch device.
Every function returns the same integers as its JAX twin; the tests hold
them against it on the CPU.

The quantizer is the one kernel written by hand: ``quantize_qv`` launches
the CUDA kernel of ``csrc/quant.cu`` (quantize-only mode) on a CUDA
tensor and runs ``quantize_qv_plain`` only on a CPU tensor (the static
``quantize`` of the entry steps goes through it); the same kernel's
fused modes serve ``device_md.quant_stage_j``. Everything else here is plain
PyTorch on the card (in the JAX package it is XLA, not Pallas).

Integer exactness notes: inverse transforms are normative and spec stage
clamps keep every intermediate within int32; the forward side matches the
reference's own int32 arithmetic. ``>>`` is arithmetic on signed tensors
in both frameworks, and every ``//`` has non-negative operands.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from svt_av1_tpu_torch import cuda_build
from svt_av1_tpu_torch.ops import quant as quant_host
from svt_av1_tpu_torch.ops import transforms as tx_host
from svt_av1_tpu_torch.ops import txfm1d
from svt_av1_tpu_torch.utils.blocks import (DC_PRED, DCT_DCT, H_PRED,
                                            MAX_TX_SIZE_OF_BLOCK, PAETH_PRED,
                                            SMOOTH_H_PRED, SMOOTH_PRED,
                                            SMOOTH_V_PRED, V_PRED, get_scan)

# launches of each hand-written kernel (per mode), and of each (mode, B,
# n, log_scale) shape: a wrapper counts only where it launches its kernel
LAUNCHES: collections.Counter = collections.Counter()
LAUNCH_SHAPES: collections.Counter = collections.Counter()


def round_shift(x, bit: int):
    return (x + (1 << (bit - 1))) >> bit


def const(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A numpy constant as a tensor on ``device`` (indices: pass
    ``torch.long``)."""
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                           device=device)


# --- 1D butterfly networks ------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _stage_consts(key: str, cos_bit: int, device: torch.device):
    """Resolve a network into per-stage tensors on ``device``:
    (a, b, w0, w1, btf_mask, clamp_mask, any_clamp)."""
    cospi = txfm1d._tables()["cospi"][cos_bit - txfm1d.COS_BIT_MIN]
    out = []
    for a, b, w0, w1, kind in txfm1d._stages(key):
        is_btf = kind == 1
        w0v = np.where(is_btf, np.sign(w0) * cospi[np.abs(w0) - 1], w0)
        w1v = np.where(is_btf, np.sign(w1) * cospi[np.abs(w1) - 1], w1)
        clamp = kind == 2
        out.append((const(a, device, torch.long),
                    const(b, device, torch.long),
                    const(w0v.astype(np.int32), device),
                    const(w1v.astype(np.int32), device),
                    const(is_btf.astype(bool), device),
                    const(clamp.astype(bool), device), bool(clamp.any())))
    return out


def _exec_network(x, key: str, cos_bit: int, clamp_bit: int):
    """x: [B, N] int32."""
    for a, b, w0, w1, btf, clamp, any_clamp in _stage_consts(
            key, cos_bit, x.device):
        t = w0 * x[:, a] + w1 * x[:, b]
        t = torch.where(btf, round_shift(t, cos_bit), t)
        if any_clamp:
            lo = -(1 << (clamp_bit - 1))
            hi = (1 << (clamp_bit - 1)) - 1
            t = torch.where(clamp, t.clamp(lo, hi), t)
        x = t
    return x


def _adst4(x, cos_bit: int, inverse: bool):
    sinpi = [int(v) for v in
             txfm1d._tables()["sinpi"][cos_bit - txfm1d.COS_BIT_MIN]]
    x0, x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    if inverse:
        s0 = sinpi[1] * x0
        s1 = sinpi[2] * x0
        s2 = sinpi[3] * x1
        s3 = sinpi[4] * x2
        s4 = sinpi[1] * x2
        s5 = sinpi[2] * x3
        s6 = sinpi[4] * x3
        s7 = (x0 - x2) + x3
        t0 = s0 + s3 + s5
        t1 = s1 - s4 - s6
        t3 = s2
        t2 = sinpi[3] * s7
        o = [round_shift(t0 + t3, cos_bit), round_shift(t1 + t3, cos_bit),
             round_shift(t2, cos_bit), round_shift(t0 + t1 - t3, cos_bit)]
    else:
        s0 = sinpi[1] * x0
        s1 = sinpi[4] * x0
        s2 = sinpi[2] * x1
        s3 = sinpi[1] * x1
        s4 = sinpi[3] * x2
        s5 = sinpi[4] * x3
        s6 = sinpi[2] * x3
        s7 = (x0 + x1) - x3
        t0 = s0 + s2 + s5
        t1 = sinpi[3] * s7
        t2 = s1 - s3 + s6
        t3 = s4
        o = [round_shift(t0 + t3, cos_bit), round_shift(t1, cos_bit),
             round_shift(t2 - t3, cos_bit),
             round_shift(t2 - t0 + t3, cos_bit)]
    out = torch.stack(o, dim=1)
    any_nz = (x != 0).any(dim=1, keepdim=True)
    return torch.where(any_nz, out, 0)


def _identity(x, n: int):
    mult, bits = txfm1d._ID_SCALE[n]
    x = x * mult
    return round_shift(x, bits) if bits else x


def _run_1d(x, kind: str, n: int, cos_bit: int, inverse: bool,
            clamp_bit: int = 0):
    if kind == "identity":
        return _identity(x, n)
    if kind == "adst" and n == 4:
        return _adst4(x, cos_bit, inverse)
    key = ("i" if inverse else "f") + ("dct" if kind == "dct" else "adst") \
        + str(n)
    return _exec_network(x, key, cos_bit, clamp_bit)


def _apply_shift(x, shift: int):
    if shift == 0:
        return x
    if shift > 0:
        return x << shift
    return round_shift(x, -shift)


# --- 2D transforms ---------------------------------------------------------------
def fwd_tx2d(x, tx_type: int, w: int, h: int):
    """Forward 2D transform, twin of ``transforms.forward_tx2d``.
    x: [B, H, W] int32 residual -> [B, H, W] int32 coefficients."""
    vk, hk, ud_flip, lr_flip = tx_host.tx_cfg(tx_type, w, h)
    shift = tx_host.FWD_SHIFT[(w, h)]
    wi, hi = int(np.log2(w)) - 2, int(np.log2(h)) - 2
    cb_col = tx_host.FWD_COS_BIT_COL[wi][hi]
    cb_row = tx_host.FWD_COS_BIT_ROW[wi][hi]
    b = x.shape[0]
    if ud_flip:
        x = x.flip(1)
    cols = x.permute(0, 2, 1).reshape(b * w, h)
    cols = _apply_shift(cols, shift[0])
    cols = _run_1d(cols, vk, h, cb_col, inverse=False)
    cols = _apply_shift(cols, shift[1])
    buf = cols.reshape(b, w, h).permute(0, 2, 1)
    if lr_flip:
        buf = buf.flip(2)
    rows = buf.reshape(b * h, w)
    rows = _run_1d(rows, hk, w, cb_row, inverse=False)
    rows = _apply_shift(rows, shift[2])
    if abs(tx_host._rect_type(w, h)) == 1:
        rows = round_shift(rows * txfm1d.NEW_SQRT2, txfm1d.NEW_SQRT2_BITS)
    return rows.reshape(b, h, w)


def inv_tx2d(coeff, tx_type: int, w: int, h: int, bd: int = 8):
    """Normative inverse 2D transform, twin of ``transforms.inverse_tx2d``.
    coeff: [B, H, W] int32."""
    vk, hk, ud_flip, lr_flip = tx_host.tx_cfg(tx_type, w, h)
    shift = tx_host.INV_SHIFT[(w, h)]
    clamp_row = {8: 16, 10: 18, 12: 20}[bd]
    clamp_col = {8: 16, 10: 16, 12: 18}[bd]
    b = coeff.shape[0]
    rows = coeff.reshape(b * h, w)
    if abs(tx_host._rect_type(w, h)) == 1:
        rows = round_shift(rows * txfm1d.NEW_INV_SQRT2,
                           txfm1d.NEW_SQRT2_BITS)
    rows = rows.clamp(-(1 << (bd + 7)), (1 << (bd + 7)) - 1)
    rows = _run_1d(rows, hk, w, tx_host.INV_COS_BIT, inverse=True,
                   clamp_bit=clamp_row)
    rows = _apply_shift(rows, shift[0])
    buf = rows.reshape(b, h, w)
    if lr_flip:
        buf = buf.flip(2)
    cb = max(bd + 6, 16)
    cols = buf.permute(0, 2, 1).reshape(b * w, h)
    cols = cols.clamp(-(1 << (cb - 1)), (1 << (cb - 1)) - 1)
    cols = _run_1d(cols, vk, h, tx_host.INV_COS_BIT, inverse=True,
                   clamp_bit=clamp_col)
    cols = _apply_shift(cols, shift[1])
    out = cols.reshape(b, w, h).permute(0, 2, 1)
    if ud_flip:
        out = out.flip(1)
    return out


# --- quantization ----------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _quant_tables_np(bd: int) -> np.ndarray:
    """Per-qindex quantizer parameter tables, stacked [5, 256, 2] int64:
    (zbin, round, quant, quant_shift, dequant) x (DC, AC) — the whole
    av1_build_quantizer parameter space, so the qindex is a per-row
    operand."""
    tabs = np.zeros((5, 256, 2), np.int64)
    for q in range(256):
        qp = quant_host.make_quant_params(q, bit_depth=bd)
        tabs[:, q] = (qp.zbin, qp.round, qp.quant, qp.quant_shift,
                      qp.dequant)
    return tabs


@functools.lru_cache(maxsize=16)
def _quant_tables(bd: int, device: torch.device) -> torch.Tensor:
    return const(_quant_tables_np(bd), device)


@functools.lru_cache(maxsize=256)
def _scan_tensors(scan_bytes: bytes, device: torch.device):
    """(scan [n] long, inverse scan [n] int32) on ``device``."""
    scan = np.frombuffer(scan_bytes, dtype=np.int64).copy()
    iscan = np.empty(len(scan), np.int32)
    iscan[scan] = np.arange(len(scan), dtype=np.int32)
    return const(scan, device, torch.long), const(iscan, device)


def _scan_t(scan: np.ndarray, device):
    return _scan_tensors(np.asarray(scan, np.int64).tobytes(),
                         torch.device(device))


def quantize_qv_plain(coeff, scan: np.ndarray, qv, log_scale: int, bd: int):
    """Plain PyTorch quantize + dequantize with a per-row qindex vector
    ``qv`` [B] (twin of the JAX ``quantize_qv``; same integer tables, same
    expressions). Returns (qcoeff [B, n] int32, dqcoeff [B, n] int32,
    eob [B] int32)."""
    n = coeff.shape[1]
    device = coeff.device
    tz, tr, tq, ts, td = _quant_tables(bd, device)
    qv = qv.long()
    is_dc = torch.zeros((1, n), dtype=torch.bool, device=device)
    is_dc[0, 0] = True

    def rpot(v):
        return ((v + ((1 << log_scale) >> 1)) >> log_scale) if log_scale \
            else v

    def sel(tab):                      # [B, n] per-position parameter
        row = tab[qv]                  # [B, 2]
        return torch.where(is_dc, row[:, 0:1], row[:, 1:2])

    zbin = rpot(sel(tz))
    rnd = rpot(sel(tr))
    quant = sel(tq)
    qshift = sel(ts)
    deq = sel(td)

    sign = torch.where(coeff < 0, -1, 1)
    abs_c = coeff.abs()
    over = abs_c >= zbin
    tmp = (abs_c + rnd).clamp(-32768, 32767)
    tmp32 = ((((tmp * quant) >> 16) + tmp) * qshift) >> (16 - log_scale)
    tmp32 = torch.where(over, tmp32, 0)
    qcoeff = sign * tmp32
    dqcoeff = sign * ((tmp32 * deq) >> log_scale)
    scan_t, _ = _scan_t(scan, device)
    nz_scan = tmp32[:, scan_t] != 0
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=device)
    eob = torch.where(nz_scan, idx[None, :], 0).amax(dim=1)
    return (qcoeff.to(torch.int32), dqcoeff.to(torch.int32),
            eob.to(torch.int32))


# The Hopper kernel (csrc/quant.cu) replaces the JAX package's Pallas
# kernel svt_av1_tpu/ops/device.py:quantize_pallas (body _quant_kernel),
# with the contract of its per-lane twin quantize_qv, and fuses the full
# loop's two consumers of its result, the RDOQ-lite trim and the CDF
# level rate (device_md.quant_stage_j). One kernel, three modes:
QUANT_ONLY, QUANT_RATE, QUANT_TRIM_RATE = 0, 1, 2
# the row lengths it takes: the coded coefficients of every transform
# size (4x8/8x4 32, 8x16/16x8 128, 16x32 up to 64x16 512)
ROW_LENGTHS = (16, 32, 64, 128, 256, 512, 1024)
# launch counters, one per mode
MODE_NAMES = {QUANT_ONLY: "quantize_qv", QUANT_RATE: "quant_stage",
              QUANT_TRIM_RATE: "quant_stage_rdoq"}
_QUANT_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def _quant_lib() -> ctypes.CDLL:
    lib = cuda_build.load("quant")
    lib.svt_quant_stage_cuda.argtypes = _QUANT_ARGTYPES
    lib.svt_quant_stage_cuda.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _packed_params(bd: int, log_scale: int, device: torch.device):
    """The kernel's per-qindex parameters, int32 [256][2][8]: for DC and
    AC, (zbin and round rounded down by log_scale, quant, quant_shift,
    dequant, the CDF qindex bucket, 0, 0). The ranges the kernel's
    product chain relies on are checked here."""
    from svt_av1_tpu_torch.entropy.cdf import coef_qctx
    tz, tr, tq, ts, td = _quant_tables_np(bd)          # each [256, 2]
    half = (1 << log_scale) >> 1
    out = np.zeros((256, 2, 8), np.int64)
    out[..., 0] = (tz + half) >> log_scale
    out[..., 1] = (tr + half) >> log_scale
    out[..., 2], out[..., 3], out[..., 4] = tq, ts, td
    out[..., 5] = np.array([coef_qctx(q) for q in range(256)])[:, None]
    if not (np.abs(tq).max() <= 1 << 15 and ts.min() >= 0
            and ts.max() <= 1 << 16 and np.abs(out).max() < 1 << 31):
        raise ValueError("quantizer tables outside the kernel's ranges")
    return const(out.astype(np.int32), device)


_LAUNCH_CONSTS: dict = {}


def _launch_consts(scan: np.ndarray, bd: int, log_scale: int,
                   device: torch.device):
    """(parameter table pointer, inverse scan pointer) on ``device``,
    cached by the scan array's identity (the entry keeps the array and
    the tensors alive, so the id is not reused; the scans of
    utils.blocks.get_scan are cached arrays that nothing writes), so a
    launch neither hashes the scan nor builds a table."""
    key = (id(scan), bd, log_scale, device)
    hit = _LAUNCH_CONSTS.get(key)
    if hit is not None and hit[0] is scan:
        return hit[1]
    params = _packed_params(bd, log_scale, device)
    iscan = _scan_t(scan, device)[1]
    if len(_LAUNCH_CONSTS) >= 512:
        _LAUNCH_CONSTS.clear()
    ptrs = (params.data_ptr(), iscan.data_ptr())
    _LAUNCH_CONSTS[key] = (scan, ptrs, params, iscan)
    return ptrs


def quant_outputs(coeff, rate: bool) -> tuple:
    """New output tensors of the kernel for ``coeff`` [B, n] int32: (q,
    dq, eob) and, with ``rate``, rate [B] int64. Separate allocations:
    the caching allocator's blocks are 16-byte aligned, and splitting one
    buffer into views costs more host time."""
    b = coeff.shape[0]
    eob = coeff.new_empty(b, dtype=torch.int32)
    out = (torch.empty_like(coeff), torch.empty_like(coeff), eob)
    return out + (coeff.new_empty(b, dtype=torch.int64),) if rate else out


def quant_stage_launch(mode: int, coeff, scan: np.ndarray, qv,
                       log_scale: int, bd: int, lam=None,
                       rate_ptrs=(None, None, 0), out=None):
    """Launch csrc/quant.cu on CUDA tensors in ``mode`` (QUANT_ONLY,
    QUANT_RATE or QUANT_TRIM_RATE). coeff [B, n] int32 (n in ROW_LENGTHS),
    qv [B] int32, lam [B] int64 (trim); ``rate_ptrs``: (pointer
    to the level-cost table [4, 256] int32, pointer to the eob bits LUT
    [>= n + 1] int32, gq12), for the rate modes. Returns (q, dq, eob)
    and, with a rate mode, rate [B] int64: new tensors, or ``out``, such
    a tuple as ``quant_outputs`` makes, written in place.
    Raises on what the kernel does not take and on a failed launch;
    never falls back."""
    name = MODE_NAMES[mode]
    device = coeff.device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {device}")
    if coeff.dtype != torch.int32 or coeff.dim() != 2:
        raise ValueError(f"{name}: coeff must be [B, n] int32")
    b, n = coeff.shape
    if n not in ROW_LENGTHS or len(scan) != n:
        raise ValueError(f"{name}: unsupported row length {n}")
    if log_scale not in (0, 1, 2):
        raise ValueError(f"{name}: log_scale {log_scale}")
    if qv.dtype != torch.int32 or qv.shape != (b,) or qv.device != device:
        raise ValueError(f"{name}: qv must be [B] int32 on coeff's device")
    if not (coeff.is_contiguous() and qv.is_contiguous()
            and coeff.data_ptr() % 16 == 0):
        raise ValueError(f"{name}: coeff and qv must be contiguous, coeff "
                         f"16-byte aligned")
    trim = mode == QUANT_TRIM_RATE
    if trim and (lam is None or lam.dtype != torch.int64
                 or lam.shape != (b,) or lam.device != device
                 or not lam.is_contiguous()):
        raise ValueError(f"{name}: lam must be [B] int64 on coeff's device")
    with_rate = mode != QUANT_ONLY
    if with_rate and not (rate_ptrs[0] and rate_ptrs[1]):
        raise ValueError(f"{name}: the rate needs its tables")
    if out is None:
        out = quant_outputs(coeff, with_rate)
    elif len(out) != 3 + with_rate or any(
            t.shape != sh or t.dtype != dt or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16
            for t, sh, dt in zip(
                out, ((b, n), (b, n), (b,), (b,)),
                (torch.int32, torch.int32, torch.int32, torch.int64))):
        raise ValueError(f"{name}: out must be like quant_outputs(coeff, "
                         f"{with_rate})")
    q, dq, eob = out[:3]
    rate = out[3] if with_rate else None
    if b:
        params, iscan = _launch_consts(scan, bd, log_scale, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _quant_lib().svt_quant_stage_cuda(
            coeff.data_ptr(), qv.data_ptr(),
            lam.data_ptr() if trim else None, params, rate_ptrs[0],
            rate_ptrs[1], iscan, q.data_ptr(), dq.data_ptr(),
            eob.data_ptr(), rate.data_ptr() if with_rate else None, b, n,
            log_scale, rate_ptrs[2], mode, stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed "
                               f"(cudaError {err})")
        LAUNCHES[name] += 1
        LAUNCH_SHAPES[(name, b, n, log_scale)] += 1
    return (q, dq, eob) if rate is None else (q, dq, eob, rate)


def quantize_qv(coeff, scan: np.ndarray, qv, log_scale: int, bd: int):
    """Quantize + dequantize [B, n] int32 coefficients with per-row qindex
    ``qv`` [B] int32; returns (q, dq, eob) as in ``quantize_qv_plain``.
    On a CUDA tensor this launches the hand-written kernel in its
    quantize-only mode (it never falls back); on a CPU tensor it runs the
    plain version."""
    if coeff.device.type == "cpu":
        return quantize_qv_plain(coeff, scan, qv, log_scale, bd)
    return quant_stage_launch(QUANT_ONLY, coeff, scan, qv, log_scale, bd)


def quantize(coeff, scan: np.ndarray, qp: quant_host.QuantParams,
             log_scale: int, bd: int = 8):
    """Twin of the JAX package's static-qindex ``quantize``: ``quantize_qv``
    with ``qp.qindex`` on every row, so it launches the kernel on a CUDA
    tensor (the JAX ``quantize`` rounds zbin and round by ``log_scale``
    as the kernel's packed table does). ``qp`` must be the bd-bit table
    row of its qindex, ``make_quant_params(qp.qindex, bit_depth=bd)``:
    the table holds no DC/AC delta. Returns (q, dq, eob)."""
    if qp != quant_host.make_quant_params(qp.qindex, bit_depth=bd):
        raise ValueError("quantize: qp is not the quantizer table's row "
                         f"of qindex {qp.qindex} at {bd} bits")
    qv = torch.full((coeff.shape[0],), qp.qindex, dtype=torch.int32,
                    device=coeff.device)
    return quantize_qv(coeff.contiguous(), scan, qv, log_scale, bd)


# --- intra predictors -------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def intra_sm_weights(n: int) -> np.ndarray:
    """The smooth predictors' weights of one block dimension, int32."""
    from svt_av1_tpu_torch.ops.intra import _SM_WEIGHTS
    return _SM_WEIGHTS[n].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _sm_weights(n: int, device: torch.device) -> torch.Tensor:
    return const(intra_sm_weights(n), device)


def predict_modes(modes: tuple, above, left, top_left, have_above, have_left,
                  bw: int, bh: int, bd: int = 8):
    """All candidate intra predictions at once: returns [M, B, bh, bw].

    above [B, >=bw], left [B, >=bh], top_left [B] int32; have_* [B] bool.
    """
    base = 1 << (bd - 1)
    a = above[:, None, :bw]
    l = left[:, :bh, None]  # noqa: E741
    tl = top_left[:, None, None]
    b = above.shape[0]
    dev = above.device
    preds = []
    for mode in modes:
        if mode == DC_PRED:
            sum_a = above[:, :bw].sum(dim=1)
            sum_l = left[:, :bh].sum(dim=1)
            both = (sum_a + sum_l + ((bw + bh) >> 1)) // (bw + bh)
            only_a = (sum_a + (bw >> 1)) >> int(np.log2(bw))
            only_l = (sum_l + (bh >> 1)) >> int(np.log2(bh))
            avg = torch.where(have_above & have_left, both,
                              torch.where(have_above, only_a,
                                          torch.where(have_left, only_l,
                                                      base)))
            p = avg[:, None, None].expand(b, bh, bw)
        elif mode == V_PRED:
            p = a.expand(b, bh, bw)
        elif mode == H_PRED:
            p = l.expand(b, bh, bw)
        elif mode == PAETH_PRED:
            pbase = a + l - tl
            pa = (pbase - a).abs()
            pl_ = (pbase - l).abs()
            ptl = (pbase - tl).abs()
            p = torch.where((pl_ <= pa) & (pl_ <= ptl), l.expand(b, bh, bw),
                            torch.where(pa <= ptl, a.expand(b, bh, bw),
                                        tl.expand(b, bh, bw)))
        elif mode == SMOOTH_PRED:
            wh = _sm_weights(bh, dev)[None, :, None]
            ww = _sm_weights(bw, dev)[None, None, :]
            below = left[:, bh - 1][:, None, None]
            right = above[:, bw - 1][:, None, None]
            s = (wh * a + (256 - wh) * below + ww * l + (256 - ww) * right)
            p = round_shift(s, 9)
        elif mode == SMOOTH_V_PRED:
            wh = _sm_weights(bh, dev)[None, :, None]
            below = left[:, bh - 1][:, None, None]
            s = wh * a + (256 - wh) * below
            p = round_shift(s, 8)
        elif mode == SMOOTH_H_PRED:
            ww = _sm_weights(bw, dev)[None, None, :]
            right = above[:, bw - 1][:, None, None]
            s = ww * l + (256 - ww) * right
            p = round_shift(s, 8)
        else:
            raise NotImplementedError(f"device intra mode {mode}")
        preds.append(p.to(torch.int64))
    return torch.stack(preds, dim=0)


def _sum_i32(x, dims):
    """The sum over ``dims`` as the JAX package's int32 ``jnp.sum`` gives
    it: exact in int64, then wrapped to int32 (XLA's integer adds wrap,
    so both are the exact sum modulo 2^32)."""
    return x.sum(dim=dims, dtype=torch.int64).to(torch.int32)


def mode_decision_sse(modes: tuple, src, above, left, top_left,
                      have_above, have_left, bw: int, bh: int, bd: int = 8):
    """Batched open-loop mode decision (twin of the JAX
    ``mode_decision_sse``): src [B, bh, bw] int32. Returns (best mode
    index [B] int32, the first minimum; preds [M, B, bh, bw] int32;
    SSE costs [M, B] int32)."""
    preds = predict_modes(modes, above, left, top_left, have_above,
                          have_left, bw, bh, bd).to(torch.int32)
    diff = src[None] - preds
    costs = _sum_i32(diff * diff, (2, 3))
    best = costs.argmin(dim=0).to(torch.int32)
    return best, preds, costs


# --- gathers with the JAX index rule -----------------------------------------------
def jax_index(idx, n: int):
    """An index tensor under the rule of a JAX gather: a negative index
    counts from the end, then every index is clamped into [0, n). torch
    raises (CPU) or faults (CUDA) where JAX reads a clamped element, so
    every gather whose indices the data choose goes through this."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def take2(plane, iy, ix):
    """plane[iy, ix] of a [H, W] tensor with the JAX gather rule."""
    h, w = plane.shape[-2:]
    return plane[jax_index(iy, h), jax_index(ix, w)]


# --- motion compensation -----------------------------------------------------------
# (8/4-tap sub-pel convolve batched over blocks with data-dependent MVs;
# host oracle ops/mc.mc_block_batch. Windows are gathered per block from
# the padded reference; filter rows are gathered by sub-pel phase.)

@functools.lru_cache(maxsize=64)
def mc_filter_bank(dim: int, device: torch.device, dtype=torch.int32):
    """The [3, 16, 8] switchable banks (REGULAR, SMOOTH, SHARP) of one
    block dimension: the 4-tap sets at 4 px and below (mc._filters)."""
    from svt_av1_tpu_torch.ops import mc as mch
    return const(mch._filters(dim, np.arange(mch.SWITCHABLE_FILTERS)),
                 device, dtype)


def mc_filter_rows(dim: int, frac, ftype=0, dtype=torch.int32):
    """Per-block taps [B, 8] of one direction, gathered by sub-pel phase
    ``frac`` [B] and filter type: ``ftype`` an int (0 = REGULAR) or a [B]
    tensor (per-lane switchable filter)."""
    bank = mc_filter_bank(dim, frac.device, dtype)
    if isinstance(ftype, int):
        return bank[ftype][frac]
    return bank[ftype.long(), frac]


def mc_window(ref_padded, xs, ys, mvs, w: int, h: int, ss: int,
              ref_idx=None, flat: bool = True):
    """The (h+7, w+7) filter windows [B, h+7, w+7] (ref dtype) and the
    sub-pel phases (frac_r, frac_c) [B] of a batch of MC blocks, gathered
    with the JAX gather rule from the flattened (stacked, with
    ``ref_idx``) padded reference, or, with ``flat`` False and no bank,
    by row and column as a 2-D gather. The two clamp differently out of
    range, and each follows its JAX twin: mc_block_batch_j gathers flat,
    mc_block_batch_conv_j by row and column."""
    from svt_av1_tpu_torch.ops import mc as mch
    b = xs.shape[0]
    mvs = mvs.long()
    scaled_r = mvs[:, 0] << (1 - ss)
    scaled_c = mvs[:, 1] << (1 - ss)
    int_r = ys.long() + (scaled_r >> 4)
    int_c = xs.long() + (scaled_c >> 4)
    wp = ref_padded.shape[-1]
    y0 = int_r + mch.REF_PAD - 3
    x0 = int_c + mch.REF_PAD - 3
    dev_ = ref_padded.device
    iy = y0[:, None, None] + torch.arange(h + 7, device=dev_)[None, :, None]
    ix = x0[:, None, None] + torch.arange(w + 7, device=dev_)[None, None, :]
    if not flat and ref_idx is None:
        return take2(ref_padded, iy, ix), scaled_r & 15, scaled_c & 15
    idx = iy * wp + ix
    if ref_idx is not None:
        plane_sz = ref_padded.shape[-1] * ref_padded.shape[-2]
        idx = idx + (ref_idx.long() * plane_sz)[:, None, None]
    bank = ref_padded.reshape(-1)
    win = bank[jax_index(idx.reshape(b, -1), bank.numel())]
    return win.reshape(b, h + 7, w + 7), scaled_r & 15, scaled_c & 15


def mc_block_batch_j(ref_padded, xs, ys, mvs, w: int, h: int,
                     ss: int = 0, bd: int = 8, ref_idx=None, ftype=0):
    """Twin of the JAX ``mc_block_batch_j`` (mc.mc_block_batch): [B]
    blocks, [B, 2] MVs in 1/8-pel luma units. Returns [B, h, w] pixels
    (int32). ``ref_idx``: optional [B] plane selector when ``ref_padded``
    is a stacked [R, H, W] bank (per-block reference choice in one
    gather). ``ftype``: interpolation filter, an int (0 = REGULAR) or a
    [B] tensor (mc.mc_block_batch's ``ftype``). int32 arithmetic, as the
    JAX twin's."""
    from svt_av1_tpu_torch.ops import mc as mch
    b = xs.shape[0]
    win, frac_r, frac_c = mc_window(ref_padded, xs, ys, mvs, w, h, ss,
                                    ref_idx)
    win = win.to(torch.int32)
    fx = mc_filter_rows(w, frac_c, ftype)                  # [B, 8]
    fy = mc_filter_rows(h, frac_r, ftype)
    offset_bits = bd + 2 * mch.FILTER_BITS - mch.ROUND0
    final_bits = 2 * mch.FILTER_BITS - mch.ROUND0 - mch.ROUND1
    sub = (1 << (offset_bits - mch.ROUND1)) \
        + (1 << (offset_bits - mch.ROUND1 - 1))
    horiz = torch.full((b, h + 7, w), 1 << (bd + mch.FILTER_BITS - 1),
                       dtype=torch.int32, device=win.device)
    for k in range(8):
        horiz = horiz + fx[:, k, None, None] * win[:, :, k:k + w]
    horiz = (horiz + (1 << (mch.ROUND0 - 1))) >> mch.ROUND0
    vert = torch.full((b, h, w), 1 << offset_bits, dtype=torch.int32,
                      device=win.device)
    for k in range(8):
        vert = vert + fy[:, k, None, None] * horiz[:, k:k + h]
    res = ((vert + (1 << (mch.ROUND1 - 1))) >> mch.ROUND1) - sub
    if final_bits > 0:
        res = (res + (1 << (final_bits - 1))) >> final_bits
    return res.clamp(0, (1 << bd) - 1)


# --- the analysis entry steps -------------------------------------------------------
# (twins of the JAX package's intra_analysis_step, inter_core_step and
# inter_core_subpel_step: the per-block compute core as one batched step,
# the quantizer through ``quantize`` and so through csrc/quant.cu on the
# card. int32 results, as the JAX steps return them.)

def _dct_loop(srcs, pred, size: int, qindex: int, bd: int):
    """DCT_DCT forward transform of ``srcs - pred`` [B, size, size], the
    static-qindex quantizer on its coded (at most 32x32) corner, inverse
    transform, recon clip and SSE. Returns (qcoeff [B, n], eob [B],
    sse [B]), all int32."""
    coeffs = fwd_tx2d((srcs - pred).to(torch.int32), DCT_DCT, size, size)
    b = coeffs.shape[0]
    cw = min(32, size)
    coded = coeffs[:, :cw, :cw].reshape(b, -1)
    tx_size = MAX_TX_SIZE_OF_BLOCK[size]
    qcoeff, dqcoeff, eob = quantize(
        coded, get_scan(tx_size, DCT_DCT),
        quant_host.make_quant_params(qindex, bit_depth=bd),
        quant_host.tx_scale(tx_size), bd)
    full = torch.zeros_like(coeffs)
    full[:, :cw, :cw] = dqcoeff.reshape(b, cw, cw)
    r = inv_tx2d(full, DCT_DCT, size, size, bd)
    recon = (pred + r).clamp(0, (1 << bd) - 1)
    return qcoeff, eob, _sum_i32((srcs - recon) ** 2, (1, 2))


def intra_analysis_step(src, above, left, top_left, have_above, have_left,
                        modes: tuple = (DC_PRED, V_PRED, H_PRED, SMOOTH_PRED,
                                        PAETH_PRED),
                        size: int = 16, qindex: int = 160, bd: int = 8):
    """The flagship analysis step (twin of the JAX
    ``intra_analysis_step``): batched intra mode decision + forward
    transform + quantize + dequantize + inverse transform + recon
    distortion over a batch of same-sized blocks. src [B, size, size]
    int32, above/left [B, >= size] int32, top_left [B] int32, have_* [B]
    bool. Returns (best mode index, qcoeff, eob, sse)."""
    best, preds, _ = mode_decision_sse(modes, src, above, left, top_left,
                                       have_above, have_left, size, size,
                                       bd)
    bsel = preds[best.long(), torch.arange(src.shape[0],
                                           device=src.device)]
    qcoeff, eob, sse = _dct_loop(src, bsel, size, qindex, bd)
    return best, qcoeff, eob, sse


def _grid_search(cur, ref_padded, pad: int, size: int, search_range: int,
                 search_step: int):
    """Full-pel SAD search of every size x size block of ``cur`` [H, W]
    over the static offset grid, against ``ref_padded`` (``pad`` on each
    side): the JAX steps slice the reference with
    ``jax.lax.dynamic_slice``, which clamps its start, so a reference
    whose border would make it clamp is refused instead. Returns (best
    offset [B, 2] long, the first minimum; the blocks [B, size, size])."""
    h, w = cur.shape
    bh, bw = h // size, w // size
    steps = range(-search_range, search_range + 1, search_step)
    offsets = [(dy, dx) for dy in steps for dx in steps]
    hr, wr = ref_padded.shape
    if pad - search_range < 0 or pad + steps[-1] + h > hr \
            or pad + steps[-1] + w > wr or h % size or w % size:
        raise ValueError(f"grid search: reference {hr}x{wr} with border "
                         f"{pad} cannot slice {h}x{w} at offsets up to "
                         f"+-{search_range} (or the frame is not a "
                         f"multiple of {size})")
    sads = torch.stack([
        _sum_i32((cur - ref_padded[pad + dy:pad + dy + h,
                                  pad + dx:pad + dx + w]).abs()
                .reshape(bh, size, bw, size), (1, 3))
        for dy, dx in offsets])                              # [O, bh, bw]
    best = sads.argmin(dim=0).reshape(-1)
    offs = torch.tensor(offsets, dtype=torch.long, device=cur.device)
    srcs = cur.reshape(bh, size, bw, size).permute(0, 2, 1, 3) \
        .reshape(-1, size, size)
    return offs[best], srcs


def _block_origins(h: int, w: int, size: int, device):
    """(ys, xs) [B] long: the top-left pixel of each block, raster order."""
    bw = w // size
    i = torch.arange((h // size) * bw, device=device)
    return (i // bw) * size, (i % bw) * size


def inter_core_step(cur, ref_padded, size: int = 16, search_range: int = 16,
                    search_step: int = 2, qindex: int = 160, bd: int = 8):
    """The inter compute core of one frame (twin of the JAX
    ``inter_core_step``): full-pel SAD search over a static offset grid,
    full-pel motion compensation, residual DCT + quantize + recon
    distortion. cur [H, W] int32 (multiples of ``size``), ref_padded
    [H + 2 * search_range, W + 2 * search_range] int32. Returns (best MV
    [B, 2] in pels, qcoeff [B, n], eob [B], sse [B]), all int32."""
    pad = search_range
    mv, srcs = _grid_search(cur, ref_padded, pad, size, search_range,
                            search_step)
    ys, xs = _block_origins(*cur.shape, size, cur.device)
    ar = torch.arange(size, device=cur.device)
    rows = (ys + mv[:, 0] + pad)[:, None, None] + ar[None, :, None]
    cols = (xs + mv[:, 1] + pad)[:, None, None] + ar[None, None, :]
    pred = take2(ref_padded, rows, cols)
    qcoeff, eob, sse = _dct_loop(srcs, pred, size, qindex, bd)
    return mv.to(torch.int32), qcoeff, eob, sse


def inter_core_subpel_step(cur, ref_mc_padded, size: int = 16,
                           search_range: int = 16, search_step: int = 2,
                           qindex: int = 160, bd: int = 8):
    """The inter core with sub-pel refinement (twin of the JAX
    ``inter_core_subpel_step``): the full-pel grid SAD of
    ``inter_core_step``, then the half- and quarter-pel sweep (4
    candidates each, a strictly lower SSE moves) through
    ``mc_block_batch_j``, then the DCT loop. ref_mc_padded: the
    reference with the MC border (``mc.REF_PAD`` on each side). Returns
    (best MV [B, 2] in 1/8 pel, qcoeff, eob, sse), all int32."""
    from svt_av1_tpu_torch.ops import mc as mch
    mv, srcs = _grid_search(cur, ref_mc_padded, mch.REF_PAD, size,
                            search_range, search_step)
    mv8 = mv * 8
    ys, xs = _block_origins(*cur.shape, size, cur.device)

    def sse_of(cand):
        pred = mc_block_batch_j(ref_mc_padded, xs, ys, cand, size, size,
                                ss=0, bd=bd)
        return _sum_i32((srcs - pred) ** 2, (1, 2))

    best_cost = sse_of(mv8)
    for step in (4, 2):                  # half then quarter pel
        for oy, ox in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            cand = mv8 + torch.tensor([oy * step, ox * step],
                                      device=cur.device)
            cost = sse_of(cand)
            better = cost < best_cost
            mv8 = torch.where(better[:, None], cand, mv8)
            best_cost = torch.where(better, cost, best_cost)
    pred = mc_block_batch_j(ref_mc_padded, xs, ys, mv8, size, size, ss=0,
                            bd=bd)
    qcoeff, eob, sse = _dct_loop(srcs, pred, size, qindex, bd)
    return mv8.to(torch.int32), qcoeff, eob, sse


# --- DLF -----------------------------------------------------------------------
# (the 4/6/8/14-tap edge filters over batched sample lines [N, 14];
# host oracle ops/dlf._apply_len. Adjacent same-direction edges never
# overlap — filter span is bounded by the minimum tx dim — so whole-frame
# application is one batched gather/filter/scatter.)

def _dlf_filter4_j(p1, p0, q0, q1, mask, thresh, bd):
    shift = bd - 8
    lo, hi, piv = -128 << shift, (128 << shift) - 1, 128 << shift

    def sc(x):
        return x.clamp(lo, hi)

    ps1, ps0 = p1 - piv, p0 - piv
    qs0, qs1 = q0 - piv, q1 - piv
    hev = ((p1 - p0).abs() > thresh) | ((q1 - q0).abs() > thresh)
    f = sc(ps1 - qs1) * hev
    f = sc(f + 3 * (qs0 - ps0)) * mask
    f1 = sc(f + 4) >> 3
    f2 = sc(f + 3) >> 3
    oq0 = sc(qs0 - f1) + piv
    op0 = sc(ps0 + f2) + piv
    f3 = ((f1 + 1) >> 1) * ~hev
    oq1 = sc(qs1 - f3) + piv
    op1 = sc(ps1 + f3) + piv
    return op1, op0, oq0, oq1


def dlf_apply_len_batch(s, length: int, blimit, limit, thresh, bd: int = 8):
    """Twin of dlf._apply_len: s [N, 14] int32 sample lines (p6..p0,
    q0..q6); returns the filtered lines (a new tensor)."""
    p = {i: s[:, 6 - i] for i in range(7)}
    q = {i: s[:, 7 + i] for i in range(7)}
    s = s.clone()

    def am(a, b):
        return (a - b).abs()

    def r3(x):
        return (x + 4) >> 3

    def r4(x):
        return (x + 8) >> 4

    def put(idx, cond, v):
        s[:, idx] = torch.where(cond, v, s[:, idx])

    if length == 4:
        fmask = ~((am(p[1], p[0]) > limit) | (am(q[1], q[0]) > limit)
                  | (am(p[0], q[0]) * 2 + am(p[1], q[1]) // 2 > blimit))
        np1, np0, nq0, nq1 = _dlf_filter4_j(p[1], p[0], q[0], q[1],
                                            fmask, thresh, bd)
        for idx, v in ((5, np1), (6, np0), (7, nq0), (8, nq1)):
            put(idx, fmask, v)
        return s

    if length == 6:
        fmask = ~((am(p[2], p[1]) > limit) | (am(p[1], p[0]) > limit)
                  | (am(q[1], q[0]) > limit) | (am(q[2], q[1]) > limit)
                  | (am(p[0], q[0]) * 2 + am(p[1], q[1]) // 2 > blimit))
        ft = 1 << (bd - 8)
        flat = ~((am(p[1], p[0]) > ft) | (am(q[1], q[0]) > ft)
                 | (am(p[2], p[0]) > ft) | (am(q[2], q[0]) > ft))
        wide = fmask & flat
        o = {5: r3(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0]),
             6: r3(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1]),
             7: r3(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2]),
             8: r3(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3)}
        np1, np0, nq0, nq1 = _dlf_filter4_j(p[1], p[0], q[0], q[1],
                                            fmask & ~flat, thresh, bd)
        nar = {5: np1, 6: np0, 7: nq0, 8: nq1}
        for idx in (5, 6, 7, 8):
            s[:, idx] = torch.where(
                wide, o[idx], torch.where(fmask & ~flat, nar[idx],
                                          s[:, idx]))
        return s

    fmask = ~((am(p[3], p[2]) > limit) | (am(p[2], p[1]) > limit)
              | (am(p[1], p[0]) > limit) | (am(q[1], q[0]) > limit)
              | (am(q[2], q[1]) > limit) | (am(q[3], q[2]) > limit)
              | (am(p[0], q[0]) * 2 + am(p[1], q[1]) // 2 > blimit))
    ft = 1 << (bd - 8)
    flat = ~((am(p[1], p[0]) > ft) | (am(q[1], q[0]) > ft)
             | (am(p[2], p[0]) > ft) | (am(q[2], q[0]) > ft)
             | (am(p[3], p[0]) > ft) | (am(q[3], q[0]) > ft))
    o8 = {4: r3(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0]),
          5: r3(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1]),
          6: r3(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2]),
          7: r3(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3]),
          8: r3(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2),
          9: r3(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3)}
    np1, np0, nq0, nq1 = _dlf_filter4_j(p[1], p[0], q[0], q[1],
                                        fmask & ~flat, thresh, bd)
    nar = {5: np1, 6: np0, 7: nq0, 8: nq1}
    if length == 8:
        for idx in (4, 5, 6, 7, 8, 9):
            put(idx, fmask & flat, o8[idx])
        for idx in (5, 6, 7, 8):
            put(idx, fmask & ~flat, nar[idx])
        return s

    flat2 = ~((am(p[4], p[0]) > ft) | (am(q[4], q[0]) > ft)
              | (am(p[5], p[0]) > ft) | (am(q[5], q[0]) > ft)
              | (am(p[6], p[0]) > ft) | (am(q[6], q[0]) > ft))
    o14 = {
        1: r4(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1]
              + p[0] + q[0]),
        2: r4(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1]
              + p[0] + q[0] + q[1]),
        3: r4(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1]
              + p[0] + q[0] + q[1] + q[2]),
        4: r4(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2
              + p[0] + q[0] + q[1] + q[2] + q[3]),
        5: r4(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2
              + p[0] * 2 + q[0] + q[1] + q[2] + q[3] + q[4]),
        6: r4(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2
              + q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5]),
        7: r4(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2
              + q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6]),
        8: r4(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2
              + q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2),
        9: r4(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2
              + q[3] * 2 + q[4] + q[5] + q[6] * 3),
        10: r4(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2
               + q[4] * 2 + q[5] + q[6] * 4),
        11: r4(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2
               + q[5] * 2 + q[6] * 5),
        12: r4(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2
               + q[6] * 7)}
    wide14 = fmask & flat & flat2
    wide8 = fmask & flat & ~flat2
    for idx in range(1, 13):
        put(idx, wide14, o14[idx])
    for idx in (4, 5, 6, 7, 8, 9):
        put(idx, wide8, o8[idx])
    for idx in (5, 6, 7, 8):
        put(idx, fmask & ~flat, nar[idx])
    return s


# --- full-frame DLF on the device --------------------------------------------------
# The complete level search + apply with the candidate levels as tensor
# operands. Dense formulation: every 4px boundary column maps to strided
# slices plane[:, k::4] (no gathers); writes are provably disjoint across
# boundaries (filter span is bounded by the minimum tx dim — spec 7.14),
# so masked strided stores reproduce the host's sequential edge writes.

def _dlf_thresholds_j(level, bd: int):
    """thresholds() with a tensor level (sharpness 0), scaled to ``bd``
    bits as the host's _edge_filter scales them."""
    limit = level.clamp(min=1)
    shift = bd - 8
    return ((2 * (level + 2) + limit) << shift, limit << shift,
            (level >> 4) << shift)


def _dlf_dir_pass_j(plane, txd_map, start, level, is_luma: bool,
                    w_eff: int, h_eff: int, bd: int):
    """One direction pass (vertical edges) over ``plane`` [H, W] int32.
    txd_map/start: [uh, uw] per-4px-unit tx dim along this direction and
    block-start flags (host dlf.build_tx_maps). level: 0-d tensor.
    Horizontal edges run this on the transposed plane/maps."""
    uh, uw = txd_map.shape
    uh = min(uh, h_eff // 4)
    uw = min(uw, w_eff // 4)
    blimit, limit, thresh = _dlf_thresholds_j(level, bd)

    # per-unit filter length from the tx dims across each boundary
    mn = torch.minimum(txd_map[:uh, 1:uw], txd_map[:uh, :uw - 1])
    if is_luma:
        lens = torch.where(mn <= 4, 4, torch.where(mn == 8, 8, 14))
    else:
        lens = torch.where(mn <= 4, 4, 6)
    active = start[:uh, 1:uw] & (level > 0)           # [uh, uw-1]

    # sample lines for every boundary: s[y, c, k] = plane[y, 4(c+1)+k-7]
    # = padded[y, 4c+4+k] — strided slices of an edge-replicated plane
    padded = torch.cat([plane[:, :1].expand(-1, 7), plane,
                        plane[:, -1:].expand(-1, 7)], dim=1)
    nb = uw - 1
    cols = [padded[:uh * 4, 4 + k:4 + k + 4 * nb:4] for k in range(14)]
    s = torch.stack(cols, dim=-1).to(torch.int32)     # [4uh, nb, 14]
    n = 4 * uh * nb
    s = s.reshape(n, 14)
    mask = active.repeat_interleave(4, dim=0).reshape(n)
    lens_r = lens.repeat_interleave(4, dim=0).reshape(n)

    out = s
    for L in ((4, 8, 14) if is_luma else (4, 6)):
        f = dlf_apply_len_batch(s, L, blimit, limit, thresh, bd)
        out = torch.where((mask & (lens_r == L))[:, None], f, out)

    # scatter back only genuinely-changed samples (equal-value skips are
    # no-ops, so `changed` is an exact write mask; disjointness makes
    # the per-offset stores race-free)
    out2 = out.reshape(4 * uh, nb, 14)
    changed = out2 != s.reshape(4 * uh, nb, 14)
    for k in range(1, 13):
        view = padded[:uh * 4, 4 + k:4 + k + 4 * nb:4]
        view.copy_(torch.where(changed[:, :, k], out2[:, :, k], view))
    return padded[:, 7:-7]


def _dlf_filter_plane_j(plane, maps, level, is_luma: bool, w_eff: int,
                        h_eff: int, bd: int):
    """Both direction passes (vertical first, as spec 7.14 orders)."""
    (txw, txh), sx, sy = maps
    work = plane.to(torch.int32)
    work = _dlf_dir_pass_j(work, txw, sx, level, is_luma, w_eff, h_eff,
                           bd)
    work = _dlf_dir_pass_j(work.t(), txh.t(), sy.t(), level, is_luma,
                           h_eff, w_eff, bd).t()
    return work.clamp(0, (1 << bd) - 1)


def make_dlf_search_apply(eff, bd: int):
    """Whole-frame DLF: pick luma + chroma levels by filtered SSE over 4
    candidate levels (host pick_levels twin: first-min over an ascending
    candidate vector reproduces its dedup+sorted scan) and apply the
    winners. The returned function takes tensors on one device and
    returns (y, u, v, ly, luv)."""
    (wy, hy), (wc, hc) = eff

    def program(y, u, v, sy_, su, sv, ymaps, cmaps, cands):
        def sse(a, b, w_e, h_e):
            d = a[:h_e, :w_e].to(torch.int64) - b[:h_e, :w_e].to(torch.int64)
            return (d * d).sum()

        src = [t.to(torch.int32) for t in (sy_, su, sv)]
        y32, u32, v32 = (t.to(torch.int32) for t in (y, u, v))
        ysses, csses = [], []
        for k in range(cands.shape[0]):
            lvl = cands[k]
            fy = _dlf_filter_plane_j(y32, ymaps, lvl, True, wy, hy, bd)
            ysses.append(sse(fy, src[0], wy, hy))
            fu = _dlf_filter_plane_j(u32, cmaps, lvl, False, wc, hc, bd)
            fv = _dlf_filter_plane_j(v32, cmaps, lvl, False, wc, hc, bd)
            csses.append(sse(fu, src[1], wc, hc) + sse(fv, src[2], wc, hc))
        ly = cands[torch.argmin(torch.stack(ysses))]
        luv = cands[torch.argmin(torch.stack(csses))]
        # spec: chroma filters/codes only when the luma level is nonzero
        luv = torch.where(ly > 0, luv, 0)
        oy = _dlf_filter_plane_j(y32, ymaps, ly, True, wy, hy, bd)
        ou = _dlf_filter_plane_j(u32, cmaps, luv, False, wc, hc, bd)
        ov = _dlf_filter_plane_j(v32, cmaps, luv, False, wc, hc, bd)
        return oy, ou, ov, ly, luv

    return program


def pix_dtype(bd: int) -> torch.dtype:
    """Upload dtype of pixel planes (narrow; widened on the device)."""
    return torch.uint8 if bd <= 8 else torch.int16


def plane_i32(plane, device) -> torch.Tensor:
    """A recon or source plane as int32: a numpy plane uploaded to
    ``device``, a tensor on its own device."""
    if isinstance(plane, torch.Tensor):
        return plane.to(torch.int32)
    return const(np.asarray(plane).astype(np.int32), device)


def write_plane(dst, t: torch.Tensor, h: int, w: int) -> None:
    """dst[:h, :w] = t in place, in dst's dtype (a numpy plane or a
    tensor, which stays on its device)."""
    if isinstance(dst, torch.Tensor):
        dst[:h, :w] = t.to(dst.dtype)
    else:
        dst[:h, :w] = t.cpu().numpy().astype(dst.dtype)


def dlf_search_apply_dev(recon_planes, src_planes, leaf_sizes, mi_rows,
                         mi_cols, qindex: int, bd: int = 8,
                         device="cuda"):
    """Deblocking level search + apply on ``device`` (host pick_levels +
    loop_filter_frame twin). Writes the filtered planes into
    ``recon_planes`` in place (numpy planes, or tensors on ``device``,
    which stay there); returns the (y, y, u, v) levels — identical
    integers to the host pair by construction."""
    from svt_av1_tpu_torch.ops import dlf
    g = dlf.level_guess(qindex, bd)
    cl = sorted({0, max(0, g // 2), g, min(63, (3 * g) // 2)})
    cands = np.asarray((cl + [cl[-1]] * 4)[:4], np.int32)
    pdt = pix_dtype(bd)

    def maps(plane):
        (txw, txh), sx, sy = dlf.build_tx_maps(leaf_sizes, mi_rows, mi_cols,
                                               plane)
        return ((const(txw, device), const(txh, device)),
                const(sx, device), const(sy, device))

    def planes(ps):
        return [p.to(pdt) if isinstance(p, torch.Tensor)
                else const(np.asarray(p).astype(np.int32), device).to(pdt)
                for p in ps]

    eff = ((mi_cols * 4, mi_rows * 4), (mi_cols * 2, mi_rows * 2))
    fn = make_dlf_search_apply(eff, bd)
    oy, ou, ov, ly, luv = fn(*planes(recon_planes), *planes(src_planes),
                             maps(0), maps(1), const(cands, device))
    for dst, t in zip(recon_planes, (oy, ou, ov)):
        if isinstance(dst, torch.Tensor):
            dst.copy_(t)
        else:
            dst[...] = t.cpu().numpy().astype(dst.dtype)
    ly, luv = int(ly), int(luv)
    if ly == 0:
        return (0, 0, 0, 0)
    return (ly, ly, luv, luv)


# --- CDEF and loop-restoration block twins ------------------------------------------
# (the JAX package's batched CDEF and LR twins over 8x8 blocks and stripe
# windows; the encoder's frame programs are ops/device_cdef.py and
# ops/device_lr.py. Integer arithmetic in int64; the direction search's
# projection is an fp64 product, exact for its 0/1 weights and 11-bit
# pixels.)

def cdef_find_dir_batch(blocks, coeff_shift: int):
    """Directions + variances for [B, 8, 8] blocks (device twin of
    ops.cdef.find_dir): (dirs [B] int32, vars [B] int64)."""
    from svt_av1_tpu_torch.ops.device_cdef import _find_dir_dense
    dirs, var = _find_dir_dense(blocks.to(torch.int32)[None], coeff_shift)
    return dirs[0].to(torch.int32), var[0]


def _cdef_constrain(diff, threshold, damping: int):
    """The CDEF constrain with per-block thresholds [B, 1, 1] (the shift
    from the exact floor(log2(threshold)), threshold 0 -> 0)."""
    from svt_av1_tpu_torch.ops.device_cdef import _msb_clip
    adiff = diff.abs()
    shift = (damping - _msb_clip(threshold.clamp_min(1), 30)).clamp_min(0)
    v = torch.minimum(adiff, (threshold - (adiff >> shift)).clamp_min(0))
    return torch.where(threshold == 0, 0, torch.sign(diff) * v)


def cdef_filter_blocks(windows, pri, sec, dirs, pri_damping: int,
                       sec_damping: int, coeff_shift: int):
    """Filter [B, 8+6, 8+6] padded windows (3 px CDEF_VERY_LARGE borders)
    with per-block strengths pri/sec [B] and directions [B] (device twin
    of ops.cdef.filter_block for 8x8 blocks). Returns [B, 8, 8] int64."""
    from svt_av1_tpu_torch.ops.cdef import (CDEF_VERY_LARGE, DIR_OFFSETS,
                                            PRI_TAPS, SEC_TAPS)
    b, _, ww = windows.shape
    device = windows.device
    w = windows.to(torch.int64)
    x = w[:, 3:11, 3:11]
    offs = const(np.array(DIR_OFFSETS, dtype=np.int64), device)  # [8,2,2]
    pri_t = const(np.array(PRI_TAPS, dtype=np.int64), device)
    sec_t = const(np.array(SEC_TAPS, dtype=np.int64), device)
    tap_idx = (pri.long() >> coeff_shift) & 1
    ar8 = torch.arange(8, device=device)
    flat = w.reshape(b, -1)

    def gather(dy, dx):
        """Per-block shifted 8x8 window: dy/dx [B]."""
        iy = 3 + dy[:, None, None] + ar8[None, :, None]
        ix = 3 + dx[:, None, None] + ar8[None, None, :]
        return flat.gather(1, (iy * ww + ix).reshape(b, -1)).reshape(b, 8, 8)

    dirs = dirs.long()
    d_off = offs[dirs]                                  # [B, 2, 2]
    pri_b = pri.long()[:, None, None]
    sec_b = sec.long()[:, None, None]
    s = torch.zeros((b, 8, 8), dtype=torch.int64, device=device)
    mx = mn = x
    for k in range(2):
        ptap = pri_t[tap_idx, k][:, None, None]
        stap = sec_t[tap_idx, k][:, None, None]
        for sgn in (1, -1):
            p = gather(sgn * d_off[:, k, 0], sgn * d_off[:, k, 1])
            s = s + ptap * _cdef_constrain(p - x, pri_b, pri_damping)
            mx = torch.maximum(mx, torch.where(p == CDEF_VERY_LARGE, mx, p))
            mn = torch.minimum(mn, p)
            for od in (2, 6):
                d2 = offs[(dirs + od) & 7]
                q = gather(sgn * d2[:, k, 0], sgn * d2[:, k, 1])
                s = s + stap * _cdef_constrain(q - x, sec_b, sec_damping)
                mx = torch.maximum(mx, torch.where(q == CDEF_VERY_LARGE,
                                                   mx, q))
                mn = torch.minimum(mn, q)
    out = x + ((8 + s - (s < 0).long()) >> 4)
    return torch.minimum(torch.maximum(out, mn), mx)


def _round2t(x, n: int):
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def wiener_filter_batch(src_ext, taps_v, taps_h, bd: int = 8):
    """[B, h+6, w+6] windows -> [B, h, w] int64 (twin of
    restoration.wiener_filter; taps are python triples)."""
    from svt_av1_tpu_torch.ops import restoration as rst
    fv = rst.wiener_taps7(taps_v)
    fh = rst.wiener_taps7(taps_h)
    r0 = 3 if bd < 12 else 5
    r1 = 2 * rst.WIENER_FILT_PREC_BITS - r0
    bn, h, w = src_ext.shape[0], src_ext.shape[1] - 6, src_ext.shape[2] - 6
    s = src_ext.to(torch.int64)
    hsum = torch.full((bn, h + 6, w), 1 << (bd + rst.WIENER_FILT_PREC_BITS
                                            - 1),
                      dtype=torch.int64, device=s.device)
    for k in range(7):
        hsum = hsum + int(fh[k]) * s[:, :, k:k + w]
    mid = _round2t(hsum, r0).clamp(
        0, (1 << (bd + 1 + rst.WIENER_FILT_PREC_BITS - r0)) - 1)
    vsum = torch.zeros((bn, h, w), dtype=torch.int64, device=s.device)
    for k in range(7):
        vsum = vsum + int(fv[k]) * mid[:, k:k + h]
    vsum = vsum - (1 << (bd + r1 - 1))
    return _round2t(vsum, r1).clamp(0, (1 << bd) - 1)


def _winsum_t(x, r: int):
    """Batched full-window sums [B, H, W] -> [B, H-2r, W-2r]."""
    n = 2 * r + 1
    v = torch.cumsum(x, dim=1)
    v = torch.cat([v[:, n - 1:n], v[:, n:] - v[:, :-n]], dim=1)
    hs = torch.cumsum(v, dim=2)
    return torch.cat([hs[:, :, n - 1:n], hs[:, :, n:] - hs[:, :, :-n]],
                     dim=2)


def _sgr_ab_t(dgd_ext, r: int, s: int, h: int, w: int, bd: int):
    from svt_av1_tpu_torch.ops import restoration as rst
    d = dgd_ext.to(torch.int64)
    i0 = 2 - r
    a_ = _winsum_t(d * d, r)[:, i0:i0 + h + 2, i0:i0 + w + 2]
    b_ = _winsum_t(d, r)[:, i0:i0 + h + 2, i0:i0 + w + 2]
    n = (2 * r + 1) * (2 * r + 1)
    a = _round2t(a_, 2 * (bd - 8))
    b = _round2t(b_, bd - 8)
    p = (a * n - b * b).clamp_min(0)
    z = _round2t(p * s, rst.SGRPROJ_MTABLE_BITS)
    a2 = const(rst._X_BY_XPLUS1.astype(np.int64), d.device)[
        z.clamp_max(255)]
    b2 = _round2t((256 - a2) * b_ * int(rst._ONE_BY_X[n - 1]),
                  rst.SGRPROJ_RECIP_BITS)
    return a2, b2


def sgr_filter_batch(dgd_ext, ep: int, xqd, bd: int = 8):
    """[B, h+6, w+6] -> [B, h, w] int64 (twin of restoration.sgr_filter;
    ep/xqd python values)."""
    from svt_av1_tpu_torch.ops import restoration as rst
    (r0, r1), (s0, s1) = rst.SGR_PARAMS[ep]
    h, w = dgd_ext.shape[1] - 6, dgd_ext.shape[2] - 6
    d = dgd_ext[:, 3:3 + h, 3:3 + w].to(torch.int64)
    u = d << rst.SGRPROJ_RST_BITS
    v = u << rst.SGRPROJ_PRJ_BITS
    xq = rst.decode_xq(xqd, ep)
    m, lf, rt = slice(1, w + 1), slice(0, w), slice(2, w + 2)
    if r0 > 0:
        A, B = _sgr_ab_t(dgd_ext, r0, s0, h, w, bd)
        out = torch.zeros((dgd_ext.shape[0], h, w), dtype=torch.int64,
                          device=d.device)
        ev = torch.arange(0, h, 2, device=d.device)

        def five(T, rows):
            return T[:, rows][:, :, lf] + T[:, rows][:, :, rt]

        a = (A[:, ev][:, :, m] + A[:, ev + 2][:, :, m]) * 6 \
            + (five(A, ev) + five(A, ev + 2)) * 5
        bb = (B[:, ev][:, :, m] + B[:, ev + 2][:, :, m]) * 6 \
            + (five(B, ev) + five(B, ev + 2)) * 5
        out[:, 0::2] = _round2t(a * d[:, 0::2] + bb, rst.SGRPROJ_SGR_BITS
                                + 5 - rst.SGRPROJ_RST_BITS)
        od = torch.arange(1, h, 2, device=d.device) + 1
        a = A[:, od][:, :, m] * 6 + five(A, od) * 5
        bb = B[:, od][:, :, m] * 6 + five(B, od) * 5
        out[:, 1::2] = _round2t(a * d[:, 1::2] + bb, rst.SGRPROJ_SGR_BITS
                                + 4 - rst.SGRPROJ_RST_BITS)
        v = v + xq[0] * (out - u)
    if r1 > 0:
        A, B = _sgr_ab_t(dgd_ext, r1, s1, h, w, bd)
        c, up, dn = slice(1, h + 1), slice(0, h), slice(2, h + 2)

        def cross(T):
            return (T[:, c, m] + T[:, c, lf] + T[:, c, rt] + T[:, up, m]
                    + T[:, dn, m]) * 4 \
                + (T[:, up, lf] + T[:, up, rt] + T[:, dn, lf]
                   + T[:, dn, rt]) * 3

        flt = _round2t(cross(A) * d + cross(B), rst.SGRPROJ_SGR_BITS + 5
                       - rst.SGRPROJ_RST_BITS)
        v = v + xq[1] * (flt - u)
    out = _round2t(v, rst.SGRPROJ_PRJ_BITS + rst.SGRPROJ_RST_BITS)
    return out.clamp(0, (1 << bd) - 1)
