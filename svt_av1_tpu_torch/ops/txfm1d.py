"""Batched 1D AV1 transform engine (host NumPy, bit-exact oracle).

Executes the extracted butterfly networks (``data/txfm_networks.npz``, see
``tools/extract_txfm_networks.py``) as vectorized stage passes over
``[batch, N]`` int64 arrays — the same data layout the JAX/Pallas device
engine uses. Inverse networks are normative (AV1 spec 7.13.2; reference
behavior ``EbTransforms.c:4902ff``); forward ones are the standard libaom
encoder-side transforms.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from svt_av1_tpu_torch.utils.trace import setup_step

_DATA = Path(__file__).parent / "data" / "txfm_networks.npz"

COS_BIT_MIN = 10
NEW_SQRT2 = 5793
NEW_SQRT2_BITS = 12
NEW_INV_SQRT2 = 2896


@functools.lru_cache(maxsize=1)
def _tables() -> dict:
    with setup_step("tables"), np.load(_DATA) as z:
        return {k: z[k] for k in z.files}


def round_shift(x, bit: int):
    """(x + (1 << (bit-1))) >> bit with arithmetic shift (spec Round2)."""
    return (x + (1 << (bit - 1))) >> bit


def _clamp(x, bit: int):
    lo, hi = -(1 << (bit - 1)), (1 << (bit - 1)) - 1
    return np.clip(x, lo, hi)


@functools.lru_cache(maxsize=64)
def _stages(key: str) -> List[Tuple[np.ndarray, ...]]:
    """Preprocess a network into per-stage (a, b, w0, w1, kind) arrays,
    ordered by output index."""
    net = _tables()["net_" + key]
    out = []
    for s in np.unique(net[:, 0]):
        rows = net[net[:, 0] == s]
        rows = rows[np.argsort(rows[:, 1])]  # order by output index
        out.append((rows[:, 2].copy(), rows[:, 3].copy(), rows[:, 4].copy(),
                    rows[:, 5].copy(), rows[:, 6].copy()))
    return out


@functools.lru_cache(maxsize=128)
def _flat_stages(key: str, cos_bit: int):
    """Flattened stage tables with weights resolved against the cospi
    table — the operand layout of the native executor
    (native/svt_txfm.c)."""
    cospi = _tables()["cospi"][cos_bit - COS_BIT_MIN]
    stages = _stages(key)
    n = len(stages[0][0])
    ns = len(stages)
    a = np.empty((ns, n), dtype=np.int32)
    b = np.empty((ns, n), dtype=np.int32)
    w0 = np.empty((ns, n), dtype=np.int64)
    w1 = np.empty((ns, n), dtype=np.int64)
    kd = np.empty((ns, n), dtype=np.int8)
    for i, (sa, sb, sw0, sw1, sk) in enumerate(stages):
        is_btf = sk == 1
        a[i] = sa
        b[i] = sb
        w0[i] = np.where(is_btf, np.sign(sw0) * cospi[np.abs(sw0) - 1], sw0)
        w1[i] = np.where(is_btf, np.sign(sw1) * cospi[np.abs(sw1) - 1], sw1)
        kd[i] = sk
    arrs = tuple(np.ascontiguousarray(v) for v in (a, b, w0, w1, kd))
    # raw data pointers cached with the (referenced, hence live) arrays
    # so the hot path skips per-call ctypes pointer construction
    return arrs, tuple(v.ctypes.data for v in arrs), ns, n


_NATIVE = None


def _native_lib():
    global _NATIVE
    if _NATIVE is None:
        try:
            import ctypes
            from svt_av1_tpu_torch import native
            lib = native.lib()
            lib.svt_txfm_exec.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
            lib.svt_txfm_exec.restype = None
            _NATIVE = lib
        except Exception:
            _NATIVE = False
    return _NATIVE


def exec_network_native(x: np.ndarray, key: str, cos_bit: int,
                        clamp_bit: int) -> np.ndarray:
    lib = _native_lib()
    _arrs, (pa, pb, pw0, pw1, pkd), ns, n = _flat_stages(key, cos_bit)
    out = np.ascontiguousarray(x, dtype=np.int64)
    lib.svt_txfm_exec(out.ctypes.data, out.shape[0], n, ns,
                      pa, pb, pw0, pw1, pkd, cos_bit, max(clamp_bit, 2))
    return out


def exec_network(x: np.ndarray, key: str, cos_bit: int,
                 clamp_bit: int) -> np.ndarray:
    """Run butterfly network ``key`` over batched rows ``x`` [batch, N].

    clamp_bit: stage clamp range for kind-2 ops (inverse: 16 for bd=8 —
    av1_gen_inv_stage_range; forward networks contain no kind-2 ops).
    """
    cospi = _tables()["cospi"][cos_bit - COS_BIT_MIN]
    x = x.astype(np.int64)
    for a, b, w0, w1, kind in _stages(key):
        xa = x[:, a]
        xb = x[:, b]
        is_btf = kind == 1
        # resolve weights: btf ops store sign*(cospi_index+1)
        w0v = np.where(is_btf, np.sign(w0) * cospi[np.abs(w0) - 1], w0)
        w1v = np.where(is_btf, np.sign(w1) * cospi[np.abs(w1) - 1], w1)
        t = w0v[None, :] * xa + w1v[None, :] * xb
        t = np.where(is_btf[None, :], round_shift(t, cos_bit), t)
        if (kind == 2).any():
            t = np.where((kind == 2)[None, :], _clamp(t, clamp_bit), t)
        x = t
    return x


# --- sinpi-based 4-point ADST (hand-coded per reference :2764/:5534) -----------
def fadst4(x: np.ndarray, cos_bit: int) -> np.ndarray:
    sinpi = _tables()["sinpi"][cos_bit - COS_BIT_MIN]
    x = x.astype(np.int64)
    x0, x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
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
    o0 = round_shift(t0 + t3, cos_bit)
    o1 = round_shift(t1, cos_bit)
    o2 = round_shift(t2 - t3, cos_bit)
    o3 = round_shift(t2 - t0 + t3, cos_bit)
    out = np.stack([o0, o1, o2, o3], axis=1)
    return np.where((x != 0).any(axis=1, keepdims=True), out, 0)


def iadst4(x: np.ndarray, cos_bit: int) -> np.ndarray:
    sinpi = _tables()["sinpi"][cos_bit - COS_BIT_MIN]
    x = x.astype(np.int64)
    x0, x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
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
    o0 = round_shift(t0 + t3, cos_bit)
    o1 = round_shift(t1 + t3, cos_bit)
    o2 = round_shift(t2, cos_bit)
    o3 = round_shift(t0 + t1 - t3, cos_bit)
    out = np.stack([o0, o1, o2, o3], axis=1)
    return np.where((x != 0).any(axis=1, keepdims=True), out, 0)


# --- identity transforms --------------------------------------------------------
_ID_SCALE = {4: (NEW_SQRT2, NEW_SQRT2_BITS), 8: (2, 0),
             16: (2 * NEW_SQRT2, NEW_SQRT2_BITS), 32: (4, 0),
             64: (4 * NEW_SQRT2, NEW_SQRT2_BITS)}


def identity(x: np.ndarray, n: int) -> np.ndarray:
    mult, bits = _ID_SCALE[n]
    x = x.astype(np.int64) * mult
    return round_shift(x, bits) if bits else x


# --- dispatch -------------------------------------------------------------------
def run_1d(x: np.ndarray, kind: str, n: int, cos_bit: int, inverse: bool,
           clamp_bit: int = 0) -> np.ndarray:
    """kind in {'dct','adst','identity'}; x is [batch, n]."""
    if kind == "identity":
        return identity(x, n)
    if kind == "adst" and n == 4:
        return (iadst4 if inverse else fadst4)(x, cos_bit)
    key = ("i" if inverse else "f") + ("dct" if kind == "dct" else "adst") \
        + str(n)
    if _native_lib():
        return exec_network_native(x, key, cos_bit, clamp_bit)
    return exec_network(x, key, cos_bit, clamp_bit)
