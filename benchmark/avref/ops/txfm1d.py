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
from typing import List, Tuple

import numpy as np

_DATA = Path(__file__).parent / "data" / "txfm_networks.npz"

COS_BIT_MIN = 10
NEW_SQRT2 = 5793
NEW_SQRT2_BITS = 12
NEW_INV_SQRT2 = 2896


@functools.lru_cache(maxsize=1)
def _tables() -> dict:
    with np.load(_DATA) as z:
        return {k: z[k] for k in z.files}


def round_shift(x, bit: int):
    """(x + (1 << (bit-1))) >> bit with arithmetic shift (spec Round2)."""
    return (x + (1 << (bit - 1))) >> bit


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


@functools.lru_cache(maxsize=256)
def _resolved(key: str, cos_bit: int, clamp_bit: int):
    """Per stage of network ``key``: (a, b, w0, w1, btf mask or None when
    every op is a butterfly, clamp mask or None) with the butterfly
    weights resolved against the cospi table of ``cos_bit``."""
    cospi = _tables()["cospi"][cos_bit - COS_BIT_MIN]
    out = []
    for a, b, w0, w1, kind in _stages(key):
        is_btf = kind == 1
        # btf ops store sign*(cospi_index+1)
        w0v = np.where(is_btf, np.sign(w0) * cospi[np.abs(w0) - 1], w0)
        w1v = np.where(is_btf, np.sign(w1) * cospi[np.abs(w1) - 1], w1)
        clamp = kind == 2
        out.append((a, b, w0v[None, :], w1v[None, :],
                    None if is_btf.all() else is_btf[None, :],
                    clamp[None, :] if clamp.any() else None))
    return tuple(out)


def exec_network(x: np.ndarray, key: str, cos_bit: int,
                 clamp_bit: int) -> np.ndarray:
    """Run butterfly network ``key`` over batched rows ``x`` [batch, N].

    clamp_bit: stage clamp range for kind-2 ops (inverse: 16 for bd=8 —
    av1_gen_inv_stage_range; forward networks contain no kind-2 ops).
    """
    x = x.astype(np.int64)
    rnd = 1 << (cos_bit - 1)
    if clamp_bit > 0:
        lo, hi = -(1 << (clamp_bit - 1)), (1 << (clamp_bit - 1)) - 1
    for a, b, w0v, w1v, is_btf, clamp in _resolved(key, cos_bit,
                                                   clamp_bit):
        t = w0v * x[:, a] + w1v * x[:, b]
        if is_btf is None:
            t = (t + rnd) >> cos_bit
        else:
            t = np.where(is_btf, (t + rnd) >> cos_bit, t)
        if clamp is not None:
            t = np.where(clamp, np.minimum(np.maximum(t, lo), hi), t)
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
    return exec_network(x, key, cos_bit, clamp_bit)
