"""Motion-vector syntax reader (NMV).

The default nmv context is ``EbCabacContextModel.c:899`` (normative spec
constants). MVs are in 1/8-pel units; the coded value is the difference to
the MV predictor.
"""

from __future__ import annotations

import numpy as np

MV_JOINT_ZERO = 0     # zero vector
MV_JOINT_HNZVZ = 1    # horizontal nonzero, vertical zero
MV_JOINT_HZVNZ = 2    # horizontal zero, vertical nonzero
MV_JOINT_HNZVNZ = 3   # both nonzero

MV_CLASSES = 11
CLASS0_SIZE = 2
MV_MAX = (1 << 14) - 1  # spec: component range +-2^14-1 (1/8 pel)


def _icdf(*probs):
    """AOM_CDFn(a, b, ...) -> inverse-CDF row with adaptation counter."""
    return np.array([32768 - p for p in probs] + [0, 0], dtype=np.int32)


def _default_component():
    return {
        "classes": _icdf(28672, 30976, 31858, 32320, 32551, 32656, 32740,
                         32757, 32762, 32767),
        "class0_fp": np.stack([_icdf(16384, 24576, 26624),
                               _icdf(12288, 21248, 24128)]),
        "fp": _icdf(8192, 17408, 21248),
        "sign": _icdf(128 * 128),
        "class0_hp": _icdf(160 * 128),
        "hp": _icdf(128 * 128),
        "class0": _icdf(216 * 128),
        "bits": np.stack([_icdf(128 * v) for v in
                          (136, 140, 148, 160, 176, 192, 224, 234, 234,
                           240)]),
    }


class NmvContext:
    """Mutable CDF state for MV coding (one per frame)."""

    def __init__(self):
        self.joints = _icdf(4096, 11264, 19328)
        self.comps = [_default_component(), _default_component()]

    def copy(self):
        new = object.__new__(NmvContext)
        new.joints = self.joints.copy()
        new.comps = [{k: v.copy() for k, v in c.items()}
                     for c in self.comps]
        return new


def _read_component(r, comp_cdfs, allow_hp: bool, force_integer: bool) -> int:
    sign = r.read_symbol(comp_cdfs["sign"], 2)
    cls = r.read_symbol(comp_cdfs["classes"], MV_CLASSES)
    if cls == 0:
        int_part = r.read_symbol(comp_cdfs["class0"], 2)
    else:
        int_part = 0
        for i in range(cls):
            int_part |= r.read_symbol(comp_cdfs["bits"][i], 2) << i
    if force_integer:
        fr = 3
    else:
        cdf = comp_cdfs["class0_fp"][int_part] if cls == 0 \
            else comp_cdfs["fp"]
        fr = r.read_symbol(cdf, 4)
    if allow_hp and not force_integer:
        cdf = comp_cdfs["class0_hp"] if cls == 0 else comp_cdfs["hp"]
        hp = r.read_symbol(cdf, 2)
    else:
        hp = 1
    base = 0 if cls == 0 else CLASS0_SIZE << (cls + 2)
    mag = base + ((int_part << 3) | (fr << 1) | hp) + 1
    return -mag if sign else mag


def read_mv(r, nmv: NmvContext, allow_hp: bool = False,
            force_integer: bool = False):
    joint = r.read_symbol(nmv.joints, 4)
    dr = _read_component(r, nmv.comps[0], allow_hp, force_integer) \
        if joint in (MV_JOINT_HZVNZ, MV_JOINT_HNZVNZ) else 0
    dc = _read_component(r, nmv.comps[1], allow_hp, force_integer) \
        if joint in (MV_JOINT_HNZVZ, MV_JOINT_HNZVNZ) else 0
    return dr, dc
