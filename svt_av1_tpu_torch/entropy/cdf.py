"""Frame entropy context: the adaptive CDF state for one tile/frame.

Mirrors the role of the reference's FRAME_CONTEXT (``EbCabacContextModel.c``
init_mode_probs:959 / av1_default_coef_probs:4446): default tables are loaded
from the extracted spec constants (``data/default_cdfs.npz``, see
``tools/extract_cdf_tables.py``) and re-initialized per keyframe / per tile.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from svt_av1_tpu_torch.utils.trace import setup_step

_DATA = Path(__file__).parent / "data" / "default_cdfs.npz"


@functools.lru_cache(maxsize=1)
def default_tables() -> dict:
    with setup_step("tables"), np.load(_DATA) as z:
        return {k: z[k] for k in z.files}


def coef_qctx(base_qindex: int) -> int:
    """qindex bucket selecting the default coefficient CDF set
    (reference: av1_default_coef_probs ``EbCabacContextModel.c:4446``)."""
    if base_qindex <= 20:
        return 0
    if base_qindex <= 60:
        return 1
    if base_qindex <= 120:
        return 2
    return 3


class FrameContext:
    """Mutable CDF state for coding one frame (or one tile).

    Attribute names follow the AV1 syntax element they code. Every array's
    last axis is ``nsyms + 1`` (the extra slot is the adaptation counter).
    """

    # (attr, table key, qindex-dependent)
    _LAYOUT = [
        ("kf_y_mode", "kf_y_mode", False),
        ("if_y_mode", "if_y_mode", False),
        ("uv_mode", "uv_mode", False),
        ("angle_delta", "angle_delta", False),
        ("partition", "partition", False),
        ("skip", "skip", False),
        ("intra_ext_tx", "intra_ext_tx", False),
        ("inter_ext_tx", "inter_ext_tx", False),
        ("cfl_sign", "cfl_sign", False),
        ("cfl_alpha", "cfl_alpha", False),
        ("filter_intra", "filter_intra", False),
        ("filter_intra_mode", "filter_intra_mode", False),
        ("tx_size", "tx_size", False),
        ("txfm_partition", "txfm_partition", False),
        ("delta_q", "delta_q", False),
        ("intra_inter", "intra_inter", False),
        ("skip_mode", "skip_mode", False),
        ("newmv", "newmv", False),
        ("zeromv", "zeromv", False),
        ("refmv", "refmv", False),
        ("drl", "drl", False),
        ("comp_inter", "comp_inter", False),
        ("single_ref", "single_ref", False),
        ("comp_ref_type", "comp_ref_type", False),
        ("comp_ref", "comp_ref", False),
        ("comp_bwdref", "comp_bwdref", False),
        ("inter_compound_mode", "inter_compound_mode", False),
        ("switchable_interp", "switchable_interp", False),
        ("switchable_restore", "switchable_restore", False),
        ("wiener_restore", "wiener_restore", False),
        ("sgrproj_restore", "sgrproj_restore", False),
        # coefficient CDFs (selected by qindex bucket)
        ("txb_skip", "txb_skip", True),
        ("eob_extra", "eob_extra", True),
        ("dc_sign", "dc_sign", True),
        ("coeff_br", "coeff_br", True),
        ("coeff_base", "coeff_base", True),
        ("coeff_base_eob", "coeff_base_eob", True),
        ("eob_pt_16", "eob_pt_16", True),
        ("eob_pt_32", "eob_pt_32", True),
        ("eob_pt_64", "eob_pt_64", True),
        ("eob_pt_128", "eob_pt_128", True),
        ("eob_pt_256", "eob_pt_256", True),
        ("eob_pt_512", "eob_pt_512", True),
        ("eob_pt_1024", "eob_pt_1024", True),
    ]

    def __init__(self, base_qindex: int):
        tabs = default_tables()
        qctx = coef_qctx(base_qindex)
        for attr, key, qdep in self._LAYOUT:
            src = tabs[key][qctx] if qdep else tabs[key]
            setattr(self, attr, np.array(src, dtype=np.int32, copy=True))

    def copy(self) -> "FrameContext":
        new = object.__new__(FrameContext)
        for attr, _, _ in self._LAYOUT:
            setattr(new, attr, getattr(self, attr).copy())
        return new

    def equals(self, other: "FrameContext") -> bool:
        return all(np.array_equal(getattr(self, a), getattr(other, a))
                   for a, _, _ in self._LAYOUT)
