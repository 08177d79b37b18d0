"""The in-loop post-filters after deblocking: CDEF, then loop restoration.

Both frame encoders (``pipeline/wavefront.py``, ``pipeline/inter.py``) run
the JAX package's chain after DLF: the deblocked stripe-boundary lines
that LR reads are saved first, then CDEF filters the recon, then LR
searches and filters the CDEF output. Both filters write into the recon
planes in place on the config's device (numpy planes, or tensors that
stay on their device, which the reference slots then hold); only CDEF's
index map, the boundary lines and LR's statistics come to the host.
"""

from __future__ import annotations

import numpy as np

from svt_av1_tpu_torch.ops import device_cdef, device_lr
from svt_av1_tpu_torch.pipeline import common, lr_search
from svt_av1_tpu_torch.utils.trace import span


def cdef_skip8(tiles, mi_rows: int, mi_cols: int) -> np.ndarray:
    """The all-skip 8x8 luma units CDEF leaves alone: those whose four mi
    units all lie in leaves that code no coefficient in any plane.
    ``tiles``: per tile (leaf_sizes, leaf_index, eobs, mi_r0, mi_c0), the
    leaves at tile-local positions."""
    skip = np.zeros((mi_rows, mi_cols), dtype=bool)
    for leaf_sizes, leaf_index, eobs, mi_r0, mi_c0 in tiles:
        for (r, c), s in leaf_sizes.items():
            if eobs[:, leaf_index[(r, c)]].sum() == 0:
                lw, lh = common.leaf_wh(s)
                skip[r + mi_r0:r + mi_r0 + (lh >> 2),
                     c + mi_c0:c + mi_c0 + (lw >> 2)] = True
    return skip[0::2, 0::2] & skip[0::2, 1::2] & skip[1::2, 0::2] \
        & skip[1::2, 1::2]


def write_cdef_idx(w, idx_map, written: set, mi_row: int, mi_col: int,
                   tile_mi_off, skip: int) -> None:
    """The cdef_idx literal at the first non-skip block of each 64x64
    (spec read_cdef mirror); ``written`` holds the SBs of the tile already
    coded, ``tile_mi_off`` the tile's frame position in mi units."""
    if idx_map is None or skip:
        return
    sb = ((mi_row + tile_mi_off[0]) // 16, (mi_col + tile_mi_off[1]) // 16)
    if sb not in written:
        written.add(sb)
        w.write_literal(int(idx_map[sb]), 2)


def run_postfilters(cfg, recon, src, tiles, mi_rows: int, mi_cols: int,
                    lam: float):
    """CDEF (span ``cdef``) then LR (span ``lr``) on the deblocked padded
    ``recon`` planes, in place, as the config enables them. ``tiles``:
    the coded leaves, per tile (leaf_sizes, leaf_index, eobs [3, n],
    mi_r0, mi_c0). Returns (cdef index map or None, the frame header's
    CDEF fields, the per-plane RestorationInfo or None, its
    ``lr_params`` field)."""
    bounds = None
    if cfg.enable_restoration:
        # the deblocked lines, before CDEF changes them (the decoder
        # saves them at the same point)
        bounds = []
        for p in range(3):
            ss = 1 if p else 0
            bounds.append(device_lr.deblock_bounds_dev(
                recon[p], (cfg.height + ss) >> ss, (cfg.width + ss) >> ss,
                ss))
    idx_map, cdef_kw = None, {}
    if cfg.enable_cdef:
        skip8 = cdef_skip8(tiles, mi_rows, mi_cols)
        with span("cdef"):
            idx_map, y_str, uv_str, damping = \
                device_cdef.cdef_search_apply_dev(
                    recon, src, skip8, mi_rows, mi_cols, cfg.base_q_idx,
                    cfg.bit_depth, device=cfg.device)
        cdef_kw = dict(cdef_damping=damping, cdef_bits=2,
                       cdef_y_strengths=y_str, cdef_uv_strengths=uv_str)
    rinfos, lr_kw = None, {}
    if cfg.enable_restoration:
        with span("lr"):
            rinfos = lr_search.search_restoration_dev(
                recon, src, bounds, cfg.width, cfg.height, cfg.bit_depth,
                cfg.base_q_idx, lam, device=cfg.device)
        lr_kw = dict(lr_params=(
            tuple(ri.frame_restoration_type for ri in rinfos),
            rinfos[0].unit_size, rinfos[1].unit_size))
    return idx_map, cdef_kw, rinfos, lr_kw
