"""Film grain synthesis (normative, output-stage).

Reference behavior: ``grainSynthesis.c`` — LFSR random generator (:441),
generate_luma_grain_block (:465), generate_chroma_grain_blocks (:500),
init_scaling_function (:595), add_noise_to_block (:625),
av1_add_film_grain_run (:995). The gaussian_sequence table is the
normative spec constant (extracted by tools/extract_grain_tables.py).

Scope: overlap_flag = 0 (no boundary blending — a legal parameter choice
that keeps block application embarrassingly parallel), 4:2:0.
Grain is applied to *display output only*; reference buffers stay clean
(spec: film grain operates at output).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import List, Tuple

import numpy as np

from svt_av1_tpu_torch.utils.trace import setup_step

_DATA = Path(__file__).parent / "data" / "grain_tables.npz"
GAUSS_BITS = 11


@functools.lru_cache(maxsize=1)
def gaussian_sequence() -> np.ndarray:
    with setup_step("tables"), np.load(_DATA) as z:
        return z["gaussian_sequence"].copy()


@dataclasses.dataclass
class FilmGrainParams:
    apply_grain: bool = True
    grain_seed: int = 45231
    num_y_points: int = 2
    scaling_points_y: Tuple = ((0, 16), (255, 16))
    chroma_scaling_from_luma: bool = False
    num_cb_points: int = 0
    scaling_points_cb: Tuple = ()
    num_cr_points: int = 0
    scaling_points_cr: Tuple = ()
    scaling_shift: int = 8        # grain_scaling_minus_8 + 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: Tuple = ()
    ar_coeffs_cb: Tuple = ()
    ar_coeffs_cr: Tuple = ()
    ar_coeff_shift: int = 6       # ar_coeff_shift_minus_6 + 6
    grain_scale_shift: int = 0
    cb_mult: int = 128
    cb_luma_mult: int = 192
    cb_offset: int = 256
    cr_mult: int = 128
    cr_luma_mult: int = 192
    cr_offset: int = 256
    overlap_flag: bool = False
    clip_to_restricted_range: bool = False


class _Lfsr:
    def __init__(self, seed: int):
        self.reg = seed & 0xFFFF

    def init_row(self, luma_line: int, seed: int) -> None:
        self.reg = seed & 0xFFFF
        luma_num = luma_line >> 5
        self.reg ^= ((luma_num * 37 + 178) & 255) << 8
        self.reg ^= (luma_num * 173 + 105) & 255

    def bits(self, n: int) -> int:
        r = self.reg
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.reg = r
        return (r >> (16 - n)) & ((1 << n) - 1)


def _ar_positions(lag: int):
    """pred_pos_luma ordering (row-major over the causal neighborhood)."""
    pos = []
    for dy in range(-lag, 1):
        for dx in range(-lag, lag + 1):
            if dy == 0 and dx >= 0:
                break
            pos.append((dy, dx))
    return pos


def _generate_grain(params: FilmGrainParams, bd: int):
    """(luma_grain [73, 82], cb_grain [38, 44], cr_grain [38, 44])
    — the 4:2:0 template blocks (top/left pad 9/9 luma incl. AR padding)."""
    gauss = gaussian_sequence()
    shift = 12 - bd + params.grain_scale_shift
    grain_center = 128 << (bd - 8)
    gmin, gmax = -grain_center, (256 << (bd - 8)) - 1 - grain_center
    lag = params.ar_coeff_lag
    ar_pad = 3  # constant in reference (ar_padding)
    lbs_y = ar_pad * 2 + 64 + ar_pad  # 73 when pads per reference
    # reference: top_pad=3, left/right handled via stride; use its dims:
    top_pad = left_pad = right_pad = 3
    bottom_pad = 0
    h = top_pad + 2 * ar_pad + 64 + bottom_pad        # 73
    w = left_pad + 2 * ar_pad + 64 + 2 * ar_pad + right_pad  # 82

    rng = _Lfsr(params.grain_seed)

    def white(hh, ww):
        out = np.empty((hh, ww), dtype=np.int64)
        half = (1 << shift) >> 1
        for i in range(hh):
            for j in range(ww):
                out[i, j] = (int(gauss[rng.bits(GAUSS_BITS)]) + half) >> shift
        return out

    luma = np.zeros((h, w), dtype=np.int64)
    if params.num_y_points > 0:
        luma = white(h, w)
        if lag > 0:
            pos = _ar_positions(lag)
            ro = 1 << (params.ar_coeff_shift - 1)
            for i in range(top_pad, h - bottom_pad):
                for j in range(left_pad, w - right_pad):
                    ws = sum(c * luma[i + dy, j + dx]
                             for c, (dy, dx) in zip(params.ar_coeffs_y, pos))
                    luma[i, j] = np.clip(
                        luma[i, j] + ((ws + ro) >> params.ar_coeff_shift),
                        gmin, gmax)

    # chroma (4:2:0): template 38x44
    ch = top_pad + ar_pad + 32 + bottom_pad            # 38
    cw = left_pad + ar_pad + 32 + ar_pad + right_pad   # 44
    cb = np.zeros((ch, cw), dtype=np.int64)
    cr = np.zeros((ch, cw), dtype=np.int64)
    if params.num_cb_points or params.chroma_scaling_from_luma:
        rng.init_row(7 << 5, params.grain_seed)
        cb = white(ch, cw)
    if params.num_cr_points or params.chroma_scaling_from_luma:
        rng.init_row(11 << 5, params.grain_seed)
        cr = white(ch, cw)
    # (chroma AR with lag > 0 lands with noise-model estimation)
    return luma, cb, cr


def _scaling_lut(points) -> np.ndarray:
    lut = np.zeros(256, dtype=np.int64)
    if not points:
        return lut
    pts = list(points)
    lut[:pts[0][0]] = pts[0][1]
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        dx = x1 - x0
        dy = y1 - y0
        delta = dy * ((65536 + (dx >> 1)) // dx)
        for x in range(dx):
            lut[x0 + x] = y0 + ((x * delta + 32768) >> 16)
    lut[pts[-1][0]:] = pts[-1][1]
    return lut


def _scale_lut(lut: np.ndarray, index: np.ndarray, bd: int) -> np.ndarray:
    if bd == 8:
        return lut[np.clip(index, 0, 255)]
    x = np.clip(index >> (bd - 8), 0, 255)
    frac = index & ((1 << (bd - 8)) - 1)
    nxt = np.clip(x + 1, 0, 255)
    out = lut[x] + (((lut[nxt] - lut[x]) * frac + (1 << (bd - 9)))
                    >> (bd - 8))
    return np.where(x == 255, lut[x], out)


def apply_grain(planes: List[np.ndarray], params: FilmGrainParams,
                bd: int = 8) -> List[np.ndarray]:
    """Returns grained copies of [Y, U, V] (originals untouched)."""
    height, width = planes[0].shape
    if not params.apply_grain:
        return [p.copy() for p in planes]
    luma_g, cb_g, cr_g = _generate_grain(params, bd)
    lut_y = _scaling_lut(params.scaling_points_y)
    if params.chroma_scaling_from_luma:
        lut_cb = lut_cr = lut_y
    else:
        lut_cb = _scaling_lut(params.scaling_points_cb)
        lut_cr = _scaling_lut(params.scaling_points_cr)
    ro = 1 << (params.scaling_shift - 1)
    peak = (1 << bd) - 1

    y = planes[0].astype(np.int64).copy()
    u = planes[1].astype(np.int64).copy()
    v = planes[2].astype(np.int64).copy()
    apply_y = params.num_y_points > 0
    apply_cb = params.num_cb_points > 0 or params.chroma_scaling_from_luma
    apply_cr = params.num_cr_points > 0 or params.chroma_scaling_from_luma

    rng = _Lfsr(params.grain_seed)
    ar_pad, pad = 3, 3
    for by in range(0, (height + 1) // 2, 16):
        rng.init_row(by * 2, params.grain_seed)
        for bx in range(0, (width + 1) // 2, 16):
            r8 = rng.bits(8)
            offset_y = r8 & 15
            offset_x = (r8 >> 4) & 15
            ly = pad + 2 * ar_pad + (offset_y << 1)
            lx = pad + 2 * ar_pad + (offset_x << 1)
            cy = pad + ar_pad + offset_y
            cx = pad + ar_pad + offset_x
            y0, x0 = by * 2, bx * 2
            hh = min(32, height - y0)
            ww = min(32, width - x0)
            if hh <= 0 or ww <= 0:
                continue
            if apply_y:
                blk = y[y0:y0 + hh, x0:x0 + ww]
                g = luma_g[ly:ly + hh, lx:lx + ww]
                sc = _scale_lut(lut_y, blk, bd)
                y[y0:y0 + hh, x0:x0 + ww] = np.clip(
                    blk + ((sc * g + ro) >> params.scaling_shift), 0, peak)
            if apply_cb or apply_cr:
                chh = (hh + 1) // 2
                cww = (ww + 1) // 2
                lblk = planes[0].astype(np.int64)[y0:y0 + chh * 2,
                                                  x0:x0 + cww * 2]
                avg = (lblk[0::2, 0::2] + lblk[0::2, 1::2] + 1) >> 1
                for apply, plane, g_t, lut, mult, lmult, off in (
                        (apply_cb, u, cb_g, lut_cb, params.cb_mult,
                         params.cb_luma_mult, params.cb_offset),
                        (apply_cr, v, cr_g, lut_cr, params.cr_mult,
                         params.cr_luma_mult, params.cr_offset)):
                    if not apply:
                        continue
                    if params.chroma_scaling_from_luma:
                        m, lm, o = 0, 64, 0
                    else:
                        m, lm = mult - 128, lmult - 128
                        o = (off << (bd - 8)) - (1 << bd) if bd > 8 \
                            else off - 256
                    cblk = plane[by:by + chh, bx:bx + cww]
                    idx = np.clip(((avg * lm + m * cblk) >> 6) + o, 0,
                                  (256 << (bd - 8)) - 1)
                    g = g_t[cy:cy + chh, cx:cx + cww]
                    plane[by:by + chh, bx:bx + cww] = np.clip(
                        cblk + ((_scale_lut(lut, idx, bd) * g + ro)
                                >> params.scaling_shift), 0, peak)
    dt = planes[0].dtype
    return [y.astype(dt), u.astype(dt), v.astype(dt)]


# --- frame-header syntax (spec 5.9.30) -----------------------------------------
def write_params(w, params: FilmGrainParams, is_inter: bool) -> None:
    w.write_bit(int(params.apply_grain))
    if not params.apply_grain:
        return
    w.write(params.grain_seed, 16)
    if is_inter:
        w.write_bit(1)  # update_grain (always resend)
    w.write(params.num_y_points, 4)
    for val, sc in params.scaling_points_y[:params.num_y_points]:
        w.write(val, 8)
        w.write(sc, 8)
    w.write_bit(int(params.chroma_scaling_from_luma))
    if not params.chroma_scaling_from_luma:
        w.write(params.num_cb_points, 4)
        for val, sc in params.scaling_points_cb[:params.num_cb_points]:
            w.write(val, 8)
            w.write(sc, 8)
        w.write(params.num_cr_points, 4)
        for val, sc in params.scaling_points_cr[:params.num_cr_points]:
            w.write(val, 8)
            w.write(sc, 8)
    w.write(params.scaling_shift - 8, 2)
    w.write(params.ar_coeff_lag, 2)
    num_pos = 2 * params.ar_coeff_lag * (params.ar_coeff_lag + 1)
    for c in params.ar_coeffs_y[:num_pos]:
        w.write(c + 128, 8)
    n_chroma = (num_pos + 1) if params.num_y_points else num_pos
    if params.chroma_scaling_from_luma or params.num_cb_points:
        for c in (list(params.ar_coeffs_cb) + [0] * n_chroma)[:n_chroma]:
            w.write(c + 128, 8)
    if params.chroma_scaling_from_luma or params.num_cr_points:
        for c in (list(params.ar_coeffs_cr) + [0] * n_chroma)[:n_chroma]:
            w.write(c + 128, 8)
    w.write(params.ar_coeff_shift - 6, 2)
    w.write(params.grain_scale_shift, 2)
    if params.num_cb_points:
        w.write(params.cb_mult, 8)
        w.write(params.cb_luma_mult, 8)
        w.write(params.cb_offset, 9)
    if params.num_cr_points:
        w.write(params.cr_mult, 8)
        w.write(params.cr_luma_mult, 8)
        w.write(params.cr_offset, 9)
    w.write_bit(int(params.overlap_flag))
    w.write_bit(int(params.clip_to_restricted_range))


def read_params(r, is_inter: bool):
    if not r.read_bit():
        return None
    p = FilmGrainParams()
    p.grain_seed = r.read(16)
    if is_inter:
        assert r.read_bit() == 1, "grain param reuse unsupported"
    p.num_y_points = r.read(4)
    p.scaling_points_y = tuple((r.read(8), r.read(8))
                               for _ in range(p.num_y_points))
    p.chroma_scaling_from_luma = bool(r.read_bit())
    if not p.chroma_scaling_from_luma:
        p.num_cb_points = r.read(4)
        p.scaling_points_cb = tuple((r.read(8), r.read(8))
                                    for _ in range(p.num_cb_points))
        p.num_cr_points = r.read(4)
        p.scaling_points_cr = tuple((r.read(8), r.read(8))
                                    for _ in range(p.num_cr_points))
    p.scaling_shift = r.read(2) + 8
    p.ar_coeff_lag = r.read(2)
    num_pos = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
    p.ar_coeffs_y = tuple(r.read(8) - 128 for _ in range(num_pos))
    n_chroma = (num_pos + 1) if p.num_y_points else num_pos
    if p.chroma_scaling_from_luma or p.num_cb_points:
        p.ar_coeffs_cb = tuple(r.read(8) - 128 for _ in range(n_chroma))
    if p.chroma_scaling_from_luma or p.num_cr_points:
        p.ar_coeffs_cr = tuple(r.read(8) - 128 for _ in range(n_chroma))
    p.ar_coeff_shift = r.read(2) + 6
    p.grain_scale_shift = r.read(2)
    if p.num_cb_points:
        p.cb_mult = r.read(8)
        p.cb_luma_mult = r.read(8)
        p.cb_offset = r.read(9)
    if p.num_cr_points:
        p.cr_mult = r.read(8)
        p.cr_luma_mult = r.read(8)
        p.cr_offset = r.read(9)
    p.overlap_flag = bool(r.read_bit())
    p.clip_to_restricted_range = bool(r.read_bit())
    return p


def resolved_params(cfg) -> FilmGrainParams:
    """The frame's synthesis parameters from config: full noise-model
    params when present (auto estimation / API), else the flat-strength
    mapping. Tolerates the asdict form (checkpoint round trips)."""
    p = getattr(cfg, "film_grain_params", None)
    if p is not None:
        if isinstance(p, dict):
            p = FilmGrainParams(**{
                k: tuple(map(tuple, v)) if isinstance(v, list)
                and v and isinstance(v[0], (list, tuple))
                else (tuple(v) if isinstance(v, list) else v)
                for k, v in p.items()})
        return p
    return default_params(cfg.film_grain_strength, cfg.film_grain_seed)


def default_params(strength: int, seed: int = 45231) -> FilmGrainParams:
    """Synthetic flat-luma grain at a given strength (1..64 units of the
    piecewise scaling LUT; the CLI maps ``--film-grain`` levels here the
    way the reference's film-grain-denoise path fills fgs params,
    grainSynthesis.c:1174 av1_add_film_grain_run)."""
    s = max(1, min(64, int(strength)))
    return FilmGrainParams(grain_seed=seed & 0xFFFF,
                           scaling_points_y=((0, s), (255, s)))
