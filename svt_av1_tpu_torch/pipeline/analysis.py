"""Picture analysis: variance/activity maps, histograms, flat-block
noise estimation, and automatic film-grain parameterization.

TPU-first re-design of the reference's PictureAnalysis stage
(EbPictureAnalysisProcess.c: ComputeBlockMeanComputeVariance :1986,
CalculateHistogram :131, DetectInputPictureNoise :3181,
denoise_estimate_film_grain :3336 backed by noise_model.c's flat-block
finder): everything here is expressed as whole-frame vectorized window
reductions (integral images / strided means) so the same math maps to
jnp reductions on device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from svt_av1_tpu_torch.ops.grain import FilmGrainParams


def _block_reduce(x: np.ndarray, bs: int):
    """[H, W] -> [H//bs, W//bs, bs*bs] window view (crop to multiple)."""
    h = x.shape[0] // bs * bs
    w = x.shape[1] // bs * bs
    v = x[:h, :w].reshape(h // bs, bs, w // bs, bs)
    return v.transpose(0, 2, 1, 3).reshape(h // bs, w // bs, bs * bs)


def variance_maps(y: np.ndarray, sizes=(8, 16, 32, 64)) -> Dict[int, np.ndarray]:
    """Per-block variance at each size (reference
    ComputeBlockMeanComputeVariance; used for activity/complexity
    classification)."""
    out = {}
    yf = y.astype(np.float64)
    for bs in sizes:
        if y.shape[0] < bs or y.shape[1] < bs:
            continue
        v = _block_reduce(yf, bs)
        out[bs] = v.var(axis=2)
    return out


def ois_intra_cost(y: np.ndarray, bs: int = 16) -> np.ndarray:
    """Open Intra Search: per-block best open-loop intra SAD among
    DC / V / H predictors built from *source* neighbors (the reference's
    OIS, EbMotionEstimation.c:7419 open_loop_intra_search_sb — cheap
    intra hints computed during picture analysis, before any recon
    exists). Returns [rows, cols] SAD per block; edge blocks replicate
    their own first row/column as the missing neighbor."""
    h = y.shape[0] // bs * bs
    w = y.shape[1] // bs * bs
    yv = y[:h, :w].astype(np.int32)
    rows, cols = h // bs, w // bs
    blocks = yv.reshape(rows, bs, cols, bs).transpose(0, 2, 1, 3)
    # neighbor row above each block row (first block row: own top row)
    above = np.empty((rows, w), np.int32)
    above[0] = yv[0]
    above[1:] = yv[bs - 1::bs][:rows - 1]
    above = above.reshape(rows, cols, bs)
    left = np.empty((h, cols), np.int32)
    left[:, 0] = yv[:, 0]
    left[:, 1:] = yv[:, bs - 1::bs][:, :cols - 1]
    left = left.reshape(rows, bs, cols).transpose(0, 2, 1)
    dc = (above.sum(axis=2) + left.sum(axis=2) + bs) // (2 * bs)
    sad_dc = np.abs(blocks - dc[:, :, None, None]).sum(axis=(2, 3))
    sad_v = np.abs(blocks - above[:, :, None, :]).sum(axis=(2, 3))
    sad_h = np.abs(blocks - left[:, :, :, None]).sum(axis=(2, 3))
    return np.minimum(np.minimum(sad_dc, sad_v), sad_h)


DENOISER_QP_TH = 29  # reference EbPictureAnalysisProcess.c:36


def weak_filter_luma(y: np.ndarray) -> np.ndarray:
    """Weak denoising filter: 5-point cross (1,1,4,1,1)/8 with truncating
    division on interior pixels, borders copied (the reference's
    getFilteredTypes type 0 used by noiseExtractLumaWeak,
    EbPictureAnalysisProcess.c:1498)."""
    yi = y.astype(np.int32)
    out = yi.copy()
    out[1:-1, 1:-1] = (yi[:-2, 1:-1] + yi[1:-1, :-2] + 4 * yi[1:-1, 1:-1]
                       + yi[1:-1, 2:] + yi[2:, 1:-1]) // 8
    return out.astype(y.dtype)


def weak_filter_chroma(p: np.ndarray) -> np.ndarray:
    """Chroma weak filter: cross (2,2,4,2,2) with the reference's
    fixed-point /12 (mulhrs trick, getFilteredTypes type 1)."""
    pi = p.astype(np.int64)
    a = (2 * pi[:-2, 1:-1] + 2 * pi[1:-1, :-2] + 4 * pi[1:-1, 1:-1]
         + 2 * pi[1:-1, 2:] + 2 * pi[2:, 1:-1])
    a = (((a * 2730) >> 14) + 1) >> 1
    out = pi.copy()
    out[1:-1, 1:-1] = a
    return out.astype(p.dtype)


def classify_picture_noise(y: np.ndarray) -> int:
    """Frame noise class from the flat-block noise estimate + edge
    energy, collapsed to the reference's action classes
    (EbPictureAnalysisProcess.c:3738-3744): 1 = no noise (no action),
    2 = flat noisy areas (denoise flat blocks only), 3 = noise+edges
    (no denoising), 4 (= PIC_NOISE_CLASS_3_1) = dominated by noise
    (frame-based denoising)."""
    sigma = estimate_noise_sigma(y)
    if sigma < 1.0:
        return 1
    flat = flat_block_mask(y)
    flat_frac = float(flat.mean()) if flat.size else 0.0
    if sigma >= 4.0 and flat_frac >= 0.5:
        return 4
    if flat_frac > 0.10:
        return 2
    return 3


def denoise_source(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                   noise_class: int, qp: int):
    """Source denoising by noise class (reference DenoiseInputPicture,
    EbPictureAnalysisProcess.c:3409): class 3_1 filters the whole frame
    (luma + chroma); class 2 filters only flat-noisy luma blocks, and
    only at coarse operating points (qp > DENOISER_QP_TH). Encoder-side
    only — the bitstream stays conformant either way."""
    if noise_class >= 4:
        return weak_filter_luma(y), weak_filter_chroma(u), \
            weak_filter_chroma(v)
    if noise_class == 2 and qp > DENOISER_QP_TH:
        bs = 16
        mask = flat_block_mask(y, bs)
        if mask.any():
            den = weak_filter_luma(y)
            out = y.copy()
            m = np.repeat(np.repeat(mask, bs, axis=0), bs, axis=1)
            h, w = m.shape
            out[:h, :w] = np.where(m, den[:h, :w], y[:h, :w])
            return out, u, v
    return y, u, v


def luma_histogram(y: np.ndarray, bins: int = 256) -> np.ndarray:
    """Frame luma histogram (CalculateHistogram analogue)."""
    return np.bincount(y.reshape(-1).astype(np.int64), minlength=bins)


def activity_class(y: np.ndarray) -> np.ndarray:
    """Coarse 32x32 complexity classes 0..3 by variance quartile
    (ComplexityClassifier32x32 analogue; feeds adaptive decisions)."""
    vm = variance_maps(y, sizes=(32,)).get(32)
    if vm is None or vm.size == 0:
        return np.zeros((0, 0), dtype=np.int32)
    qs = np.quantile(vm, [0.25, 0.5, 0.75])
    return np.digitize(vm, qs).astype(np.int32)


# --- noise estimation ---------------------------------------------------------

# 3x3 Laplacian-style high-pass used by classical MAD noise estimators
# (the role of DetectInputPictureNoise's noise extraction filter)
_HP = np.array([[1, -2, 1], [-2, 4, -2], [1, -2, 1]], dtype=np.float64)


def _highpass(y: np.ndarray) -> np.ndarray:
    yf = y.astype(np.float64)
    out = np.zeros((y.shape[0] - 2, y.shape[1] - 2))
    for dr in range(3):
        for dc in range(3):
            out += _HP[dr, dc] * yf[dr:dr + out.shape[0],
                                    dc:dc + out.shape[1]]
    return out


def flat_block_mask(y: np.ndarray, bs: int = 16) -> np.ndarray:
    """Low-gradient, mid-tone blocks suitable for noise measurement
    (noise_model.c flat-block finder analogue: gradient energy + DC
    range gates)."""
    gy = np.abs(np.diff(y.astype(np.float64), axis=0))
    gx = np.abs(np.diff(y.astype(np.float64), axis=1))
    grad = np.zeros(y.shape)
    grad[:-1] += gy
    grad[:, :-1] += gx
    gmean = _block_reduce(grad, bs).mean(axis=2)
    dc = _block_reduce(y.astype(np.float64), bs).mean(axis=2)
    gthr = np.quantile(gmean, 0.5) if gmean.size else 0.0
    return (gmean <= max(gthr, 6.0)) & (dc > 24) & (dc < 232)


def estimate_noise_sigma(y: np.ndarray, bs: int = 16) -> float:
    """Noise standard deviation from high-passed flat blocks
    (Immerkaer-style MAD estimator; the DetectInputPictureNoise role)."""
    if y.shape[0] < bs + 2 or y.shape[1] < bs + 2:
        return 0.0
    hp = _highpass(y)
    mask = flat_block_mask(y[1:-1, 1:-1], bs)
    hb = _block_reduce(np.abs(hp), bs).mean(axis=2)
    mh = min(mask.shape[0], hb.shape[0])
    mw = min(mask.shape[1], hb.shape[1])
    sel = hb[:mh, :mw][mask[:mh, :mw]]
    if sel.size == 0:
        return 0.0
    # E|HP(noise)| for iid sigma-noise with this kernel: sigma*6*sqrt(2/pi)
    return float(np.median(sel) * np.sqrt(np.pi / 2.0) / 6.0)


def _grain_unit_sigma(bd: int = 8) -> float:
    """Std of the synthesized grain template at scaling value 1
    (gaussian_sequence >> (12-bd), scaled by 1/2^scaling_shift)."""
    from svt_av1_tpu_torch.ops.grain import gaussian_sequence
    g = gaussian_sequence().astype(np.float64)
    return float((g / (1 << (12 - bd))).std() / 256.0)


def _plane_residuals(y: np.ndarray, bs: int = 16):
    """Per-block planar-fit residuals: [nby, nbx, bs, bs] noise field,
    [nby, nbx] block DC (noise_model.c's flat-block extraction fits and
    removes a bilinear plane before measuring noise)."""
    nby, nbx = y.shape[0] // bs, y.shape[1] // bs
    z = y[:nby * bs, :nbx * bs].astype(np.float64) \
        .reshape(nby, bs, nbx, bs).transpose(0, 2, 1, 3)
    j = np.arange(bs) - (bs - 1) / 2.0          # orthogonal ramp basis
    varj = float((j ** 2).mean())
    a = z.mean(axis=(2, 3), keepdims=True)
    b = (z * j[None, None, None, :]).mean(axis=(2, 3), keepdims=True) \
        / varj
    c = (z * j[None, None, :, None]).mean(axis=(2, 3), keepdims=True) \
        / varj
    resid = z - a - b * j[None, None, None, :] - c * j[None, None, :, None]
    return resid, a[..., 0, 0]


def _flat_mask_from(y: np.ndarray, dc: np.ndarray, bs: int,
                    bd: int) -> np.ndarray:
    """Flat-block gate on the _plane_residuals grid (gradient energy +
    mid-tone DC range, the noise_model.c flat-block finder rules)."""
    up = 1 << (bd - 8)
    gy = np.abs(np.diff(y.astype(np.float64), axis=0))
    gx = np.abs(np.diff(y.astype(np.float64), axis=1))
    grad = np.zeros(y.shape)
    grad[:-1] += gy
    grad[:, :-1] += gx
    gmean = _block_reduce(grad, bs).mean(axis=2)
    nby, nbx = dc.shape
    gmean = gmean[:nby, :nbx]
    gthr = np.quantile(gmean, 0.5) if gmean.size else 0.0
    return (gmean <= max(gthr, 6.0 * up)) \
        & (dc > 24 * up) & (dc < 232 * up)


def _ar_fit(resid: np.ndarray, mask: np.ndarray, lag: int):
    """Least-squares AR(lag) coefficients over flat-block interiors
    (noise_model.c:add_block_observations + solve, re-expressed as one
    whole-frame normal-equation solve). Returns float coeffs in
    _ar_positions order, or None when under-determined."""
    from svt_av1_tpu_torch.ops.grain import _ar_positions
    pos = _ar_positions(lag)
    blocks = resid[mask]                     # [NB, bs, bs]
    if blocks.shape[0] < 4:
        return None
    bs = blocks.shape[1]
    t = blocks[:, lag:, lag:bs - lag].reshape(-1)
    X = np.stack([blocks[:, lag + dy: bs + dy,
                         lag + dx: bs - lag + dx].reshape(-1)
                  for dy, dx in pos], axis=1)
    if t.size < 8 * len(pos):
        return None
    xtx = X.T @ X
    if np.linalg.cond(xtx) > 1e8:
        return None
    return np.linalg.solve(xtx, X.T @ t)


def _quantize_ar(sol: np.ndarray):
    """Integer AR coefficients + shift (spec: 8-bit two's complement at
    ar_coeff_shift in 6..9; pick the finest shift that fits)."""
    shift = 9
    while shift > 6 and np.max(np.abs(np.round(sol * (1 << shift)))) > 127:
        shift -= 1
    ints = np.clip(np.round(sol * (1 << shift)), -128, 127).astype(int)
    return tuple(int(v) for v in ints), shift


def _template_sigma(params: FilmGrainParams, bd: int) -> float:
    """Std of the synthesized (AR-filtered) luma grain template core."""
    from svt_av1_tpu_torch.ops.grain import _generate_grain
    luma, _, _ = _generate_grain(params, bd)
    return float(luma[9:, 9:73].astype(np.float64).std())


def estimate_grain_params(y: np.ndarray, bd: int = 8,
                          seed: int = 45231,
                          ar_lag: int = 2) -> FilmGrainParams:
    """Full noise-model solve (the role of denoise_estimate_film_grain
    + noise_model.c:118-1823): flat-block planar residuals give the
    noise field; an AR(2) least-squares fit gives the spectral shape;
    per-intensity-bin sigmas give a piecewise scaling LUT whose values
    are calibrated against the synthesized template's actual std.
    Returns apply_grain=False params when the source is clean."""
    bs = 16
    up = 1 << (bd - 8)
    if y.shape[0] < bs + 2 or y.shape[1] < bs + 2:
        return FilmGrainParams(apply_grain=False)
    # primary noise gate: the Laplacian MAD estimator is robust to smooth
    # image structure a per-block planar fit cannot remove (curvature
    # reads as residual but not as high-pass energy)
    hp_sigma = estimate_noise_sigma(y)
    if hp_sigma < 0.8 * up:
        return FilmGrainParams(apply_grain=False)
    resid, dc = _plane_residuals(y, bs)
    sig_blk = resid.std(axis=(2, 3))
    # curvature-contaminated blocks: planar residual far above the
    # high-pass estimate means structure, not noise
    mask = _flat_mask_from(y, dc, bs, bd) & (sig_blk <= 3.0 * hp_sigma)
    if not mask.any():
        # fall back to a flat LUT calibrated from the high-pass sigma
        unit = _grain_unit_sigma(bd)
        s = int(np.clip(round(hp_sigma / unit), 1, 255))
        return FilmGrainParams(grain_seed=seed & 0xFFFF,
                               scaling_points_y=((0, s), (255, s)))
    # spectral shape
    coeffs, shift, lag = (), 6, 0
    sol = _ar_fit(resid, mask, ar_lag) if ar_lag > 0 else None
    if sol is not None and np.max(np.abs(sol)) > 0.02:
        coeffs, shift = _quantize_ar(sol)
        lag = ar_lag
    params = FilmGrainParams(grain_seed=seed & 0xFFFF,
                             ar_coeff_lag=lag, ar_coeffs_y=coeffs,
                             ar_coeff_shift=shift)
    unit = _template_sigma(params, bd) / 256.0
    # intensity-dependent strength: bin flat blocks by DC, one scaling
    # point per populated bin (spec max 14 luma points)
    pts = []
    for lo in range(0, 256, 32):
        sel = mask & (dc >= lo * up) & (dc < (lo + 32) * up)
        if sel.sum() < 3:
            continue
        s = int(np.clip(round(float(np.median(sig_blk[sel]))
                              / max(unit, 1e-9)), 0, 255))
        pts.append((min(lo + 16, 255), s))
    if not pts:
        s = int(np.clip(round(float(np.median(sig_blk[mask]))
                              / max(unit, 1e-9)), 1, 255))
        pts = [(0, s), (255, s)]
    elif len(pts) == 1:
        pts = [(0, pts[0][1]), (255, pts[0][1])]
    if all(p[1] == 0 for p in pts):
        return FilmGrainParams(apply_grain=False)
    params.num_y_points = len(pts)
    params.scaling_points_y = tuple(pts)
    return params


# --- content classifiers (SourceBasedOperations) -------------------------------

import dataclasses as _dc


@_dc.dataclass(frozen=True)
class ContentClasses:
    """Per-picture content classification feeding AQ decisions — the
    TPU-native SourceBasedOperations stage output (reference GrassLcu /
    SpatialHighContrastClassifier / DeriveHighDarkAreaDensityFlag,
    EbSourceBasedOperationsProcess.c:473,798,715). All maps are computed
    with whole-frame vectorized block reductions instead of the
    reference's per-SB raster loops."""
    grass16: np.ndarray      # [sb_rows*4, sb_cols*4] bool, 16x16 luma units
    skin16: np.ndarray       # same grid
    contrast_sb: np.ndarray  # [sb_rows, sb_cols] bool (isolated-only)
    grass_pct: int           # % of SBs containing any grass unit
    dark: bool               # high dark-area density
    dark_low_light: bool     # dark + some very bright area (banding risk)


def content_classes(y_padded: np.ndarray, u_padded: np.ndarray,
                    v_padded: np.ndarray, sb_rows: int,
                    sb_cols: int, bit_depth: int = 8) -> ContentClasses:
    """Classify 16x16 units by (y, cb, cr) mean ranges and texture.

    Behavioral model (NOT a translation): the reference classifies each
    16x16 unit of every SB from its y/cb/cr means against fixed color
    ranges — grass (green-field), skin, and a "medium texture, centered
    chroma" spatial-contrast class whose picture-level use is gated to
    isolated occurrences (DeriveComplexityContrastPicture's <=10% rule).
    Dark-area density comes from the luma histogram lower bins. Here the
    whole frame is classified at once from strided block means."""
    sh = bit_depth - 8
    h16, w16 = sb_rows * 4, sb_cols * 4
    ym = _block_reduce(y_padded[:sb_rows * 64, :sb_cols * 64]
                       .astype(np.int64) >> sh, 16).mean(axis=2)
    # 4:2:0 chroma: the 8x8 chroma block co-sited with each 16x16 luma unit
    um = _block_reduce(u_padded[:sb_rows * 32, :sb_cols * 32]
                       .astype(np.int64) >> sh, 8).mean(axis=2)
    vm = _block_reduce(v_padded[:sb_rows * 32, :sb_cols * 32]
                       .astype(np.int64) >> sh, 8).mean(axis=2)
    ym, um, vm = (a[:h16, :w16] for a in (ym, um, vm))
    y_mid = (ym > 70) & (ym < 130)
    grass = y_mid & (um > 80) & (um < 115) & (vm > 110) & (vm < 135)
    skin = y_mid & (um > 100) & (um < 120) & (vm > 135) & (vm < 160)
    # spatial contrast: medium texture + medium brightness + centered chroma
    var16 = _block_reduce(y_padded[:sb_rows * 64, :sb_cols * 64]
                          .astype(np.float64), 16).var(axis=2)[:h16, :w16]
    contrast16 = ((var16 > 10) & (var16 < 300) & (ym > 70) & (ym < 145)
                  & (np.abs(um - 140) < 10) & (np.abs(vm - 115) < 15))
    c_sb = contrast16.reshape(sb_rows, 4, sb_cols, 4).any(axis=(1, 3))
    # isolated-shapes-only gate: a frame-wide "contrast" texture is just
    # the content — only sparse flags mark perceptually salient regions
    if c_sb.mean() > 0.10:
        c_sb = np.zeros_like(c_sb)
    g_sb = grass.reshape(sb_rows, 4, sb_cols, 4).any(axis=(1, 3))
    hist = luma_histogram((y_padded.astype(np.int64) >> sh)
                          .astype(np.int64).clip(0, 255))
    npx = float(y_padded.size)
    black_pct = 100.0 * hist[:25].sum() / npx
    dark = black_pct >= 20.0
    dll = (100.0 * hist[:40].sum() / npx >= 20.0) \
        and (100.0 * hist[210:].sum() / npx >= 1.0)
    return ContentClasses(grass16=grass, skin16=skin, contrast_sb=c_sb,
                          grass_pct=int(100.0 * g_sb.mean()),
                          dark=bool(dark), dark_low_light=bool(dll))


def variance_qmap(y_padded: np.ndarray, sb_rows: int, sb_cols: int,
                  base_q_idx: int, delta_q_res: int,
                  prev_y: np.ndarray = None,
                  classes: ContentClasses = None) -> np.ndarray:
    """Per-SB qindex from local variance (QPM; Av1QpModulationLcu
    EbCodingLoop.c:2222): flat SBs get finer quantization, busy SBs
    coarser. With ``prev_y``, temporally stable SBs get an extra quality
    boost (TPL-lite: quality invested in long-lived content propagates
    through prediction, the role of the reference's BEA/TPL machinery,
    EbInitialRateControlProcess UpdateBeaInfoOverTime). Offsets are
    multiples of 1 << delta_q_res so every SB-to-SB delta is codable."""
    step = 1 << delta_q_res
    sbs = 64
    v = y_padded[:sb_rows * sbs, :sb_cols * sbs].astype(np.float64)
    v = v.reshape(sb_rows, sbs, sb_cols, sbs)
    var = v.transpose(0, 2, 1, 3).reshape(sb_rows, sb_cols, -1).var(axis=2)
    med = max(float(np.median(var)), 1.0)
    off = np.round(4.0 * np.log2(np.maximum(var, 1.0) / med))
    if prev_y is not None and prev_y.shape[:2] == y_padded.shape[:2]:
        d = np.abs(y_padded[:sb_rows * sbs, :sb_cols * sbs]
                   .astype(np.float64)
                   - prev_y[:sb_rows * sbs, :sb_cols * sbs]
                   .astype(np.float64))
        d = d.reshape(sb_rows, sbs, sb_cols, sbs)
        mad = d.transpose(0, 2, 1, 3).reshape(sb_rows, sb_cols,
                                              -1).mean(axis=2)
        thr = max(1.5, float(np.median(mad)) * 0.5)
        off = off - step * (mad < thr)
    if classes is not None:
        # content-aware shaping (SourceBasedOperations feeding the
        # BEA/QPM delta-qp ranges, SetDefaultDeltaQpRange
        # EbSourceBasedOperationsProcess.c:633): grass/skin SBs never
        # degrade (their artifacts are perceptually loud), isolated
        # high-contrast SBs likewise; dark-dominated frames halve any
        # degrade (banding risk in the dark background)
        protect16 = classes.grass16 | classes.skin16
        prot_sb = protect16.reshape(sb_rows, 4, sb_cols, 4) \
            .mean(axis=(1, 3)) >= 0.5
        off = np.where(prot_sb | classes.contrast_sb,
                       np.minimum(off, 0), off)
        if classes.dark or classes.dark_low_light:
            off = np.where(off > 0, (off // (2 * step)) * step, off)
    off = np.clip(off, -20, 16)
    off = (np.round(off / step) * step).astype(np.int64)
    return np.clip(base_q_idx + off, 1, 255).astype(np.int32)


def histogram_cut_index(hists, thr: float = 0.5):
    """First index i (>=1) where the normalized L1 distance between
    consecutive lookahead luma histograms exceeds ``thr`` — an
    in-window scene cut. The InitialRateControl histogram-queue role
    (GetHistogramQueueData / UpdateHistogramQueueEntry,
    EbInitialRateControlProcess.c:1211,1257): the rate controller must
    not average a frame's bit share across a cut, because the post-cut
    content's complexity says nothing about the pre-cut frames.
    Returns None when the window is cut-free. Histograms need not be
    same-scale: each is normalized by its own pixel count."""
    prev = None
    for i, h in enumerate(hists):
        n = max(int(h.sum()), 1)
        cur = h.astype(np.float64) / n
        if prev is not None and float(np.abs(cur - prev).sum()) > thr:
            return i
        prev = cur
    return None


# --- TPL: MV-propagated lookahead AQ -------------------------------------------

def tpl_group_qmaps(group_lumas, base_q_idx: int, delta_q_res: int,
                    sb_rows: int, sb_cols: int,
                    strength: float = 8.0, dead_zone: float = 1.0,
                    prev_luma=None):
    """MV-propagated temporal-dependency AQ over a mini-GOP window
    (the reference's TPL machinery in InitialRateControl:
    UpdateBeaInfoOverTime EbInitialRateControlProcess.c:954 — per-block
    inter cost propagated along ME MVs so areas that future frames
    predict FROM get finer quantization).

    group_lumas: padded source lumas in display order (window).
    prev_luma: the previous GOP anchor / keyframe luma — the out-of-
    window frame the GOP anchor predicts from (its own q is already
    decided; flow into it is dropped).
    Returns a list of per-SB qindex OFFSET maps [sb_rows, sb_cols]
    (multiples of 1 << delta_q_res), one per frame in the window — the
    consumer adds them to that frame's own base qindex (per-layer
    qp-scaling moves the base per frame).

    Model (mc_flow at quarter resolution, 8x8 cells = 32x32 px):
    propagation follows the ACTUAL hierarchical coding structure (the
    bisection of Encoder._flush_group — frame mid of (lo, hi) predicts
    from lo and hi, NOT from its display neighbor; an occluded-then-
    uncovered background is reachable from the anchor even when the
    display-adjacent frame hides it). intra_cost = OIS SAD; mc_cost =
    per-block best full-pel ME SAD over the frame's real reference
    pair; leaves-first traversal distributes each block's
    (intra + propagated) * (1 - mc/intra) to the winning reference's
    cells under the MV (4-way bilinear overlap);
    delta_q = -K*log2(1 + prop/intra), mean-normalized per frame,
    dead-zoned, quantized to delta_q_res steps.
    """
    from svt_av1_tpu_torch.ops import mc, me

    n = len(group_lumas)
    step = 1 << delta_q_res
    cell = 8                       # cell size on the quarter plane
    dec = {t: me.decimate2(me.decimate2(
        np.asarray(y, dtype=np.int32))) for t, y in
        enumerate(group_lumas)}
    if prev_luma is not None:
        dec[-1] = me.decimate2(me.decimate2(
            np.asarray(prev_luma, dtype=np.int32)))
    h, w = dec[0].shape
    rows, cols = h // cell, w // cell
    intra = {t: ois_intra_cost(d, bs=cell)
             .astype(np.float64)[:rows, :cols] + 1.0
             for t, d in dec.items()}
    gy, gx = np.mgrid[0:rows, 0:cols]
    xs = (gx * cell).reshape(-1)
    ys = (gy * cell).reshape(-1)
    # dependency edges in coding order, mirroring _flush_group: the
    # anchor (n-1) refs the previous anchor (-1); interior mid of
    # (lo, hi) refs both ends; leaves-first (= reverse coding order)
    # accumulates a frame's incoming flow before it distributes
    deps = [(n - 1, (-1,))]

    def _rec(lo, hi):
        if hi - lo <= 1:
            return
        mid = (lo + hi) // 2
        deps.append((mid, (lo, hi)))
        _rec(lo, mid)
        _rec(mid, hi)

    _rec(-1, n - 1)
    prop = {t: np.zeros((rows, cols)) for t in dec}
    refp_cache = {}
    for t, refs in reversed(deps):
        refs = [r for r in refs if r in dec]
        if not refs:
            continue
        best_sad, best_mvs, best_ref = None, None, None
        # later ref first so SAD ties favor it: ties mean any ref
        # predicts equally well, and crediting the in-window frame
        # (the hi/anchor side) keeps the flow inside the window
        # instead of dropping it on the already-coded prev anchor
        for r in sorted(refs, reverse=True):
            if r not in refp_cache:
                refp_cache[r] = mc.pad_reference(dec[r])
            mvs, sad = me.fullpel_search(refp_cache[r], dec[t],
                                         xs, ys, cell)
            sad = sad.reshape(rows, cols).astype(np.float64)
            mvs = mvs.reshape(rows, cols, 2)
            if best_sad is None:
                best_sad, best_mvs = sad, mvs
                best_ref = np.full((rows, cols), r, dtype=np.int64)
            else:
                win = sad < best_sad
                best_sad = np.where(win, sad, best_sad)
                best_mvs = np.where(win[..., None], mvs, best_mvs)
                best_ref = np.where(win, r, best_ref)
        cost = intra[t] + prop[t]
        use = np.minimum(np.maximum(best_sad, 0.0), intra[t])
        flow = cost * (1.0 - use / intra[t])   # what prediction saves
        fy = gy * cell + best_mvs[..., 0]
        fx = gx * cell + best_mvs[..., 1]
        r0 = np.floor(fy / cell).astype(np.int64)
        c0 = np.floor(fx / cell).astype(np.int64)
        ay = (fy - r0 * cell) / cell
        ax = (fx - c0 * cell) / cell
        for r in refs:
            m = best_ref == r
            tgt = prop[r]
            for dr, dc, wgt in ((0, 0, (1 - ay) * (1 - ax)),
                                (0, 1, (1 - ay) * ax),
                                (1, 0, ay * (1 - ax)),
                                (1, 1, ay * ax)):
                rr = np.clip(r0 + dr, 0, rows - 1)
                cc = np.clip(c0 + dc, 0, cols - 1)
                np.add.at(tgt, (rr[m], cc[m]), (flow * wgt)[m])
    out = []
    K = strength                               # qindex per doubling of
    for t in range(n):                         # the tpl cost ratio
        r = 1.0 + prop[t] / intra[t]
        off_cell = -K * np.log2(r)             # finer q where r is big
        # cells are 32x32 px -> 2x2 per SB; average into SB units
        off_sb = np.zeros((sb_rows, sb_cols))
        cnt = np.zeros((sb_rows, sb_cols))
        sr = (np.arange(rows) * cell * 4) // 64
        sc = (np.arange(cols) * cell * 4) // 64
        np.add.at(off_sb, (sr[:, None].repeat(cols, 1),
                           sc[None, :].repeat(rows, 0)), off_cell)
        np.add.at(cnt, (sr[:, None].repeat(cols, 1),
                        sc[None, :].repeat(rows, 0)), 1.0)
        off_sb = off_sb / np.maximum(cnt, 1.0)
        # redistribute WITHIN the frame (zero mean): the per-layer
        # qp-scaling already prices temporal depth, so TPL's job here is
        # spatial — finer q where future frames predict from, coarser
        # where nothing references (occluded/new areas)
        off_sb = off_sb - off_sb.mean()
        # dead-zone: a weak/uniform tpl signal must produce NO deltas
        # (rounding would turn it into +-1-step noise that costs both
        # signaling bits and psnr); require a full step of signal
        off_sb = np.where(np.abs(off_sb) >= dead_zone * step,
                          off_sb, 0.0)
        off_sb = np.clip(np.round(off_sb / step) * step, -20, 16)
        out.append(off_sb.astype(np.int64))
    return out
