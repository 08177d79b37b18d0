"""PyTorch twin of the production mode-decision program
(``svt_av1_tpu/ops/device_md.py``).

``decide_block_batch_dev`` reproduces ``pipeline.md.decide_block_batch``
bit for bit on a torch device: all candidate intra predictions
(directional zones Z1/Z2/Z3, with or without the normative intra edge
filter, and CfL included), the integer fast-loop
ranking, the NFL full loop (forward transform, the quantization stage —
quantize, RDOQ-lite trim, CDF-LUT rate, dequantize: one launch of the
hand-written kernel on CUDA — inverse transform, recon) and the luma tx-type
sweep. Every cost is integer (md.RATE_Q fixed point), so the argmin and
stable-argsort decisions agree exactly with the host NumPy path and with
the JAX twin, and the encoder's streams are byte-identical on any device.

Integer widths: RD costs and distortions are int64, the pixel path int32.
Every constant index array becomes a long tensor on the data's device.

Reference equivalents: fast/full loops ``EbProductCodingLoop.c:1185,2004``,
encode-pass tx search ``EbCodingLoop.c:516``, CfL ``:1720``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.ops import intra_dir
from svt_av1_tpu_torch.ops import quant as quant_host
from svt_av1_tpu_torch.ops import step_graphs
from svt_av1_tpu_torch.ops.device import const
from svt_av1_tpu_torch.pipeline import common, md
from svt_av1_tpu_torch.utils.blocks import get_scan

UV_CFL = 13
_BIG = 1 << 62


# --- directional intra (twins of intra_dir._z1/_z2/_z3) -------------------------
@functools.lru_cache(maxsize=256)
def _zone13_consts(bw: int, bh: int, d: int, transposed: bool,
                   device: torch.device):
    """Index/shift tensors of zone 1 (``transposed``: zone 3)."""
    r = np.arange(bh)[:, None]
    c = np.arange(bw)[None, :]
    pos = (c + 1) * d if transposed else (r + 1) * d
    base = (pos >> 6) + (r if transposed else c)
    max_base = bw + bh - 1
    return (const((pos >> 1) & 0x1F, device, torch.int32),
            const(1 + np.minimum(base, max_base), device, torch.long),
            const(1 + np.minimum(base + 1, max_base), device, torch.long),
            const(base < max_base, device))


def _z13(edge1, bw, bh, d, bd, transposed):
    shift, i0, i1, inside = _zone13_consts(bw, bh, d, transposed,
                                           edge1.device)
    val = (edge1[:, i0] * (32 - shift) + edge1[:, i1] * shift + 16) >> 5
    out = torch.where(inside[None], val,
                      edge1[:, 1 + bw + bh - 1][:, None, None])
    return out.clamp(0, (1 << bd) - 1)


def _z1_j(above1, bw, bh, dx, bd):
    return _z13(above1, bw, bh, dx, bd, transposed=False)


def _z3_j(left1, bw, bh, dy, bd):
    return _z13(left1, bw, bh, dy, bd, transposed=True)


@functools.lru_cache(maxsize=256)
def _z2_consts(bw: int, bh: int, dx: int, dy: int, na: int, nl: int,
               device: torch.device):
    r = np.arange(bh)[:, None]
    c = np.arange(bw)[None, :]
    x = c * 64 - (r + 1) * dx
    base_x = x >> 6
    y = r * 64 - (c + 1) * dy
    base_y = y >> 6
    bx0 = np.clip(base_x, -1, bw + bh - 1)
    bx1 = np.clip(base_x + 1, -1, bw + bh)
    by0 = np.clip(base_y, -1, bh + bw - 1)
    by1 = np.clip(base_y + 1, -1, bh + bw)
    lt = functools.partial(const, device=device, dtype=torch.long)
    return (const((x >> 1) & 0x1F, device, torch.int32),
            const((y >> 1) & 0x1F, device, torch.int32),
            lt(1 + bx0), lt(np.minimum(1 + bx1, na)),
            lt(1 + by0), lt(np.minimum(1 + by1, nl)),
            const(base_x >= -1, device))


def _z2_j(above1, left1, bw, bh, dx, dy, bd):
    sx, sy, ax0, ax1, ly0, ly1, use_x = _z2_consts(
        bw, bh, dx, dy, above1.shape[1] - 1, left1.shape[1] - 1,
        above1.device)
    vx = (above1[:, ax0] * (32 - sx) + above1[:, ax1] * sx + 16) >> 5
    vy = (left1[:, ly0] * (32 - sy) + left1[:, ly1] * sy + 16) >> 5
    out = torch.where(use_x[None], vx, vy)
    return out.clamp(0, (1 << bd) - 1)


def predict_any_j(mode: int, delta: int, above1, left1, bw, bh, ha, hl,
                  bd: int = 8, edge=None):
    """Twin of intra_ops.predict_any for one static (mode, delta).
    above1/left1: offset-1 edge arrays (int32). ``edge``: None (the intra
    edge filter is off) or (ftype, n_top, n_left) [B] tensors for the
    normative edge filter + upsample on directional modes."""
    if intra_dir.is_directional(mode):
        angle = intra_dir.mode_angle(mode, delta)
        if angle not in (90, 180):
            if edge is not None:
                return intra_dir.predict_directional_edge_t(
                    mode, delta, above1.long(), left1.long(), bw, bh, ha,
                    hl, *edge, bd=bd)
            if 0 < angle < 90:
                return _z1_j(above1, bw, bh, intra_dir.get_dx(angle), bd)
            if 90 < angle < 180:
                return _z2_j(above1, left1, bw, bh,
                             intra_dir.get_dx(angle),
                             intra_dir.get_dy(angle), bd)
            return _z3_j(left1, bw, bh, intra_dir.get_dy(angle), bd)
    preds = dev.predict_modes((mode,), above1[:, 1:], left1[:, 1:],
                              above1[:, 0], ha, hl, bw, bh, bd)
    return preds[0]


# --- CfL twins ---------------------------------------------------------------
def luma_ac_420_j(luma):
    l32 = luma.to(torch.int32)
    sub = (l32[:, 0::2, 0::2] + l32[:, 0::2, 1::2]
           + l32[:, 1::2, 0::2] + l32[:, 1::2, 1::2]) << 1
    b, h, w = sub.shape
    n_log2 = int(np.log2(h * w))
    avg = (sub.reshape(b, -1).sum(dim=1) + (1 << (n_log2 - 1))) >> n_log2
    return sub - avg[:, None, None]


def cfl_predict_j(dc_pred, ac, alpha_q3, bd=8):
    a = alpha_q3.to(torch.int64)[:, None, None]
    scaled = a * ac.to(torch.int64)
    scaled = torch.where(scaled >= 0, (scaled + 32) >> 6,
                         -((-scaled + 32) >> 6))
    return (dc_pred.to(torch.int64) + scaled).clamp(0, (1 << bd) - 1)


def cfl_fit_alpha_j(ac, src, dc_pred):
    b = ac.shape[0]
    r = (src.to(torch.int64) - dc_pred.to(torch.int64)).reshape(b, -1)
    acf = ac.reshape(b, -1).to(torch.int64)
    a2 = (acf * acf).sum(dim=1)
    ar = (acf * r).sum(dim=1)
    den = a2.clamp(min=1)
    mag = (128 * ar.abs() + den) // (2 * den)
    alpha = torch.where(a2 > 0, torch.sign(ar) * mag, 0)
    return alpha.clamp(-16, 16)


# --- full loop (T/Q/IQ/recon + integer rate) ------------------------------------
# qindex and lambda are per-block [B] operands throughout: one call serves
# every quantizer the qp-scaling ladder can produce.

@functools.lru_cache(maxsize=32)
def _level_cost_tab(plane_type: int, txs_ctx: int) -> np.ndarray:
    """md._level_cost_lut stacked over the 4 coef_qctx buckets [4, 256]."""
    return np.stack([md._level_cost_lut(q, plane_type, txs_ctx)
                     for q in range(4)])


@functools.lru_cache(maxsize=1)
def _qctx_tab() -> np.ndarray:
    from svt_av1_tpu_torch.entropy.cdf import coef_qctx
    return np.array([coef_qctx(q) for q in range(256)], dtype=np.int64)


@functools.lru_cache(maxsize=64)
def _rate_consts(plane_type: int, tx_size: int, device: torch.device):
    """(level-cost table [4, 256], qindex -> qctx [256], eob bits LUT)."""
    from svt_av1_tpu_torch.entropy import coeff_ctx as cc
    tab = _level_cost_tab(plane_type, int(cc.txs_ctx(tx_size)))
    return (const(tab, device), const(_qctx_tab(), device),
            const(md._eob_bits_lut().astype(np.int64), device))


def _rate_cdf_j(qcoeff_flat, eob, qv, plane_type: int, tx_size: int):
    """Twin of md.coeff_rate_cdf: [B, n] raster levels -> q9 rate [B]
    int64. qv: [B] qindex vector."""
    tab, qctx, ebl = _rate_consts(plane_type, tx_size, qcoeff_flat.device)
    lut = tab[qctx[qv.long()]]                                # [B, 256]
    n = qcoeff_flat.shape[1]
    aq = qcoeff_flat.abs().clamp(max=255).long()
    eobi = eob.long()
    rate = lut.gather(1, aq).sum(dim=1) - (n - eobi) * lut[:, 0]
    rate = rate.clamp(min=0)
    return rate + torch.where(eobi > 0, (3 << md.RATE_Q) + ebl[eobi], 307)


def rdoq_trim_j(qc, dq, eob, scan, tx_size, qv, plane_type: int, lam_qv):
    """Twin of md.rdoq_trim (identical integer math). Like the host twin,
    runs at HALF the mode-decision lambda. qv/lam_qv: [B] vectors; blocks
    with qindex 0 are left untouched (the host gates the trim off at
    lossless)."""
    b, n = qc.shape
    device = qc.device
    qv = qv.long()
    lam_qv = lam_qv.to(torch.int64) >> 1
    tab, qctx, ebl = _rate_consts(plane_type, tx_size, device)
    lut = tab[qctx[qv]]                                       # [B, 256]
    gq12 = (64, 330, 2700)[quant_host.tx_scale(tx_size)]
    scan_t, _ = dev._scan_t(scan, device)

    lv = qc[:, scan_t].abs().clamp(max=255).long()
    dqs = dq[:, scan_t].to(torch.int64)
    eobl = eob.long()
    k = torch.arange(n, device=device)
    in_prefix = k[None, :] < eobl[:, None]
    dd = torch.where(in_prefix, (dqs * dqs * gq12) >> 12, 0)
    dr = torch.where(in_prefix, lut.gather(1, lv), 0)
    zero = torch.zeros((b, 1), dtype=torch.int64, device=device)
    sufd = torch.cat([dd.flip(1).cumsum(1).flip(1), zero], dim=1)
    sufr = torch.cat([dr.flip(1).cumsum(1).flip(1), zero], dim=1)
    e = torch.arange(n + 1, device=device)
    ebits = torch.where(e > 0, (3 << md.RATE_Q) + ebl[e], 307)
    cur_ebits = torch.where(eobl > 0, (3 << md.RATE_Q) + ebl[eobl], 307)
    dcost = (sufd << md.RATE_Q) - ((lam_qv[:, None] * (
        sufr + cur_ebits[:, None] - ebits[None, :])) >> md.LAM_Q)
    valid = e[None, :] <= eobl[:, None]
    dcost = torch.where(valid, dcost, _BIG)
    new_eob = torch.argmin(dcost, dim=1).to(eob.dtype)
    new_eob = torch.where(qv > 0, new_eob, eob)
    keep = k[None, :] < new_eob.long()[:, None]
    keep_raster = torch.zeros((b, n), dtype=torch.bool, device=device)
    keep_raster[:, scan_t] = keep
    return (torch.where(keep_raster, qc, 0), torch.where(keep_raster, dq, 0),
            new_eob)


def quant_stage_plain(coded, scan, qv, log_scale: int, bd: int,
                      tx_size: int, plane_type: int, rdoq_lam_qv=None):
    """The quantization stage of one full-loop pass in plain PyTorch:
    quantize_qv_plain, then (with a lambda vector) rdoq_trim_j, then
    _rate_cdf_j on the trimmed levels. Returns (q, dq [B, n] int32,
    eob [B] int32, rate [B] int64)."""
    qc, dq, eo = dev.quantize_qv_plain(coded, scan, qv, log_scale, bd)
    if rdoq_lam_qv is not None:
        qc, dq, eo = rdoq_trim_j(qc, dq, eo, scan, tx_size, qv, plane_type,
                                 rdoq_lam_qv)
    return qc, dq, eo, _rate_cdf_j(qc, eo, qv, plane_type, tx_size)


@functools.lru_cache(maxsize=64)
def _stage_consts(plane_type: int, tx_size: int, device: torch.device):
    """The fused kernel's rate operands on ``device``: (pointer to the
    level-cost table [4, 256], pointer to the eob bits LUT, both int32
    (their values fit), the trim's gq12), and the tensors, which the
    cache keeps alive."""
    from svt_av1_tpu_torch.entropy import coeff_ctx as cc
    tab = _level_cost_tab(plane_type, int(cc.txs_ctx(tx_size)))
    if not 0 <= tab.min() <= tab.max() < 1 << 31:
        raise ValueError("level-cost table outside int32")
    lut = const(tab.astype(np.int32), device)
    ebl = const(md._eob_bits_lut().astype(np.int32), device)
    gq12 = (64, 330, 2700)[quant_host.tx_scale(tx_size)]
    return (lut.data_ptr(), ebl.data_ptr(), gq12), (lut, ebl)


def quant_stage_j(coded, scan, qv, log_scale: int, bd: int, tx_size: int,
                  plane_type: int, rdoq_lam_qv=None, out=None):
    """quant_stage_plain in one launch of the hand-written kernel
    (csrc/quant.cu, fused mode) on a CUDA tensor; it never falls back.
    On a CPU tensor it runs quant_stage_plain. ``out``: on a CUDA tensor,
    the output tensors to write (``dev.quant_outputs(coded, True)``)."""
    device = coded.device
    if device.type == "cpu":
        return quant_stage_plain(coded, scan, qv, log_scale, bd, tx_size,
                                 plane_type, rdoq_lam_qv)
    if device.type != "cuda":
        raise ValueError(f"quant_stage_j: no kernel for {device}")
    ptrs = _stage_consts(plane_type, tx_size, device)[0]
    mode = dev.QUANT_RATE if rdoq_lam_qv is None else dev.QUANT_TRIM_RATE
    return dev.quant_stage_launch(mode, coded, scan, qv, log_scale, bd,
                                  lam=rdoq_lam_qv, rate_ptrs=ptrs, out=out)


def _quant_stage(*args):
    """The full loop's call of quant_stage_j (looked up on this module at
    each call). While this thread captures a class step
    (``ops/step_graphs.py``) the call is not made: the capture ends its
    graph here, and each replay makes the call into output tensors that
    the capture allocated."""
    cap = step_graphs.capturing()
    if cap is None:
        return quant_stage_j(*args)
    return cap.cut(_replay_quant_stage, args,
                   dev.quant_outputs(args[0], rate=True))


def _replay_quant_stage(*args, out):
    return quant_stage_j(*args, out=out)


def _full_loop_j(srcs, preds, tts, tt_set, tx_size, size, qv, bd,
                 plane_type, rdoq_lam_qv=None):
    """Twin of md._full_loop. tts [B]; tt_set: static tuple of the tx
    types tts can take. qv: [B] int32 qindex vector. Returns
    (qcoeff [B,ch,cw], eob, recon, dist, rate). ``rdoq_lam_qv``: [B]
    lambda vector for the RDOQ-lite trailing trim (None = off)."""
    b = srcs.shape[0]
    device = srcs.device
    w, h = common.leaf_wh(size)
    cw, ch = common.coded_dims(tx_size)
    log_scale = quant_host.tx_scale(tx_size)
    resid = (srcs - preds).to(torch.int32)

    qcoeff = torch.zeros((b, ch, cw), dtype=torch.int32, device=device)
    eob = torch.zeros(b, dtype=torch.int64, device=device)
    recon = torch.zeros((b, h, w), dtype=torch.int64, device=device)
    rate = torch.zeros(b, dtype=torch.int64, device=device)
    for tt in tt_set:
        sel = tts == tt
        coeffs = dev.fwd_tx2d(resid, int(tt), w, h)
        coded = coeffs[:, :ch, :cw].reshape(b, -1).contiguous()
        scan = get_scan(tx_size, int(tt))
        qc, dq, eo, rt = _quant_stage(coded, scan, qv, log_scale, bd,
                                      tx_size, plane_type, rdoq_lam_qv)
        full = torch.zeros((b, h, w), dtype=torch.int32, device=device)
        full[:, :ch, :cw] = dq.reshape(-1, ch, cw).to(torch.int32)
        r = dev.inv_tx2d(full, int(tt), w, h, bd=bd)
        rec = (preds + r).clamp(0, (1 << bd) - 1).to(torch.int64)
        qcoeff = torch.where(sel[:, None, None], qc.reshape(-1, ch, cw),
                             qcoeff)
        eob = torch.where(sel, eo.to(torch.int64), eob)
        recon = torch.where(sel[:, None, None], rec, recon)
        rate = torch.where(sel, rt, rate)
    d = srcs.to(torch.int64) - recon
    dist = (d * d).sum(dim=(1, 2))
    return qcoeff, eob, recon, dist, rate


def _rdcost_j(dist, lamqv, rate):
    """Integer RD cost; lamqv: [B] tensor or a python int."""
    if isinstance(lamqv, torch.Tensor):
        lamqv = lamqv.to(torch.int64)
    return (dist.to(torch.int64) << md.RATE_Q) \
        + ((lamqv * rate.to(torch.int64)) >> md.LAM_Q)


# --- the decide twin ------------------------------------------------------------
def _tt_for_lut(all_cands, plane, tx_size, reduced_tx_set):
    """mode -> chroma tx type mapping restricted to the candidate set."""
    lut = np.zeros(16, dtype=np.int32)
    if plane != 0:
        for m, _ in all_cands:
            lut[m] = common.chroma_tx_type(int(m), tx_size,
                                           reduced_tx_set)
        lut[UV_CFL] = common.chroma_tx_type(UV_CFL, tx_size,
                                            reduced_tx_set)
    return lut


@functools.lru_cache(maxsize=None)
def make_decide_core(plane: int, cands: tuple, size,
                     bd: int, nfl: int, reduced_tx_set: bool,
                     has_forced: bool, has_cfl: bool, tx_search: bool,
                     rdoq: bool = False, edge_filter: bool = False):
    """Build the decide function for a static configuration. The returned
    function takes tensors on one device, with trailing ``qv``/``lamqv``
    [B] quantizer vectors (qindex/lambda are operands, not part of the
    configuration) and, with ``edge_filter``, the intra edge filter's
    ``ftype``/``n_top``/``n_left`` [B] operands after them."""
    bw, bh = common.leaf_wh(size)
    tx_size = common.tx_size_for_rect(bw, bh, plane)
    all_cands = list(cands)
    if plane == 1 and has_cfl and not has_forced:
        all_cands = all_cands + [(UV_CFL, 0)]
    tt_lut = _tt_for_lut(all_cands + [(UV_CFL, 0)], plane, tx_size,
                         reduced_tx_set)
    tt_set = tuple(sorted({int(tt_lut[m]) for m, _ in all_cands}
                          | ({int(tt_lut[UV_CFL])} if has_forced
                             and plane == 2 else set()))) \
        if plane != 0 else (0,)
    mode_bits = md.candidate_mode_bits(tuple(map(tuple, all_cands)),
                                       plane, has_cfl)
    carr = np.asarray(all_cands, dtype=np.int64)
    plane_type = int(plane > 0)
    dev_consts = {}

    def consts_on(device):
        """(tx-type LUT, mode bits, candidate array) on ``device``."""
        if device not in dev_consts:
            dev_consts[device] = (const(tt_lut, device),
                                  const(mode_bits, device),
                                  const(carr, device))
        return dev_consts[device]

    def tts_of(modes):
        if plane == 0:
            return torch.zeros_like(modes, dtype=torch.int32)
        return consts_on(modes.device)[0][modes.long()]

    def cfl_parts(srcs, above1, left1, ha, hl, cfl_luma):
        ac = luma_ac_420_j(cfl_luma)
        dc = dev.predict_modes((0,), above1[:, 1:], left1[:, 1:],
                               above1[:, 0], ha, hl, bw, bh, bd)[0]
        alpha = cfl_fit_alpha_j(ac, srcs, dc)
        return cfl_predict_j(dc, ac, alpha, bd), alpha

    def edge_of(ftype, n_top, n_left):
        if not edge_filter:
            return None
        return ftype.to(torch.int32), n_top.long(), n_left.long()

    def forced_fn(srcs, above1, left1, ha, hl, fmodes, fdeltas,
                  cfl_luma, qv, lamqv, ftype=None, n_top=None, n_left=None):
        b = srcs.shape[0]
        device = srcs.device
        edge = edge_of(ftype, n_top, n_left)
        srcs = srcs.to(torch.int64)
        above1 = above1.to(torch.int32)
        left1 = left1.to(torch.int32)
        fmodes = fmodes.to(torch.int64)
        fdeltas = fdeltas.to(torch.int64)
        if cfl_luma is not None:
            cfl_luma = cfl_luma.to(torch.int64)
        rlq = lamqv if rdoq else None
        pair_set = list(dict.fromkeys(
            [(int(m), int(d)) for m, d in all_cands] + [(UV_CFL, 0)]))
        preds = torch.zeros((b, bh, bw), dtype=torch.int64, device=device)
        alphas = torch.zeros(b, dtype=torch.int64, device=device)
        for m, d in pair_set:
            sel = (fmodes == m) & (fdeltas == d)
            if m == UV_CFL:
                if cfl_luma is None:
                    continue
                p, al = cfl_parts(srcs, above1, left1, ha, hl, cfl_luma)
                alphas = torch.where(sel, al, alphas)
            else:
                p = predict_any_j(m, d, above1, left1, bw, bh, ha, hl, bd,
                                  edge)
            preds = torch.where(sel[:, None, None], p.to(torch.int64),
                                preds)
        ftts = tts_of(fmodes)
        qc, eo, rec, dist, rate = _full_loop_j(
            srcs, preds, ftts, tt_set, tx_size, size, qv, bd,
            plane_type, rdoq_lam_qv=rlq)
        cost = _rdcost_j(dist, lamqv, rate)
        return (fmodes, fdeltas, qc, eo, rec, cost, alphas, ftts)

    def decide_fn(srcs, above1, left1, ha, hl, cfl_luma, qv, lamqv,
                  ftype=None, n_top=None, n_left=None):
        b = srcs.shape[0]
        device = srcs.device
        edge = edge_of(ftype, n_top, n_left)
        srcs = srcs.to(torch.int64)
        above1 = above1.to(torch.int32)
        left1 = left1.to(torch.int32)
        if cfl_luma is not None:
            cfl_luma = cfl_luma.to(torch.int64)
        rlq = lamqv if rdoq else None
        pred_list = []
        cand_alphas = None
        for m, d in all_cands:
            if m == UV_CFL:
                p, cand_alphas = cfl_parts(srcs, above1, left1, ha, hl,
                                           cfl_luma)
            else:
                p = predict_any_j(int(m), int(d), above1, left1, bw, bh,
                                  ha, hl, bd, edge)
            pred_list.append(p.to(torch.int64))
        preds = torch.stack(pred_list, dim=0)                 # [M,B,h,w]
        diff = srcs[None] - preds
        sse = (diff * diff).sum(dim=(2, 3))                   # [M,B]
        k = min(nfl, len(all_cands))
        _, mb, carr_t = consts_on(device)
        fast_cost = (sse << md.RATE_Q) \
            + ((lamqv[None, :].to(torch.int64) * mb[:, None]) >> md.LAM_Q)
        order = torch.argsort(fast_cost, dim=0, stable=True)[:k]
        lanes = torch.arange(b, device=device)
        best_cost = None
        out = None
        out_pred = None
        for kk in range(k):
            idx = order[kk]                                    # [B]
            modes_k = carr_t[idx, 0]
            deltas_k = carr_t[idx, 1]
            preds_k = preds[idx, lanes]
            qc, eo, rec, dist, rate = _full_loop_j(
                srcs, preds_k, tts_of(modes_k), tt_set, tx_size, size,
                qv, bd, plane_type, rdoq_lam_qv=rlq)
            cost = _rdcost_j(dist, lamqv, rate + mb[idx])
            if best_cost is None:
                best_cost = cost
                out = [modes_k, deltas_k, qc, eo, rec, cost]
                out_pred = preds_k
            else:
                better = cost < best_cost
                best_cost = torch.where(better, cost, best_cost)
                out[0] = torch.where(better, modes_k, out[0])
                out[1] = torch.where(better, deltas_k, out[1])
                out[2] = torch.where(better[:, None, None], qc, out[2])
                out[3] = torch.where(better, eo, out[3])
                out[4] = torch.where(better[:, None, None], rec, out[4])
                out[5] = best_cost
                out_pred = torch.where(better[:, None, None], preds_k,
                                       out_pred)
        tts = tts_of(out[0])
        if tx_search and plane == 0:
            tts = _tx_search_j(srcs, out_pred, out, tx_size, size,
                               qv, bd, lamqv, rdoq=rdoq)
        alphas = torch.zeros(b, dtype=torch.int64, device=device)
        if cand_alphas is not None:
            alphas = torch.where(out[0] == UV_CFL, cand_alphas, 0)
        return (out[0], out[1], out[2], out[3], out[4], out[5], alphas,
                tts)

    return forced_fn if has_forced else decide_fn


@functools.lru_cache(maxsize=None)
def _tx_search_consts(tx_size: int, device: torch.device):
    """(probability bits LUT, the intra tx-type CDF rows of ``tx_size``'s
    set by mode) on ``device``, int64."""
    from svt_av1_tpu_torch.entropy import tx_sets
    from svt_av1_tpu_torch.entropy.cdf import default_tables
    from svt_av1_tpu_torch.utils.blocks import TX_SIZE_SQR
    eset = tx_sets.ext_tx_set(tx_size, False, False)
    table = default_tables()["intra_ext_tx"][eset][int(TX_SIZE_SQR[tx_size])]
    return (const(md._prob_bits_lut().astype(np.int64), device),
            const(np.asarray(table).astype(np.int64), device))


def _tx_search_j(srcs, preds, out, tx_size, size, qv, bd, lamqv,
                 rdoq: bool = False):
    """Twin of md._luma_tx_search (in-place update of out)."""
    from svt_av1_tpu_torch.entropy import tx_sets
    b = srcs.shape[0]
    device = srcs.device
    tts = torch.zeros(b, dtype=torch.int32, device=device)
    set_type = tx_sets.ext_tx_set_type(tx_size, False, False)
    if tx_sets.NUM_EXT_TX_SET[set_type] <= 1:
        return tts
    pbl, table = _tx_search_consts(tx_size, device)
    rows = table[out[0].clamp(0, 12).long()]                 # [B, nsyms+1]

    def sig_bits(tt):
        sym = int(tx_sets.EXT_TX_IND[set_type][tt])
        hi = torch.full((b,), 32768, dtype=torch.int64, device=device) \
            if sym == 0 else rows[:, sym - 1]
        p = (hi - rows[:, sym]).clamp(min=1)
        return pbl[p]

    allowed = [int(t) for t in np.nonzero(
        tx_sets.EXT_TX_USED[set_type])[0]]
    rlq = lamqv if rdoq else None
    best_part = None
    for tt in allowed:
        qc, eo, rec, dist, rate = _full_loop_j(
            srcs, preds, torch.full((b,), tt, dtype=torch.int32,
                                    device=device), (tt,),
            tx_size, size, qv, bd, 0, rdoq_lam_qv=rlq)
        part = _rdcost_j(dist, lamqv, rate + sig_bits(tt))
        if best_part is None:
            best_part = part
            continue
        better = part < best_part
        out[5] = torch.where(better, out[5] - best_part + part, out[5])
        best_part = torch.where(better, part, best_part)
        out[2] = torch.where(better[:, None, None], qc, out[2])
        out[3] = torch.where(better, eo, out[3])
        out[4] = torch.where(better[:, None, None], rec, out[4])
        tts = torch.where(better, tt, tts)
    return tts


def quant_vectors(qp, lam, b: int, qv=None, lamv=None):
    """Per-block qindex/lambda operand vectors: scalar broadcast of
    (qp, lam), or the given per-block arrays."""
    if qv is None:
        qv = np.full(b, int(qp.qindex), dtype=np.int32)
    else:
        qv = np.asarray(qv, dtype=np.int32)
    if lamv is None:
        lamqv = np.full(b, md.lam_to_q(lam), dtype=np.int64)
    else:
        lamqv = np.asarray([md.lam_to_q(lv) for lv in lamv],
                           dtype=np.int64)
    return qv, lamqv


def _upload(arrs, bd: int, device):
    """Host inputs -> tensors on ``device`` at narrow wire widths (pixels
    at storage width, edges int16); the decide core widens them."""
    pix = dev.pix_dtype(bd)
    srcs, above1, left1, ha, hl = arrs
    return (const(np.asarray(srcs).astype(np.int32), device).to(pix),
            const(np.asarray(above1, dtype=np.int16), device),
            const(np.asarray(left1, dtype=np.int16), device),
            const(np.asarray(ha, dtype=bool), device),
            const(np.asarray(hl, dtype=bool), device))


def decide_block_batch_dev(plane, srcs, above1, left1, ha, hl, cands, qp,
                           size, lam, bd=8, nfl=3, reduced_tx_set=False,
                           forced=None, cfl_luma=None, tx_search=False,
                           rdoq=False, qv=None, lamv=None, edge=None,
                           device="cuda"):
    """Drop-in twin of md.decide_block_batch running the compute on a
    torch ``device`` (same integer decisions, same numpy return types).
    ``qv``/``lamv``: optional per-block qindex / float-lambda arrays.
    ``edge``: None or (ftype, n_top, n_left) [B] arrays for the normative
    intra edge filter (filt_type and the real above / left sample
    counts)."""
    b = srcs.shape[0]
    pix = np.uint16 if bd > 8 else np.uint8
    ins = _upload((srcs, above1, left1, ha, hl), bd, device)
    cfl_t = None if cfl_luma is None else \
        const(np.asarray(cfl_luma).astype(np.int32), device).to(
            dev.pix_dtype(bd))
    qvec, lamqv = quant_vectors(qp, lam, b, qv, lamv)
    qvec, lamqv = const(qvec, device), const(lamqv, device)
    fn = make_decide_core(plane, tuple(map(tuple, cands)),
                          size if isinstance(size, int) else tuple(size),
                          bd, nfl, reduced_tx_set, forced is not None,
                          cfl_luma is not None, tx_search, rdoq,
                          edge is not None)
    ekw = () if edge is None else tuple(   # narrow wire widths
        const(np.asarray(e, dtype=t), device)
        for e, t in zip(edge, (np.int8, np.int16, np.int16)))
    if forced is not None:
        fm = const(np.asarray(forced[0], dtype=np.int8), device)
        fd = const(np.asarray(forced[1], dtype=np.int8), device)
        outs = fn(*ins, fm, fd, cfl_t, qvec, lamqv, *ekw)
    else:
        outs = fn(*ins, cfl_t, qvec, lamqv, *ekw)
    modes, deltas, qc, eo, rec, cost, alphas, tts = \
        [o.cpu().numpy() for o in outs]
    return (modes.astype(np.int64), deltas.astype(np.int64),
            qc.astype(np.int32), eo.astype(np.int32), rec.astype(pix),
            cost.astype(np.int64), alphas.astype(np.int64),
            tts.astype(np.int32))


def decide_cost_issue(plane, srcs, above1, left1, ha, hl, cands, qp,
                      size, lam, bd=8, nfl=3, tx_search=False,
                      rdoq=False, device="cuda"):
    """Issue-only decide cost for one depth/arm of the intra partition
    DP: returns the rd_cost [B] tensor on ``device`` without waiting for
    it (CUDA runs asynchronously). Fetch it AFTER issuing every depth.
    Same decide core as decide_block_batch_dev, so the costs are
    bit-identical to its rd_cost output."""
    b = srcs.shape[0]
    qvec, lamqv = quant_vectors(qp, lam, b)
    fn = make_decide_core(plane, tuple(map(tuple, cands)),
                          size if isinstance(size, int) else tuple(size),
                          bd, nfl, False, False, False, tx_search, rdoq)
    ins = _upload((srcs, above1, left1, ha, hl), bd, device)
    return fn(*ins, None, const(qvec, device), const(lamqv, device))[5]


# --- SATD open-loop depth scoring (intra partition DP) ---------------------------
# The reference's OIS scores open-loop intra candidates by the SATD of the
# prediction residual (IntraOpenLoopSearchTheseModesOutputBest,
# EbMotionEstimation.c:7419) instead of a full T/Q loop; the partition DP
# only needs relative costs. Twin of the JAX package's satd_modes_dev.

@functools.lru_cache(maxsize=32)
def _hadamard_t(n: int, device: torch.device) -> torch.Tensor:
    return const(common.hadamard_n(n), device, torch.float64)


def satd_modes(srcs, above1, left1, ha, hl, modes, size, bd: int = 8,
               device="cuda") -> torch.Tensor:
    """[B] int64 min over ``modes`` of the size-matched Hadamard SATD
    (tile cap 32) of each block's prediction residual, computed on
    ``device`` from host blocks (the real lanes only: no bucket padding)
    and returned without waiting for it. The transforms run as float64
    products, exact here: with |residual| < 2^10 and tiles of at most
    32x32 every product entry is an integer below 2^21 and every block
    sum below 2^33 (CUDA has no int64 matmul)."""
    srcs, above1, left1, ha, hl = _upload((srcs, above1, left1, ha, hl),
                                          bd, device)
    bw, bh = common.leaf_wh(size)
    tw, th = min(bw, 32), min(bh, 32)
    hh = _hadamard_t(th, srcs.device)
    hw = _hadamard_t(tw, srcs.device)
    srcs = srcs.to(torch.int64)
    above1, left1 = above1.to(torch.int32), left1.to(torch.int32)
    best = None
    for m in modes:
        p = predict_any_j(m, 0, above1, left1, bw, bh, ha, hl, bd)
        r = (srcs - p.to(torch.int64)).reshape(
            -1, bh // th, th, bw // tw, tw).transpose(2, 3).to(torch.float64)
        s = torch.matmul(torch.matmul(hh, r), hw).abs().sum(
            dim=(1, 2, 3, 4)).to(torch.int64)
        best = s if best is None else torch.minimum(best, s)
    return best
