"""PyTorch twin of the JAX package's inter-frame compute core
(``svt_av1_tpu/ops/device_inter.py``).

For every block of one shape group at once: hierarchical full-pel ME over
the decimated pyramid (same row-major offset order, same first-minimum
tie-breaks as ``ops.me.fullpel_search``), quarter-pel refinement, 8-tap
MC, the transform/quant full loop with integer CDF rates (the quantization
stage is one launch of the hand-written kernel on CUDA), the {best-MV,
zero-MV} fold, the compound average candidate, both chroma planes and the
recon scatter — the fused shape-group program. Beside it: the reference
prep (edge padding + the HME pyramid) of a slot's planes, the inter
partition DP's ME work, and the intra-flip decision pass.

qindex and lambda are per-block [B] operands. Every op is integer, so the
decisions equal the JAX twin's and the host path's.

Exactness notes: argmin keeps the first minimum (torch and JAX agree,
CPU and CUDA); every fold is strict ``<``; SADs are summed in int32 and
costs in int64; ``>>`` is arithmetic on signed tensors. Gathers whose
indices the data choose follow the JAX rule (``device.jax_index``: a
negative index counts from the end, then clamps), so no index the JAX
program reads silently can raise here. The JAX program pads each group to
a lane bucket; lanes are independent, so the port runs the real lanes
only and its scatters see no duplicate indices.

Reference equivalents: MotionEstimateLcu ``EbMotionEstimation.c:6152``,
inter full loop ``EbCodingLoop.c:552``, jnt convolve compound
``EbInterPrediction.c:290``.
"""

from __future__ import annotations

import numpy as np
import torch

from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.ops import mc
from svt_av1_tpu_torch.ops.device import const, take2
from svt_av1_tpu_torch.ops.device_md import (_full_loop_j, _rdcost_j,
                                             predict_any_j, quant_vectors)
from svt_av1_tpu_torch.pipeline import common, md

I64MAX = np.iinfo(np.int64).max


def _ar(n: int, device):
    return torch.arange(n, device=device)


# --- full-pel search ------------------------------------------------------------
def _exhaustive_j(ref_padded, curs, iy, ix, centers, radius: int):
    """Twin of me._exhaustive: curs [B,bh,bw] int32, iy/ix gather bases,
    centers [B,2]. Returns (mv [B,2], cost [B]) with the host's row-major
    first-minimum tie-break: one step per dy row over all dx at once
    (argmin keeps the first dx minimum inside a row, strict ``<`` the
    earliest dy across rows). Offsets whose absolute position leaves the
    padded frame cost I64MAX, as on the host."""
    pad = mc.REF_PAD
    device = curs.device
    ht, wt = ref_padded.shape
    b, bh, bw = curs.shape
    k = 2 * radius + 1
    wy = (iy[:, :1, :1] + (centers[:, 0] - radius + pad)[:, None, None]
          + _ar(bh + 2 * radius, device)[None, :, None])
    wx = (ix[:, :1, :1] + (centers[:, 1] - radius + pad)[:, None, None]
          + _ar(bw + 2 * radius, device)[None, None, :])
    win = ref_padded[wy.clamp(0, ht - 1), wx.clamp(0, wt - 1)] \
        .to(torch.int32)
    dxs = torch.arange(-radius, radius + 1, dtype=torch.int64, device=device)
    best_cost = torch.full((b,), I64MAX, dtype=torch.int64, device=device)
    best_mv = torch.zeros((b, 2), dtype=torch.int64, device=device)
    for kdy in range(k):
        dy = kdy - radius
        row = win[:, kdy:kdy + bh]
        cands = torch.stack([row[:, :, dx:dx + bw] for dx in range(k)])
        sads = (curs[None] - cands).abs().sum(dim=(2, 3),
                                              dtype=torch.int32).long()
        cy = centers[:, 0] + dy                                  # [B]
        cx = centers[:, 1][None, :] + dxs[:, None]               # [K, B]
        valid = (cy.abs()[None, :] < pad) & (cx.abs() < pad)
        sads = torch.where(valid, sads, I64MAX)
        kk = torch.argmin(sads, dim=0)                           # first min
        row_cost = sads.gather(0, kk[None])[0]
        row_cx = cx.gather(0, kk[None])[0]
        better = row_cost < best_cost
        best_cost = torch.where(better, row_cost, best_cost)
        best_mv = torch.where(better[:, None],
                              torch.stack([cy, row_cx], dim=1), best_mv)
    return best_mv, best_cost


def _gather_curs(plane, xs, ys, bw: int, bh: int):
    """plane[ys + r, xs + c] as [B, bh, bw] int32, with the index grids."""
    iy = ys[:, None, None] + _ar(bh, plane.device)[None, :, None]
    ix = xs[:, None, None] + _ar(bw, plane.device)[None, None, :]
    return take2(plane, iy, ix).to(torch.int32), iy, ix


def fullpel_search_j(ref_pyr, src_pyr, xs, ys, size, max_range: int = 24):
    """Twin of me.fullpel_search (pyramids passed in): HME 1/4 -> 1/2 ->
    full, then the clamp that keeps the MC window of any refined sub-pel
    candidate inside the padded reference (whole pels toward zero)."""
    ref_full, ref_h, ref_q = ref_pyr
    src_full, src_h, src_q = src_pyr
    bw, bh = common.leaf_wh(size)
    b = xs.shape[0]
    xs = xs.long()
    ys = ys.long()
    zero = torch.zeros((b, 2), dtype=torch.int64, device=xs.device)
    if min(bw, bh) >= 16:
        cq, iyq, ixq = _gather_curs(src_q, xs >> 2, ys >> 2, bw >> 2,
                                    bh >> 2)
        mv_q, _ = _exhaustive_j(ref_q, cq, iyq, ixq, zero,
                                max(2, max_range // 4))
        chh, iyh, ixh = _gather_curs(src_h, xs >> 1, ys >> 1, bw >> 1,
                                     bh >> 1)
        mv_h, _ = _exhaustive_j(ref_h, chh, iyh, ixh, mv_q * 2, 2)
        seed = mv_h * 2
        c0, iy0, ix0 = _gather_curs(src_full, xs, ys, bw, bh)
        # L0 center check: one probe each at seed and zero, then a single
        # radius-3 window at the better center
        _, c_seed = _exhaustive_j(ref_full, c0, iy0, ix0, seed, 0)
        _, c_zero = _exhaustive_j(ref_full, c0, iy0, ix0, zero, 0)
        center = torch.where((c_zero < c_seed)[:, None], zero, seed)
        radius0 = 3
    else:
        c0, iy0, ix0 = _gather_curs(src_full, xs, ys, bw, bh)
        center = zero
        radius0 = max(4, max_range // 2)
    mvs, cost = _exhaustive_j(ref_full, c0, iy0, ix0, center, radius0)
    h, w = src_full.shape
    margin = (mc.REF_PAD - 5) << 2
    r8 = torch.minimum(torch.maximum(mvs[:, 0] * 8, -(ys << 2) - margin),
                       ((h - ys - bh) << 2) + margin)
    c8 = torch.minimum(torch.maximum(mvs[:, 1] * 8, -(xs << 2) - margin),
                       ((w - xs - bw) << 2) + margin)
    return torch.stack([torch.sign(r8) * (r8.abs() // 8),
                        torch.sign(c8) * (c8.abs() // 8)], dim=1), cost


# --- sub-pel refinement ---------------------------------------------------------
def _mc_from_window(win, off_r, off_c, frac_r, frac_c, w: int, h: int,
                    bd: int):
    """8-tap MC over a pre-gathered per-block window [B, h+9, w+9]: two
    local gathers position the (h+7, w+7) filter support, then the
    separable filter of mc_block_batch_j (int32)."""
    b = win.shape[0]
    device = win.device
    fx = dev.mc_filters(w, device)[frac_c]
    fy = dev.mc_filters(h, device)[frac_r]
    idx_c = off_c[:, None] + _ar(w + 7, device)
    sub = win.gather(2, idx_c[:, None, :].expand(b, win.shape[1], w + 7))
    idx_r = off_r[:, None] + _ar(h + 7, device)
    sub = sub.gather(1, idx_r[:, :, None].expand(b, h + 7, w + 7))
    offset_bits = bd + 2 * mc.FILTER_BITS - mc.ROUND0
    final_bits = 2 * mc.FILTER_BITS - mc.ROUND0 - mc.ROUND1
    subc = (1 << (offset_bits - mc.ROUND1)) \
        + (1 << (offset_bits - mc.ROUND1 - 1))
    horiz = torch.full((b, h + 7, w), 1 << (bd + mc.FILTER_BITS - 1),
                       dtype=torch.int32, device=device)
    for k in range(8):
        horiz = horiz + fx[:, k, None, None] * sub[:, :, k:k + w]
    horiz = (horiz + (1 << (mc.ROUND0 - 1))) >> mc.ROUND0
    vert = torch.full((b, h, w), 1 << offset_bits, dtype=torch.int32,
                      device=device)
    for k in range(8):
        vert = vert + fy[:, k, None, None] * horiz[:, k:k + h]
    res = ((vert + (1 << (mc.ROUND1 - 1))) >> mc.ROUND1) - subc
    if final_bits > 0:
        res = (res + (1 << (final_bits - 1))) >> final_bits
    return res.clamp(0, (1 << bd) - 1)


def subpel_refine_j(ref_padded, src_full, xs, ys, size, int_mvs,
                    bd: int = 8, steps=(4, 2), ref_idx=None):
    """Twin of me.subpel_refine: the 9 candidate MCs share one window
    gather (candidates drift at most one whole pel from the full-pel
    center, so a [B, h+9, w+9] window covers every filter support).
    ``ref_idx``: optional [B] plane selector when ``ref_padded`` is a
    stacked [R, H, W] bank. Returns [B, 2] 1/8-pel MVs (unclamped)."""
    bw, bh = common.leaf_wh(size)
    device = xs.device
    xs = xs.long()
    ys = ys.long()
    srcs, _, _ = _gather_curs(src_full, xs, ys, bw, bh)
    srcs = srcs.long()
    mvs = int_mvs.long() * 8
    base_r = ys + int_mvs[:, 0].long()
    base_c = xs + int_mvs[:, 1].long()
    ht, wt = ref_padded.shape[-2:]
    wy = (base_r + mc.REF_PAD - 4)[:, None, None] \
        + _ar(bh + 9, device)[None, :, None]
    wx = (base_c + mc.REF_PAD - 4)[:, None, None] \
        + _ar(bw + 9, device)[None, None, :]
    wy, wx = wy.clamp(0, ht - 1), wx.clamp(0, wt - 1)
    if ref_idx is None:
        win = ref_padded[wy, wx]
    else:
        win = ref_padded[ref_idx.long()[:, None, None], wy, wx]
    win = win.to(torch.int32)

    def cost_of(cand):
        scaled_r = cand[:, 0] << 1
        scaled_c = cand[:, 1] << 1
        off_r = ys + (scaled_r >> 4) - (base_r - 1)
        off_c = xs + (scaled_c >> 4) - (base_c - 1)
        pred = _mc_from_window(win, off_r, off_c, scaled_r & 15,
                               scaled_c & 15, bw, bh, bd)
        d = srcs - pred.long()
        return (d * d).sum(dim=(1, 2))

    best_cost = cost_of(mvs)
    for step in steps:
        for oy, ox in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            cand = mvs + torch.tensor([oy * step, ox * step],
                                      dtype=torch.int64, device=device)
            cost = cost_of(cand)
            better = cost < best_cost
            mvs = torch.where(better[:, None], cand, mvs)
            best_cost = torch.where(better, cost, best_cost)
    return mvs


def _clamp_mvs_j(mvs, xs, ys, bw, bh, plane_w, plane_h, ss=0):
    """Twin of inter.clamp_mvs_batch (1/8-pel units)."""
    margin = (mc.REF_PAD - 5) << (2 + ss)
    r = torch.minimum(torch.maximum(mvs[:, 0], -(ys << (2 + ss)) - margin),
                      ((plane_h - ys - bh) << (2 + ss)) + margin)
    c = torch.minimum(torch.maximum(mvs[:, 1], -(xs << (2 + ss)) - margin),
                      ((plane_w - xs - bw) << (2 + ss)) + margin)
    return torch.stack([r, c], dim=1)


# --- compound prediction ---------------------------------------------------------
def mc_block_batch_conv_j(ref_padded, xs, ys, mvs, w, h, ss=0, bd=8,
                          ref_idx=None):
    """Twin of mc.mc_block_batch_conv (CONV-domain compound side, int64).
    ``ref_idx``: optional [B] plane selector when ``ref_padded`` is a
    stacked [R, H, W] bank."""
    b = xs.shape[0]
    win, frac_r, frac_c = dev.mc_window(ref_padded, xs, ys, mvs, w, h, ss,
                                        ref_idx, flat=False)
    win = win.long()
    fx = dev.mc_filters(w, win.device, torch.int64)[frac_c]
    fy = dev.mc_filters(h, win.device, torch.int64)[frac_r]
    offset_bits = bd + 2 * mc.FILTER_BITS - mc.ROUND0
    horiz = torch.full((b, h + 7, w), 1 << (bd + mc.FILTER_BITS - 1),
                       dtype=torch.int64, device=win.device)
    for k in range(8):
        horiz = horiz + fx[:, k, None, None] * win[:, :, k:k + w]
    horiz = (horiz + (1 << (mc.ROUND0 - 1))) >> mc.ROUND0
    vert = torch.full((b, h, w), 1 << offset_bits, dtype=torch.int64,
                      device=win.device)
    for k in range(8):
        vert = vert + fy[:, k, None, None] * horiz[:, k:k + h]
    return (vert + (1 << (mc.ROUND1_COMP - 1))) >> mc.ROUND1_COMP


def compound_average_j(res0, res1, bd=8):
    """Twin of mc.compound_average (int64)."""
    offset_bits = bd + 2 * mc.FILTER_BITS - mc.ROUND0
    round_bits = 2 * mc.FILTER_BITS - mc.ROUND0 - mc.ROUND1_COMP
    tmp = (res0.long() + res1.long()) >> 1
    tmp = tmp - ((1 << (offset_bits - mc.ROUND1_COMP))
                 + (1 << (offset_bits - mc.ROUND1_COMP - 1)))
    tmp = (tmp + (1 << (round_bits - 1))) >> round_bits
    return tmp.clamp(0, (1 << bd) - 1)


# --- the fused shape group ---------------------------------------------------------
# multi-ref ME + the single-ref pair + the compound fold + both chroma
# planes + the recon scatter, for every block of one shape: decisions are
# those of the host _me_rd_pruned -> _compound_pairs -> chroma chain (same
# argmin tie-breaks, same integer RD, same fold order).

def shape_group(recon, pyrs, ubank, vbank, src_pyr, src_u, src_v, xs, ys,
                size, qv, lamqv, fwd_pos: tuple, bwd_pos: tuple, bd: int,
                rdoq: bool = False):
    """One shape group on tensors of one device. recon: [y, u, v] frame
    planes, written in place at the group's blocks; pyrs: R luma
    pyramids (full, 1/2, 1/4), padded; ubank/vbank: [R, Hc, Wc] padded
    chroma banks; xs/ys [B] int64; qv [B] int32, lamqv [B] int64;
    fwd_pos/bwd_pos: positions of the forward/backward references in the
    bank (empty bwd_pos = no compound search). Returns the 13 decision
    and coefficient outputs of the JAX program, with its dtypes: (cost
    int64, mv int16, mv1 int16, ref position int8, compound bool, fsel
    int8, bsel int8, qc_y int16, eob_y int16, qc_u, eob_u, qc_v, eob_v
    int16)."""
    bw, bh = common.leaf_wh(size)
    cw, ch = bw >> 1, bh >> 1
    tx_size = common.tx_size_for_rect(bw, bh, 0)
    tx_uv = common.tx_size_for_rect(cw, ch, 1)
    ref_sel = bool(fwd_pos) and bool(bwd_pos)
    n_refs = len(pyrs)
    pix = recon[0].dtype
    device = xs.device
    rlq = lamqv if rdoq else None
    b = xs.shape[0]
    src_full = src_pyr[0]
    h, w = src_full.shape

    # --- multi-ref ME ---
    fulls, sads = [], []
    for pyr in pyrs:
        mv, sad = fullpel_search_j(pyr, src_pyr, xs, ys, size)
        fulls.append(mv)
        sads.append(sad)
    sads = torch.stack(sads)                                 # [R, B]
    best_all = torch.argmin(sads, dim=0)
    refs_bank = torch.stack([pyr[0] for pyr in pyrs])
    fulls_a = torch.stack(fulls)                             # [R, B, 2]
    ar = _ar(b, device)

    def refine_for(pos):
        """Sub-pel refine each block against its own winner ref."""
        mv8 = subpel_refine_j(refs_bank, src_full, xs, ys, size,
                              fulls_a[pos, ar], bd=bd, ref_idx=pos)
        return _clamp_mvs_j(mv8, xs, ys, bw, bh, w, h)

    if ref_sel:
        # per-direction winners first: the overall winner is always one
        # of them, so the single-ref candidate needs no third refinement
        fidx = const(np.asarray(fwd_pos, np.int64), device)
        bidx = const(np.asarray(bwd_pos, np.int64), device)
        fsel = torch.argmin(sads[fidx], dim=0)
        bsel = torch.argmin(sads[bidx], dim=0)
        fref = fidx[fsel]                                    # bank positions
        bref = bidx[bsel]
        mv0a = refine_for(fref)
        mv1a = refine_for(bref)
        fwd_mask = np.zeros(n_refs, dtype=bool)
        fwd_mask[list(fwd_pos)] = True
        is_f = const(fwd_mask, device)[best_all]
        mv_win = torch.where(is_f[:, None], mv0a, mv1a)
    else:
        fsel = torch.zeros(b, dtype=torch.int64, device=device)
        bsel = torch.zeros(b, dtype=torch.int64, device=device)
        mv_win = refine_for(best_all)
    srcs, _, _ = _gather_curs(src_full, xs, ys, bw, bh)
    srcs = srcs.long()
    # both single-ref candidates ({refined winner, zero}) through one MC
    # and one full loop as a [2B] batch; the fold is the strict-< of the
    # two-pass sequence
    cand2 = torch.cat([mv_win, torch.zeros_like(mv_win)])
    xs2 = torch.cat([xs, xs])
    ys2 = torch.cat([ys, ys])
    ba2 = torch.cat([best_all, best_all])
    pred2 = dev.mc_block_batch_j(refs_bank, xs2, ys2, cand2, bw, bh, ss=0,
                                 bd=bd, ref_idx=ba2).long()
    qc2, eo2, rec2, dist2, rate2 = _full_loop_j(
        torch.cat([srcs, srcs]), pred2,
        torch.zeros(2 * b, dtype=torch.int32, device=device), (0,),
        tx_size, size, torch.cat([qv, qv]), bd, 0,
        rdoq_lam_qv=None if rlq is None else torch.cat([rlq, rlq]))
    mv_bits2 = (2 << md.RATE_Q) + 256 * (cand2.abs().sum(dim=1) > 0)
    cost2 = _rdcost_j(dist2, torch.cat([lamqv, lamqv]), rate2 + mv_bits2)
    bt = cost2[b:] < cost2[:b]                # zero strictly beats refined
    cost_s = torch.where(bt, cost2[b:], cost2[:b])
    mv_s = torch.where(bt[:, None], cand2[b:], cand2[:b])
    qc_s = torch.where(bt[:, None, None], qc2[b:], qc2[:b])
    eo_s = torch.where(bt, eo2[b:], eo2[:b])
    rec_s = torch.where(bt[:, None, None], rec2[b:], rec2[:b])

    # --- compound fold ---
    comp = torch.zeros(b, dtype=torch.bool, device=device)
    mv1 = torch.zeros_like(mv_s)
    pos_chosen = best_all
    if ref_sel:
        c0 = mc_block_batch_conv_j(refs_bank, xs, ys, mv0a, bw, bh, ss=0,
                                   bd=bd, ref_idx=fref)
        c1 = mc_block_batch_conv_j(refs_bank, xs, ys, mv1a, bw, bh, ss=0,
                                   bd=bd, ref_idx=bref)
        pred_c = compound_average_j(c0, c1, bd)
        qc_c, eo_c, rec_c, dist_c, rate_c = _full_loop_j(
            srcs, pred_c, torch.zeros(b, dtype=torch.int32, device=device),
            (0,), tx_size, size, qv, bd, 0, rdoq_lam_qv=rlq)
        mv_bits_c = (3 << md.RATE_Q) \
            + 256 * ((mv0a.abs().sum(dim=1) > 0).long()
                     + (mv1a.abs().sum(dim=1) > 0))
        cost_c = _rdcost_j(dist_c, lamqv, rate_c + mv_bits_c)
        comp = cost_c < cost_s
        cost_s = torch.where(comp, cost_c, cost_s)
        mv_s = torch.where(comp[:, None], mv0a, mv_s)
        qc_s = torch.where(comp[:, None, None], qc_c, qc_s)
        eo_s = torch.where(comp, eo_c, eo_s)
        rec_s = torch.where(comp[:, None, None], rec_c, rec_s)
        mv1 = torch.where(comp[:, None], mv1a, mv1)
        pos_chosen = torch.where(comp, fref, best_all)

    # --- chroma: both planes as one [2B] batch over the stacked U+V bank
    # (V lanes offset their ref index by n_refs)
    cxs, cys = xs >> 1, ys >> 1
    cxs2 = torch.cat([cxs, cxs])
    cys2 = torch.cat([cys, cys])
    uvbank = torch.cat([ubank, vbank])
    pos_uv = torch.cat([pos_chosen, pos_chosen + n_refs])
    csrc_u, _, _ = _gather_curs(src_u, cxs, cys, cw, ch)
    csrc_v, _, _ = _gather_curs(src_v, cxs, cys, cw, ch)
    csrc2 = torch.cat([csrc_u, csrc_v])
    mvs_uv = torch.cat([mv_s, mv_s])
    pred_uv = dev.mc_block_batch_j(uvbank, cxs2, cys2, mvs_uv, cw, ch, ss=1,
                                   bd=bd, ref_idx=pos_uv).long()
    if ref_sel:
        fref2 = torch.cat([fref, fref + n_refs])
        bref2 = torch.cat([bref, bref + n_refs])
        u0 = mc_block_batch_conv_j(uvbank, cxs2, cys2, mvs_uv, cw, ch, ss=1,
                                   bd=bd, ref_idx=fref2)
        u1 = mc_block_batch_conv_j(uvbank, cxs2, cys2, torch.cat([mv1, mv1]),
                                   cw, ch, ss=1, bd=bd, ref_idx=bref2)
        comp2 = torch.cat([comp, comp])
        pred_uv = torch.where(comp2[:, None, None],
                              compound_average_j(u0, u1, bd), pred_uv)
    qcuv, eouv, recuv, _, _ = _full_loop_j(
        csrc2.long(), pred_uv,
        torch.zeros(2 * b, dtype=torch.int32, device=device), (0,), tx_uv,
        (cw, ch), torch.cat([qv, qv]), bd, 1,
        rdoq_lam_qv=None if rlq is None else torch.cat([rlq, rlq]))

    # --- the block reconstructions into the frame planes (the blocks of a
    # group are disjoint: no index repeats)
    i16 = torch.int16
    iy = ys[:, None, None] + _ar(bh, device)[None, :, None]
    ix = xs[:, None, None] + _ar(bw, device)[None, None, :]
    recon[0][iy, ix] = rec_s.to(pix)
    ciy = cys[:, None, None] + _ar(ch, device)[None, :, None]
    cix = cxs[:, None, None] + _ar(cw, device)[None, None, :]
    recon[1][ciy, cix] = recuv[:b].to(pix)
    recon[2][ciy, cix] = recuv[b:].to(pix)
    return (cost_s, mv_s.to(i16), mv1.to(i16), pos_chosen.to(torch.int8),
            comp, fsel.to(torch.int8), bsel.to(torch.int8), qc_s.to(i16),
            eo_s.to(i16), qcuv[:b].to(i16), eouv[:b].to(i16),
            qcuv[b:].to(i16), eouv[b:].to(i16))


def shape_group_issue(recon_planes, ref_pyrs_list, refs_u, refs_v,
                      src_pyr, src_u, src_v, xs, ys, size, qp, lam,
                      fwd_pos, bwd_pos, bd=8, rdoq=False, qv=None,
                      lamv=None):
    """Enqueue one shape group on the planes' device without waiting for
    it (CUDA runs asynchronously): host block positions and quantizer
    vectors in, device outputs back. ``recon_planes`` are written in
    place. Returns (recon_planes, the 13 outputs, b)."""
    device = recon_planes[0].device
    b = len(xs)
    qvec, lamqv = quant_vectors(qp, lam, b, qv, lamv)
    outs = shape_group(
        recon_planes, ref_pyrs_list, torch.stack(list(refs_u)),
        torch.stack(list(refs_v)), src_pyr, src_u, src_v,
        const(np.asarray(xs, np.int64), device),
        const(np.asarray(ys, np.int64), device), size,
        const(qvec, device), const(lamqv, device), tuple(fwd_pos),
        tuple(bwd_pos), bd, rdoq)
    return recon_planes, outs, b


# --- reference prep ------------------------------------------------------------------
def _edge_pad(p, pad: int, valid=None):
    """Edge-replicate pad of a [H, W] plane by ``pad`` on every side;
    ``valid``: (vh, vw) core whose edge the replication restarts at
    (mc.pad_reference's rule)."""
    h, w = p.shape
    vh, vw = valid if valid is not None else (h, w)
    rows = torch.arange(-pad, h + pad, device=p.device).clamp(0, vh - 1)
    cols = torch.arange(-pad, w + pad, device=p.device).clamp(0, vw - 1)
    return p[rows[:, None], cols[None, :]]


def _decimate(p):
    """Twin of me.decimate2 (average of 2x2, rounded)."""
    h, w = p.shape
    q = p[:h & ~1, :w & ~1].to(torch.int32)
    return ((q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2]
             + q[1::2, 1::2] + 2) >> 2).to(p.dtype)


def src_pyramid_dev(src_full):
    """Twin of me.src_pyramid: the (full, 1/2, 1/4) source pyramid."""
    half = _decimate(src_full)
    return (src_full, half, _decimate(half))


def ref_prep_dev(planes, valid_hw=None):
    """Twin of the JAX ``ref_prep_dev`` (mc.pad_reference + me.build_pyramid)
    on the slot planes' device. ``valid_hw``: (vh, vw) decoder-visible
    luma core when the planes carry bucket-pad bands. Returns (padded
    [y, u, v], luma pyramid (full, 1/2, 1/4), each padded)."""
    pad = mc.REF_PAD
    vy = vc = None
    if valid_hw is not None:
        vy = (int(valid_hw[0]), int(valid_hw[1]))
        vc = (vy[0] // 2, vy[1] // 2)
    py = _edge_pad(planes[0], pad, vy)
    # the decimations run over the band-corrected full plane
    yb = py[pad:-pad, pad:-pad]
    d1 = _decimate(yb)
    d2 = _decimate(d1)
    ph, pq = _edge_pad(d1, pad), _edge_pad(d2, pad)
    return [py, _edge_pad(planes[1], pad, vc),
            _edge_pad(planes[2], pad, vc)], (py, ph, pq)


# --- intra-flip decision -----------------------------------------------------------
def flip_decision(src_full, recon_y, xs, ys, ha, hl, htr, hbl, mwv, mhv,
                  qv, lamqv, modes: tuple, size, bd: int,
                  rdoq: bool = False):
    """The flip decision of one shape group: sources from the source
    plane, prediction edges from the current recon (edge replication
    clamps at the per-lane tile bounds mwv/mhv), each candidate intra
    mode through the full loop. Returns [dist int64, rate int32] per mode,
    integer-identical to the host predict_any + _full_loop pair."""
    from svt_av1_tpu_torch.ops.device_tile import _edges_j
    bw, bh = common.leaf_wh(size)
    tx_size = common.tx_size_for_rect(bw, bh, 0)
    a1, l1 = _edges_j(recon_y, xs, ys, bw, bh, ha, hl, htr, hbl, bd, mwv,
                      mhv)
    rlq = lamqv if rdoq else None
    srcs, _, _ = _gather_curs(src_full, xs, ys, bw, bh)
    srcs = srcs.long()
    b = xs.shape[0]
    outs = []
    for m in modes:
        pred = predict_any_j(int(m), 0, a1, l1, bw, bh, ha, hl, bd).long()
        _, _, _, dist, rate = _full_loop_j(
            srcs, pred, torch.zeros(b, dtype=torch.int32, device=xs.device),
            (0,), tx_size, size, qv, bd, 0, rdoq_lam_qv=rlq)
        outs += [dist, rate.to(torch.int32)]
    return outs


def flip_decision_issue(src_full, recon_y, xs, ys, ha, hl, htr, hbl,
                        modes, size, qp, lam, mwv, mhv, bd=8,
                        rdoq=False, qv=None, lamv=None):
    """Enqueue (no wait) the flip decision of one shape group on the
    recon's device from host lane arrays; returns (outputs, b):
    outs[2i], outs[2i+1] = (dist, rate) of modes[i]."""
    device = recon_y.device
    b = len(xs)
    qvec, lamqv = quant_vectors(qp, lam, b, qv, lamv)

    def t(a, dt):
        return const(np.asarray(a, dt), device)

    outs = flip_decision(
        src_full, recon_y, t(xs, np.int64), t(ys, np.int64), t(ha, bool),
        t(hl, bool), t(htr, bool), t(hbl, bool), t(mwv, np.int64),
        t(mhv, np.int64), t(qvec, np.int32), t(lamqv, np.int64),
        tuple(modes), size if isinstance(size, int) else tuple(size), bd,
        rdoq)
    return outs, b


# --- inter partition DP (twin of rd.choose_partition_inter's depth costs:
# ME + SSE of the compensated block for every depth and arm) -------------------------
def _sse_at_j(ref_full, src_full, xs, ys, mvs, bw: int, bh: int):
    """Integer SSE of src[y:y+bh, x:x+bw] vs ref at (y+mv0, x+mv1)."""
    pad = mc.REF_PAD
    device = xs.device
    iy = ys[:, None, None] + _ar(bh, device)[None, :, None]
    ix = xs[:, None, None] + _ar(bw, device)[None, None, :]
    ry = iy + (mvs[:, 0] + pad)[:, None, None]
    rx = ix + (mvs[:, 1] + pad)[:, None, None]
    d = take2(src_full, iy, ix).long() - take2(ref_full, ry, rx).long()
    return (d * d).sum(dim=(1, 2))


def _seeded_refine(ref_full, src_full, xs, ys, bw, bh, seeds):
    """Radius-3 windows around the seeds and around zero; the zero MV
    only where it is strictly better."""
    curs, iy, ix = _gather_curs(src_full, xs, ys, bw, bh)
    mv_s, c_s = _exhaustive_j(ref_full, curs, iy, ix, seeds, 3)
    mv_z, c_z = _exhaustive_j(ref_full, curs, iy, ix,
                              torch.zeros_like(seeds), 3)
    return torch.where((c_z < c_s)[:, None], mv_z, mv_s)


def dp_all(ref_pyr, src_pyr, w_eff: int, h_eff: int, sizes: tuple,
           arm_spec: tuple):
    """The whole inter partition DP's device work: every depth's seeded
    square search (the root a full HME; children refine around their
    parent's MV) and every rect/4:1 arm refine around its node's square
    MV. Returns [mvs int16, sse int64] per depth, each followed by its
    arms'."""
    device = ref_pyr[0].device
    src_full = src_pyr[0]

    def grid(size):
        gx, gy = np.meshgrid(np.arange(0, w_eff, size),
                             np.arange(0, h_eff, size))
        return gx.reshape(-1), gy.reshape(-1)

    outs = []
    parent_mvs = parent_size = None
    for size in sizes:
        gx, gy = grid(size)
        xs = const(gx.astype(np.int64), device)
        ys = const(gy.astype(np.int64), device)
        if parent_mvs is None:
            mvs, _ = fullpel_search_j(ref_pyr, src_pyr, xs, ys, size)
        else:
            pcols = (w_eff + parent_size - 1) // parent_size
            sidx = const((gy // parent_size) * pcols + gx // parent_size,
                         device, torch.long)
            mvs = _seeded_refine(ref_pyr[0], src_full, xs, ys, size, size,
                                 parent_mvs[sidx])
        sse = _sse_at_j(ref_pyr[0], src_full, xs, ys, mvs, size, size)
        outs += [mvs.to(torch.int16), sse]
        parent_mvs, parent_size = mvs, size
        for (asize, wh, offs) in arm_spec:
            if asize != size:
                continue
            aw, ah = wh
            # out-of-area sub-blocks: coordinates clamped for the gathers;
            # the caller masks their costs
            xs2 = const(np.concatenate([gx + dx for dx, _ in offs])
                        .astype(np.int64), device) \
                .clamp(max=src_full.shape[1] - aw)
            ys2 = const(np.concatenate([gy + dy for _, dy in offs])
                        .astype(np.int64), device) \
                .clamp(max=src_full.shape[0] - ah)
            amvs = _seeded_refine(ref_pyr[0], src_full, xs2, ys2, aw, ah,
                                  torch.cat([mvs] * len(offs)))
            outs += [amvs.to(torch.int16),
                     _sse_at_j(ref_pyr[0], src_full, xs2, ys2, amvs, aw,
                               ah)]
    return outs


def dp_all_dev(ref_pyr, src_pyr, w_eff: int, h_eff: int, sizes,
               arm_spec):
    """Run dp_all on the pyramids' device; returns {size: (mvs, sse),
    (size, (w, h)): (mvs, sse)} as int64 numpy."""
    outs = dp_all(ref_pyr, src_pyr, w_eff, h_eff, tuple(sizes),
                  tuple((s, tuple(wh), tuple(offs))
                        for s, wh, offs in arm_spec))
    outs = [o.cpu().numpy().astype(np.int64) for o in outs]
    res = {}
    k = 0
    for size in sizes:
        res[size] = (outs[k], outs[k + 1])
        k += 2
        for (asize, wh, offs) in arm_spec:
            if asize != size:
                continue
            res[(size, tuple(wh))] = (outs[k], outs[k + 1])
            k += 2
    return res
