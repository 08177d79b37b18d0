"""PyTorch twin of the JAX package's inter-frame compute core
(``svt_av1_tpu/ops/device_inter.py``).

For every block of one shape group at once: hierarchical full-pel ME over
the decimated pyramid (same row-major offset order, same first-minimum
tie-breaks as ``ops.me.fullpel_search``), quarter-pel refinement, 8-tap
MC, the transform/quant full loop with integer CDF rates (the quantization
stage is one launch of the hand-written kernel on CUDA), the {best-MV,
zero-MV} fold, the compound average candidate, the interpolation-filter
search and the inter tx-type sweep where enabled, both chroma planes and
the recon scatter — the shape-group program. Beside it: the reference
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
from svt_av1_tpu_torch.utils.trace import span

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


def fullpel_search_j(ref_pyr, src_pyr, xs, ys, size, max_range: int = 24,
                     plane_hw=None):
    """Twin of me.fullpel_search (pyramids passed in): HME 1/4 -> 1/2 ->
    full, then the clamp that keeps the MC window of any refined sub-pel
    candidate inside the padded reference (whole pels toward zero).
    ``plane_hw``: the (h, w) of the plane that clamp sees, where it is not
    the full source level's (the bucket-padded planes)."""
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
    h, w = src_full.shape if plane_hw is None else plane_hw
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
    fx = dev.mc_filter_rows(w, frac_c)
    fy = dev.mc_filter_rows(h, frac_r)
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
                          ref_idx=None, ftype=0):
    """Twin of mc.mc_block_batch_conv (CONV-domain compound side, int64).
    ``ref_idx``: optional [B] plane selector when ``ref_padded`` is a
    stacked [R, H, W] bank; ``ftype``: an int (0 = REGULAR) or a [B]
    tensor of interpolation filters."""
    b = xs.shape[0]
    win, frac_r, frac_c = dev.mc_window(ref_padded, xs, ys, mvs, w, h, ss,
                                        ref_idx, flat=False)
    win = win.long()
    fx = dev.mc_filter_rows(w, frac_c, ftype, torch.int64)
    fy = dev.mc_filter_rows(h, frac_r, ftype, torch.int64)
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


# --- the shape group, stage by stage ---------------------------------------------
# multi-ref ME + the single-ref pair (me_rd_j), the compound fold
# (compound_j), the interpolation-filter search (interp_filter_select_j)
# and the inter tx-type sweep (inter_tx_search_j) where the config enables
# them, both chroma planes (chroma_j) and the recon scatter, for every
# block of one shape (shape_group): decisions are those of the host
# _me_rd_pruned -> _compound_pairs -> searches -> chroma chain (same argmin
# tie-breaks, same integer RD, same fold order). A group's state is a dict
# of tensors: the luma bank and the sources (bank, srcs), the winner's
# cost, mv, mv1, pos (its bank position; the forward one for compound),
# comp, qc, eo, rec and pred (its luma prediction), fsel/bsel; where
# compound is searched the direction winners' bank positions and MVs
# (fref, bref, mv0a, mv1a); after the searches the per-lane filter (ftype)
# and luma tx type (tts).

def me_rd_j(pyrs, src_pyr, xs, ys, size, qv, lamqv, fwd_pos: tuple,
            bwd_pos: tuple, bd: int, rdoq: bool = False):
    """Multi-ref full-pel ME, sub-pel refinement of the per-direction (or
    overall) winners and the single-ref RD pair {refined MV, zero MV} on
    the overall winner (twin of _me_rd_pruned). pyrs: R luma pyramids
    (full, 1/2, 1/4), padded; xs/ys [B] int64; qv [B] int32, lamqv [B]
    int64; fwd_pos/bwd_pos: positions of the forward/backward references
    in the bank (empty bwd_pos = no compound search). Returns the group
    state."""
    bw, bh = common.leaf_wh(size)
    tx_size = common.tx_size_for_rect(bw, bh, 0)
    ref_sel = bool(fwd_pos) and bool(bwd_pos)
    n_refs = len(pyrs)
    device = xs.device
    rlq = lamqv if rdoq else None
    b = xs.shape[0]
    src_full = src_pyr[0]
    h, w = src_full.shape

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

    g = {"bank": refs_bank}
    if ref_sel:
        # per-direction winners first: the overall winner is always one
        # of them, so the single-ref candidate needs no third refinement
        fidx = const(np.asarray(fwd_pos, np.int64), device)
        bidx = const(np.asarray(bwd_pos, np.int64), device)
        fsel = torch.argmin(sads[fidx], dim=0)
        bsel = torch.argmin(sads[bidx], dim=0)
        g.update(fref=fidx[fsel], bref=bidx[bsel])           # bank positions
        g["mv0a"] = refine_for(g["fref"])
        g["mv1a"] = refine_for(g["bref"])
        fwd_mask = np.zeros(n_refs, dtype=bool)
        fwd_mask[list(fwd_pos)] = True
        is_f = const(fwd_mask, device)[best_all]
        mv_win = torch.where(is_f[:, None], g["mv0a"], g["mv1a"])
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
    bt3 = bt[:, None, None]
    g.update(srcs=srcs, pos=best_all, fsel=fsel, bsel=bsel,
             cost=torch.where(bt, cost2[b:], cost2[:b]),
             mv=torch.where(bt[:, None], cand2[b:], cand2[:b]),
             qc=torch.where(bt3, qc2[b:], qc2[:b]),
             eo=torch.where(bt, eo2[b:], eo2[:b]),
             rec=torch.where(bt3, rec2[b:], rec2[:b]),
             pred=torch.where(bt3, pred2[b:], pred2[:b]),
             comp=torch.zeros(b, dtype=torch.bool, device=device),
             mv1=torch.zeros((b, 2), dtype=torch.int64, device=device))
    return g


def compound_j(g, xs, ys, size, qv, lamqv, bd: int, rdoq: bool = False):
    """The compound candidate (the per-direction winners' average) and
    its strict-< fold over the single-ref winner (twin of
    _compound_pairs and its fold in _encode_blocks). Updates ``g``."""
    if "fref" not in g:
        return
    bw, bh = common.leaf_wh(size)
    tx_size = common.tx_size_for_rect(bw, bh, 0)
    b = xs.shape[0]
    bank = g["bank"]
    c0 = mc_block_batch_conv_j(bank, xs, ys, g["mv0a"], bw, bh, ss=0,
                               bd=bd, ref_idx=g["fref"])
    c1 = mc_block_batch_conv_j(bank, xs, ys, g["mv1a"], bw, bh, ss=0,
                               bd=bd, ref_idx=g["bref"])
    pred_c = compound_average_j(c0, c1, bd)
    qc_c, eo_c, rec_c, dist_c, rate_c = _full_loop_j(
        g["srcs"], pred_c,
        torch.zeros(b, dtype=torch.int32, device=xs.device), (0,),
        tx_size, size, qv, bd, 0, rdoq_lam_qv=lamqv if rdoq else None)
    mv_bits_c = (3 << md.RATE_Q) \
        + 256 * ((g["mv0a"].abs().sum(dim=1) > 0).long()
                 + (g["mv1a"].abs().sum(dim=1) > 0))
    cost_c = _rdcost_j(dist_c, lamqv, rate_c + mv_bits_c)
    comp = cost_c < g["cost"]
    c3 = comp[:, None, None]
    g.update(comp=comp, cost=torch.where(comp, cost_c, g["cost"]),
             mv=torch.where(comp[:, None], g["mv0a"], g["mv"]),
             mv1=torch.where(comp[:, None], g["mv1a"], g["mv1"]),
             qc=torch.where(c3, qc_c, g["qc"]),
             eo=torch.where(comp, eo_c, g["eo"]),
             rec=torch.where(c3, rec_c, g["rec"]),
             pred=torch.where(c3, pred_c, g["pred"]),
             pos=torch.where(comp, g["fref"], g["pos"]))


def _winner_pred_j(g, xs, ys, size, bd: int, ftype):
    """The winner's luma prediction with interpolation filter ``ftype``
    (an int or a [B] tensor): single-ref MC, or the compound average of
    two CONV-domain sides, each with the block's filter (twin of
    _winner_preds)."""
    bw, bh = common.leaf_wh(size)
    bank = g["bank"]
    pred = dev.mc_block_batch_j(bank, xs, ys, g["mv"], bw, bh, ss=0, bd=bd,
                                ref_idx=g["pos"], ftype=ftype).long()
    if "fref" not in g:
        return pred
    c0 = mc_block_batch_conv_j(bank, xs, ys, g["mv"], bw, bh, ss=0, bd=bd,
                               ref_idx=g["fref"], ftype=ftype)
    c1 = mc_block_batch_conv_j(bank, xs, ys, g["mv1"], bw, bh, ss=0, bd=bd,
                               ref_idx=g["bref"], ftype=ftype)
    return torch.where(g["comp"][:, None, None],
                       compound_average_j(c0, c1, bd), pred)


def interp_filter_select_j(g, xs, ys, size, qv, lamqv, bd: int,
                           rdoq: bool = False):
    """Per-block switchable-filter decision on the ME/compound winner
    (twin of _interp_filter_select): the 3 candidate predictions, luma
    SSE in int64, the rate-aware first-minimum argmin of rdcost(sse, lamq,
    0 | 2 << RATE_Q), then the exact full loop of the winning prediction
    with the single/compound MV bits, kept on the blocks that left
    REGULAR. Every lane is recoded and selected, so nothing is read back.
    Updates ``g`` (cost, qc, eo, rec, pred) and sets g["ftype"] [B]."""
    bw, bh = common.leaf_wh(size)
    tx_size = common.tx_size_for_rect(bw, bh, 0)
    b = xs.shape[0]
    device = xs.device
    preds = [g["pred"]] + [_winner_pred_j(g, xs, ys, size, bd, f)
                           for f in range(1, mc.SWITCHABLE_FILTERS)]
    costs = []
    for f, pred in enumerate(preds):
        d = g["srcs"] - pred
        rate = torch.full((b,), 0 if f == 0 else 2 << md.RATE_Q,
                          dtype=torch.int64, device=device)
        costs.append(_rdcost_j((d * d).sum(dim=(1, 2)), lamqv, rate))
    ftype = torch.argmin(torch.stack(costs), dim=0)          # first min
    pred = torch.stack(preds)[ftype, _ar(b, device)]
    qc, eo, rec, dist, rate = _full_loop_j(
        g["srcs"], pred, torch.zeros(b, dtype=torch.int32, device=device),
        (0,), tx_size, size, qv, bd, 0, rdoq_lam_qv=lamqv if rdoq else None)
    nz0 = (g["mv"].abs().sum(dim=1) > 0).long()
    nz1 = (g["mv1"].abs().sum(dim=1) > 0).long()
    mv_bits = torch.where(g["comp"], (3 << md.RATE_Q) + 256 * (nz0 + nz1),
                          (2 << md.RATE_Q) + 256 * nz0)
    redo = ftype != 0
    r3 = redo[:, None, None]
    g.update(ftype=ftype, pred=pred,
             cost=torch.where(redo, _rdcost_j(dist, lamqv, rate + mv_bits),
                              g["cost"]),
             qc=torch.where(r3, qc, g["qc"]),
             eo=torch.where(redo, eo, g["eo"]),
             rec=torch.where(r3, rec, g["rec"]))


def inter_tx_search_j(g, size, qv, bd: int, lamqv, rdoq: bool = False):
    """Encode-pass tx-type sweep of decided inter blocks (twin of
    md.inter_tx_search): with the winning prediction g["pred"] fixed,
    every type of the inter ext-tx set in order through the full loop,
    the DCT pass as the baseline, strict ``<`` folds and the in-place
    ``cost - best_part + part`` update; the signalling rate is the
    default-CDF bits of the inter_ext_tx symbol (host constants). Lanes
    at qindex 0 keep DCT_DCT and their state. Updates ``g`` and, where
    the set has more than DCT_DCT, sets g["tts"] [B] int64."""
    from svt_av1_tpu_torch.entropy import tx_sets
    from svt_av1_tpu_torch.entropy.cdf import default_tables
    from svt_av1_tpu_torch.utils.blocks import TX_SIZE_SQR
    bw, bh = common.leaf_wh(size)
    tx_size = common.tx_size_for_rect(bw, bh, 0)
    srcs, preds = g["srcs"], g["pred"]
    b = srcs.shape[0]
    device = srcs.device
    set_type = tx_sets.ext_tx_set_type(tx_size, True, False)
    if tx_sets.NUM_EXT_TX_SET[set_type] <= 1:
        return
    tts = torch.zeros(b, dtype=torch.int64, device=device)
    eset = tx_sets.ext_tx_set(tx_size, True, False)
    row = default_tables()["inter_ext_tx"][eset][int(TX_SIZE_SQR[tx_size])] \
        .astype(np.int64)
    pbl = md._prob_bits_lut()

    def sig_bits(tt):
        sym = int(tx_sets.EXT_TX_IND[set_type][tt])
        hi = 32768 if sym == 0 else int(row[sym - 1])
        return int(pbl[max(int(hi - row[sym]), 1)])

    live = qv > 0
    rlq = lamqv if rdoq else None
    best_part = None
    for tt in (int(t) for t in np.nonzero(tx_sets.EXT_TX_USED[set_type])[0]):
        qc, eo, rec, dist, rate = _full_loop_j(
            srcs, preds, torch.full((b,), tt, dtype=torch.int32,
                                    device=device), (tt,),
            tx_size, size, qv, bd, 0, rdoq_lam_qv=rlq)
        part = _rdcost_j(dist, lamqv, rate + sig_bits(tt))
        if best_part is None:                 # DCT_DCT baseline (tt == 0)
            best_part = part
            continue
        better = (part < best_part) & live
        b3 = better[:, None, None]
        g.update(cost=torch.where(better, g["cost"] - best_part + part,
                                  g["cost"]),
                 qc=torch.where(b3, qc, g["qc"]),
                 eo=torch.where(better, eo, g["eo"]),
                 rec=torch.where(b3, rec, g["rec"]))
        best_part = torch.where(better, part, best_part)
        tts = torch.where(better, tt, tts)
    g["tts"] = tts


def _chroma_tx_types(g, tx_size: int, tx_uv: int):
    """Inter chroma inherits the luma tx type (spec 8.3.2), demoted to
    DCT where luma coded no coefficients or outside the chroma set: the
    per-lane types [2B] int32 (U lanes, then V) and the static tuple of
    the types they can take (the image of the luma set)."""
    from svt_av1_tpu_torch.entropy import tx_sets
    b = g["eo"].shape[0]
    if "tts" not in g:
        return torch.zeros(2 * b, dtype=torch.int32,
                           device=g["eo"].device), (0,)
    lut = np.array([common.chroma_tx_type_inter(t, tx_uv, False)
                    for t in range(16)], np.int64)
    used = tx_sets.EXT_TX_USED[tx_sets.ext_tx_set_type(tx_size, True, False)]
    ctts = const(lut, g["eo"].device)[torch.where(g["eo"] > 0, g["tts"], 0)]
    return (torch.cat([ctts, ctts]).to(torch.int32),
            tuple(sorted({int(lut[t]) for t in np.nonzero(used)[0]})))


def chroma_j(g, ubank, vbank, src_u, src_v, xs, ys, size, qv, lamqv,
             bd: int, rdoq: bool = False):
    """Both chroma planes of the winners as one [2B] batch over the
    stacked U+V bank (V lanes offset their ref index by R): single-ref MC
    or the compound average, with the blocks' interpolation filters
    (g["ftype"], REGULAR without it), then the full loop with
    ``plane_type`` 1 and the luma tx types inherited (g["tts"], DCT
    without it). Returns (qc, eo, rec) [2B] (U lanes, then V)."""
    bw, bh = common.leaf_wh(size)
    cw, ch = bw >> 1, bh >> 1
    tx_uv = common.tx_size_for_rect(cw, ch, 1)
    n_refs = ubank.shape[0]
    rlq = lamqv if rdoq else None
    cxs, cys = xs >> 1, ys >> 1
    cxs2 = torch.cat([cxs, cxs])
    cys2 = torch.cat([cys, cys])
    uvbank = torch.cat([ubank, vbank])
    ft2 = torch.cat([g["ftype"], g["ftype"]]) if "ftype" in g else 0
    pos_uv = torch.cat([g["pos"], g["pos"] + n_refs])
    csrc_u, _, _ = _gather_curs(src_u, cxs, cys, cw, ch)
    csrc_v, _, _ = _gather_curs(src_v, cxs, cys, cw, ch)
    mvs_uv = torch.cat([g["mv"], g["mv"]])
    pred_uv = dev.mc_block_batch_j(uvbank, cxs2, cys2, mvs_uv, cw, ch, ss=1,
                                   bd=bd, ref_idx=pos_uv, ftype=ft2).long()
    if "fref" in g:
        fref2 = torch.cat([g["fref"], g["fref"] + n_refs])
        bref2 = torch.cat([g["bref"], g["bref"] + n_refs])
        u0 = mc_block_batch_conv_j(uvbank, cxs2, cys2, mvs_uv, cw, ch, ss=1,
                                   bd=bd, ref_idx=fref2, ftype=ft2)
        u1 = mc_block_batch_conv_j(uvbank, cxs2, cys2,
                                   torch.cat([g["mv1"], g["mv1"]]), cw, ch,
                                   ss=1, bd=bd, ref_idx=bref2, ftype=ft2)
        comp2 = torch.cat([g["comp"], g["comp"]])
        pred_uv = torch.where(comp2[:, None, None],
                              compound_average_j(u0, u1, bd), pred_uv)
    ctts, ctt_set = _chroma_tx_types(
        g, common.tx_size_for_rect(bw, bh, 0), tx_uv)
    qcuv, eouv, recuv, _, _ = _full_loop_j(
        torch.cat([csrc_u, csrc_v]).long(), pred_uv, ctts, ctt_set,
        tx_uv, (cw, ch), torch.cat([qv, qv]), bd, 1,
        rdoq_lam_qv=None if rlq is None else torch.cat([rlq, rlq]))
    return qcuv, eouv, recuv


def scatter_recon(recon, g, uv, xs, ys, size):
    """The group's block reconstructions into the frame planes (the blocks
    of a group are disjoint: no index repeats); ``uv``: chroma_j's
    output."""
    bw, bh = common.leaf_wh(size)
    cw, ch = bw >> 1, bh >> 1
    b = xs.shape[0]
    pix = recon[0].dtype
    device = xs.device
    iy = ys[:, None, None] + _ar(bh, device)[None, :, None]
    ix = xs[:, None, None] + _ar(bw, device)[None, None, :]
    recon[0][iy, ix] = g["rec"].to(pix)
    cys, cxs = ys >> 1, xs >> 1
    ciy = cys[:, None, None] + _ar(ch, device)[None, :, None]
    cix = cxs[:, None, None] + _ar(cw, device)[None, None, :]
    recon[1][ciy, cix] = uv[2][:b].to(pix)
    recon[2][ciy, cix] = uv[2][b:].to(pix)


def group_outputs(g, uv) -> tuple:
    """The 13 decision and coefficient outputs of the JAX shape-group
    program, with its dtypes: (cost int64, mv int16, mv1 int16, ref
    position int8, compound bool, fsel int8, bsel int8, qc_y int16,
    eob_y int16, qc_u, eob_u, qc_v, eob_v int16), then the searches'
    interpolation filter and luma tx type (int8; 0 where a search is
    off)."""
    i16, i8 = torch.int16, torch.int8
    qcuv, eouv, _ = uv
    b = g["cost"].shape[0]
    zero = torch.zeros(b, dtype=i8, device=g["cost"].device)
    return (g["cost"], g["mv"].to(i16), g["mv1"].to(i16), g["pos"].to(i8),
            g["comp"], g["fsel"].to(i8), g["bsel"].to(i8), g["qc"].to(i16),
            g["eo"].to(i16), qcuv[:b].to(i16), eouv[:b].to(i16),
            qcuv[b:].to(i16), eouv[b:].to(i16),
            g["ftype"].to(i8) if "ftype" in g else zero,
            g["tts"].to(i8) if "tts" in g else zero)


def shape_group(recon, pyrs, ubank, vbank, src_pyr, src_u, src_v, xs, ys,
                size, qv, lamqv, fwd_pos: tuple, bwd_pos: tuple, bd: int,
                rdoq: bool = False, filter_search: bool = False,
                tx_search: bool = False):
    """One shape group on tensors of one device, stage by stage (spans
    me_rd, compound, interp_filter_search, inter_tx_search, as the JAX
    package names them): recon: [y, u, v] frame planes, written in place
    at the group's blocks; ubank/vbank: [R, Hc, Wc] padded chroma banks;
    ``filter_search``/``tx_search``: the config's
    enable_interp_filter_search / enable_tx_type_search. Returns
    group_outputs."""
    with span("me_rd"):
        g = me_rd_j(pyrs, src_pyr, xs, ys, size, qv, lamqv, fwd_pos,
                    bwd_pos, bd, rdoq)
    with span("compound"):
        compound_j(g, xs, ys, size, qv, lamqv, bd, rdoq)
    if filter_search:
        with span("interp_filter_search"):
            interp_filter_select_j(g, xs, ys, size, qv, lamqv, bd, rdoq)
    if tx_search:
        with span("inter_tx_search"):
            inter_tx_search_j(g, size, qv, bd, lamqv, rdoq)
    uv = chroma_j(g, ubank, vbank, src_u, src_v, xs, ys, size, qv, lamqv,
                  bd, rdoq)
    scatter_recon(recon, g, uv, xs, ys, size)
    return group_outputs(g, uv)


def shape_group_issue(recon_planes, ref_pyrs_list, refs_u, refs_v,
                      src_pyr, src_u, src_v, xs, ys, size, qp, lam,
                      fwd_pos, bwd_pos, bd=8, rdoq=False, qv=None,
                      lamv=None, filter_search=False, tx_search=False):
    """Enqueue one shape group on the planes' device without waiting for
    it (CUDA runs asynchronously): host block positions and quantizer
    vectors in, device outputs back. ``recon_planes`` are written in
    place. Returns (recon_planes, the 15 outputs, b)."""
    device = recon_planes[0].device
    b = len(xs)
    qvec, lamqv = quant_vectors(qp, lam, b, qv, lamv)
    outs = shape_group(
        recon_planes, ref_pyrs_list, torch.stack(list(refs_u)),
        torch.stack(list(refs_v)), src_pyr, src_u, src_v,
        const(np.asarray(xs, np.int64), device),
        const(np.asarray(ys, np.int64), device), size,
        const(qvec, device), const(lamqv, device), tuple(fwd_pos),
        tuple(bwd_pos), bd, rdoq, filter_search, tx_search)
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
    arms'. The root search clamps its MVs to the 64-padded frame, not to
    the bucket-padded source plane: the JAX package's host DP searches
    the 64-padded luma (its device twin clamps to the bucket, and the two
    differ where the bucket is larger and an MV reaches the clamp)."""
    device = ref_pyr[0].device
    src_full = src_pyr[0]
    plane_hw = (-(-h_eff // 64) * 64, -(-w_eff // 64) * 64)

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
            mvs, _ = fullpel_search_j(ref_pyr, src_pyr, xs, ys, size,
                                      plane_hw=plane_hw)
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


# --- programs no encoder path reaches ----------------------------------------------
# (the JAX package's ref_candidates_dev, chroma_multi_dev and flip_rd_dev:
# numpy in, numpy out, composed of the shape group's stages; each runs on
# ``device``, a CUDA device without a card raising)

def _np_planes(planes, bd: int, device):
    """Numpy pixel planes as ``dev.pix_dtype`` tensors on ``device``."""
    return tuple(const(np.asarray(p).astype(np.int32), device)
                 .to(dev.pix_dtype(bd)) for p in planes)


def ref_candidates_dev(ref_pyr, src_pyr, xs, ys, size, qp, lam, bd=8,
                       rdoq=False, qv=None, lamv=None, device="cuda"):
    """Twin of the JAX ``ref_candidates_dev`` (inter._ref_candidates for
    one reference): the HME full-pel search and the sub-pel refinement,
    then the {refined MV, zero MV} pair through MC and the full loop,
    folded by strict ``<`` on the RD cost with the MV bits. ref_pyr /
    src_pyr: numpy (full, 1/2, 1/4) pyramids (the reference's padded).
    Returns [cost int64, mv int64, qc int32, eo int32, recon pixels]."""
    from svt_av1_tpu_torch.pipeline.encoder import check_device
    device = check_device(device)
    bw, bh = common.leaf_wh(size)
    tx_size = common.tx_size_for_rect(bw, bh, 0)
    b = len(xs)
    qvec, lamqv = quant_vectors(qp, lam, b, qv, lamv)
    rp = _np_planes(ref_pyr, bd, device)
    sp = _np_planes(src_pyr, bd, device)
    xs = const(np.asarray(xs, np.int64), device)
    ys = const(np.asarray(ys, np.int64), device)
    qv, lamqv = const(qvec, device), const(lamqv, device)
    h, w = sp[0].shape
    int_mvs, _ = fullpel_search_j(rp, sp, xs, ys, size)
    mvs = subpel_refine_j(rp[0], sp[0], xs, ys, size, int_mvs, bd=bd)
    srcs = _gather_curs(sp[0], xs, ys, bw, bh)[0].long()
    best = None
    for cand0 in (mvs, torch.zeros_like(mvs)):
        cand = _clamp_mvs_j(cand0, xs, ys, bw, bh, w, h)
        pred = dev.mc_block_batch_j(rp[0], xs, ys, cand, bw, bh, ss=0,
                                    bd=bd).long()
        qc, eo, rec, dist, rate = _full_loop_j(
            srcs, pred, torch.zeros(b, dtype=torch.int32, device=device),
            (0,), tx_size, size, qv, bd, 0,
            rdoq_lam_qv=lamqv if rdoq else None)
        mv_bits = (2 << md.RATE_Q) + 256 * (cand.abs().sum(dim=1) > 0)
        cur = [_rdcost_j(dist, lamqv, rate + mv_bits), cand, qc, eo, rec]
        if best is None:
            best = cur
            continue
        bt = cur[0] < best[0]
        best = [torch.where(bt.reshape((-1,) + (1,) * (o.dim() - 1)), o, p)
                for o, p in zip(cur, best)]
    pix = np.uint16 if bd > 8 else np.uint8
    return [o.cpu().numpy().astype(dt) for o, dt in
            zip(best, (np.int64, np.int64, np.int32, np.int32, pix))]


def chroma_multi_dev(refs_u, refs_v, src_u, src_v, xs, ys, mvs, ridx,
                     size, qp, bd=8, lam=0.0, rdoq=False, qv=None,
                     lamv=None, device="cuda"):
    """U+V single-ref chroma coding across the whole reference set (twin
    of the JAX ``chroma_multi_dev``): per plane the chosen reference
    ``ridx`` [B] of a stacked bank, MC at the given MVs and the full loop
    (plane type 1, DCT). ``size`` is the chroma block size; numpy planes
    and lane arrays. Returns (qc_u, eo_u, rec_u, qc_v, eo_v, rec_v):
    int32, int32, int64 per plane."""
    from svt_av1_tpu_torch.pipeline.encoder import check_device
    device = check_device(device)
    cw, ch = common.leaf_wh(size)
    tx_uv = common.tx_size_for_rect(cw, ch, 1)
    b = len(xs)
    qvec, lamqv = quant_vectors(qp, lam, b, qv, lamv)
    xs = const(np.asarray(xs, np.int64), device)
    ys = const(np.asarray(ys, np.int64), device)
    mvs = const(np.asarray(mvs, np.int64), device)
    ridx = const(np.asarray(ridx, np.int64), device)
    qv, lamqv = const(qvec, device), const(lamqv, device)
    outs = []
    for planes, srcp in ((refs_u, src_u), (refs_v, src_v)):
        bank = torch.stack(_np_planes(planes, bd, device))
        (srcp,) = _np_planes([srcp], bd, device)
        srcs = _gather_curs(srcp, xs, ys, cw, ch)[0].long()
        pred = dev.mc_block_batch_j(bank, xs, ys, mvs, cw, ch, ss=1, bd=bd,
                                    ref_idx=ridx).long()
        qc, eo, rec, _, _ = _full_loop_j(
            srcs, pred, torch.zeros(b, dtype=torch.int32, device=device),
            (0,), tx_uv, (cw, ch), qv, bd, 1,
            rdoq_lam_qv=lamqv if rdoq else None)
        outs += [qc.to(torch.int16).cpu().numpy().astype(np.int32),
                 eo.to(torch.int16).cpu().numpy().astype(np.int32),
                 rec.cpu().numpy().astype(np.int64)]
    return tuple(outs)


def flip_rd_dev(srcs, preds, size, qp, bd=8, lam=0.0, rdoq=False,
                qv=None, lamv=None, device="cuda"):
    """Full-loop distortion and rate of M intra candidate predictions per
    block (twin of the JAX ``flip_rd_dev``): srcs [B, h, w], preds
    [M, B, h, w] numpy. Returns (dist [M, B] int64, rate [M, B] int64,
    the rate narrowed through int32 as the JAX program narrows it)."""
    from svt_av1_tpu_torch.pipeline.encoder import check_device
    device = check_device(device)
    bw, bh = common.leaf_wh(size)
    tx_size = common.tx_size_for_rect(bw, bh, 0)
    m, b = preds.shape[0], srcs.shape[0]
    qvec, lamqv = quant_vectors(qp, lam, b, qv, lamv)
    s2 = const(np.broadcast_to(np.asarray(srcs, np.int64)[None],
                               (m, b, bh, bw)).reshape(m * b, bh, bw),
               device)
    p2 = const(np.asarray(preds, np.int64).reshape(m * b, bh, bw), device)
    qv2 = const(np.tile(qvec, m), device)
    lam2 = const(np.tile(lamqv, m), device)
    _, _, _, dist, rate = _full_loop_j(
        s2, p2, torch.zeros(m * b, dtype=torch.int32, device=device), (0,),
        tx_size, size, qv2, bd, 0, rdoq_lam_qv=lam2 if rdoq else None)
    return (dist.reshape(m, b).cpu().numpy().astype(np.int64),
            rate.reshape(m, b).to(torch.int32).cpu().numpy()
            .astype(np.int64))
