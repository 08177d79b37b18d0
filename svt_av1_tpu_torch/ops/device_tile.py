"""The intra-flip apply pass of inter frames on the torch device (the flip
part of the JAX package's ``svt_av1_tpu/ops/device_tile.py``).

Blocks that the flip decision turned intra are recoded wave by wave in
coding-order dependency waves, with true final edges: each wave reads the
recon that the earlier waves wrote, so the prediction edges are exactly
those a decoder sees. The JAX program runs the waves as one
``lax.fori_loop`` over bucket-padded lane arrays; here the loop over
waves is a plain Python loop over the real lanes, so no lane is padded,
no scatter needs a drop mode and no index repeats. Each class runs a
wave's lanes in one step: same-wave lanes are mutually edge-independent,
so the JAX package's re-chunking of waves into steps of at most 8 lanes
(which bounds its padded lane width) changes no integer and is not
carried over. Per lane the integer
math is that of ``inter._flip_apply_wave``: the luma full loop with the
chosen mode, then the chroma choice between that mode and CfL.

The JAX package's fused keyframe tile programs (the rest of that file)
are a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.ops.device import const, take2
from svt_av1_tpu_torch.pipeline import common


def _edges_j(recon, xs, ys, bw: int, bh: int, ha, hl, htr, hbl,
             bd: int, max_w, max_h):
    """Twin of intra_ops.prepare_edges_av1 for lanes at dynamic positions
    (offset-1 edge layout, index 0 = the corner). max_w/max_h: per-lane
    [B] pixel bounds (the tile's right/bottom edges: replication clamps
    there, spec 7.11.2). Returns (above1, left1) int32."""
    base = 1 << (bd - 1)
    hp, wp = recon.shape
    device = recon.device
    w_ = torch.clamp(max_w, max=wp)
    h_ = torch.clamp(max_h, max=hp)
    # above row
    lim = torch.minimum(w_ - 1, xs + torch.where(htr, 2 * bw, bw) - 1)
    cols = torch.minimum(xs[:, None] + torch.arange(bw + bh, device=device),
                         lim[:, None])
    rowy = (ys - 1).clamp(0, hp - 1)
    above_row = take2(recon, rowy[:, None], cols)
    colx = (xs - 1).clamp(0, wp - 1)
    left_px = recon[ys.clamp(0, hp - 1), colx]
    above_tail = torch.where(ha[:, None], above_row,
                             torch.where(hl[:, None], left_px[:, None],
                                         base - 1))
    # left column
    lim2 = torch.minimum(h_ - 1, ys + torch.where(hbl, 2 * bh, bh) - 1)
    rows = torch.minimum(ys[:, None] + torch.arange(bh + bw, device=device),
                         lim2[:, None])
    left_col = take2(recon, rows, colx[:, None])
    above_px = recon[rowy, xs.clamp(0, wp - 1)]
    left_tail = torch.where(hl[:, None], left_col,
                            torch.where(ha[:, None], above_px[:, None],
                                        base + 1))
    corner = torch.where(ha & hl, recon[rowy, colx],
                         torch.where(ha, above_px,
                                     torch.where(hl, left_px, base)))
    above1 = torch.cat([corner[:, None], above_tail], dim=1)
    left1 = torch.cat([corner[:, None], left_tail], dim=1)
    return above1.to(torch.int32), left1.to(torch.int32)


def _narrow_out(out: dict) -> dict:
    """Narrow the per-lane outputs as the JAX programs do before their
    download: levels and eobs to int16 (the quantizer clamps levels to
    int16), alphas to int8."""
    out = dict(out)
    for k, v in out.items():
        if k.startswith(("qc_", "eob_")):
            out[k] = v.to(torch.int16)
        elif k.startswith("alpha_"):
            out[k] = v.to(torch.int8)
    return out


def _gather(plane, xs, ys, bw: int, bh: int):
    iy = ys[:, None, None] + torch.arange(bh, device=plane.device)[
        None, :, None]
    ix = xs[:, None, None] + torch.arange(bw, device=plane.device)[
        None, None, :]
    return take2(plane, iy, ix)


def _scatter(plane, xs, ys, blocks, bw: int, bh: int) -> None:
    """Write [B, bh, bw] blocks into ``plane`` in place (the lanes of one
    step are disjoint blocks, and every lane is real)."""
    iy = ys[:, None, None] + torch.arange(bh, device=plane.device)[
        None, :, None]
    ix = xs[:, None, None] + torch.arange(bw, device=plane.device)[
        None, None, :]
    plane[iy, ix] = blocks.to(plane.dtype)


def _flip_stage(shape: tuple, bd: int, rdoq: bool = False):
    """The step of one shape class: recode its lanes of one wave in place
    in the int32 recon planes; returns the lanes' outputs."""
    from svt_av1_tpu_torch.ops.device_md import (_full_loop_j, _rdcost_j,
                                                 cfl_fit_alpha_j,
                                                 cfl_predict_j,
                                                 luma_ac_420_j,
                                                 predict_any_j)
    from svt_av1_tpu_torch.pipeline import md as md_mod
    bw, bh = shape
    cw_, ch_ = bw >> 1, bh >> 1
    cfl_ok = bw <= 32 and bh <= 32
    tx_y = common.tx_size_for_rect(bw, bh, 0)
    tx_uv = common.tx_size_for_rect(cw_, ch_, 1)

    def select(modes, fm, pred_of, b, h, w, device):
        pred = torch.zeros((b, h, w), dtype=torch.int64, device=device)
        for m in modes:
            pred = torch.where((fm == m)[:, None, None], pred_of(m).long(),
                               pred)
        return pred

    def step(recon, src, lanes, modes: tuple):
        """recon/src: [y, u, v]; lanes: the class's lane tensors of this
        step; modes: the forced modes that occur among them."""
        xs, ys, ha, hl = lanes["xs"], lanes["ys"], lanes["ha"], lanes["hl"]
        htr, hbl, mwv, mhv = lanes["htr"], lanes["hbl"], lanes["mwv"], \
            lanes["mhv"]
        fm, qv, lamqv = lanes["fm"], lanes["qv"], lanes["lamqv"]
        b = xs.shape[0]
        device = xs.device
        rlq = lamqv if rdoq else None
        zeros_tt = torch.zeros(b, dtype=torch.int32, device=device)
        # --- luma (forced mode per lane) ---
        a1, l1 = _edges_j(recon[0], xs, ys, bw, bh, ha, hl, htr, hbl, bd,
                          mwv, mhv)
        srcs = _gather(src[0], xs, ys, bw, bh).long()
        pred = select(modes, fm, lambda m: predict_any_j(
            m, 0, a1, l1, bw, bh, ha, hl, bd), b, bh, bw, device)
        qcy, eoy, recy, _, _ = _full_loop_j(
            srcs, pred, zeros_tt, (0,), tx_y, (bw, bh), qv, bd, 0,
            rdoq_lam_qv=rlq)
        _scatter(recon[0], xs, ys, recy, bw, bh)
        # --- chroma: per-lane {luma mode, CfL} joint pick ---
        cxs, cys = xs >> 1, ys >> 1
        ac = None
        if cfl_ok:
            ac = luma_ac_420_j(_gather(recon[0], xs, ys, bw, bh).long())
        tt_lut = np.zeros(16, np.int32)
        for m in modes:
            tt_lut[m] = common.chroma_tx_type(m, tx_uv, False)
        tt_set = tuple(sorted({int(tt_lut[m]) for m in modes}))
        tts = const(tt_lut, device)[fm.long()]
        res = {}
        for plane in (1, 2):
            a1c, l1c = _edges_j(recon[plane], cxs, cys, cw_, ch_, ha, hl,
                                htr, hbl, bd, mwv >> 1, mhv >> 1)
            srcs_c = _gather(src[plane], cxs, cys, cw_, ch_).long()
            predc = select(modes, fm, lambda m: predict_any_j(
                m, 0, a1c, l1c, cw_, ch_, ha, hl, bd), b, ch_, cw_, device)
            qcp, eop, recp, dist, rate = _full_loop_j(
                srcs_c, predc, tts, tt_set, tx_uv, (cw_, ch_), qv, bd, 1,
                rdoq_lam_qv=rlq)
            cost_m = _rdcost_j(dist, lamqv, rate)
            cfl = None
            if cfl_ok:
                dc = dev.predict_modes((0,), a1c[:, 1:], l1c[:, 1:],
                                       a1c[:, 0], ha, hl, cw_, ch_, bd)[0]
                alpha = cfl_fit_alpha_j(ac, srcs_c, dc)
                cpred = cfl_predict_j(dc, ac, alpha, bd).long()
                qc2, eo2, rec2, dist2, rate2 = _full_loop_j(
                    srcs_c, cpred, zeros_tt, (0,), tx_uv, (cw_, ch_), qv,
                    bd, 1, rdoq_lam_qv=rlq)
                cfl = (qc2, eo2, rec2, _rdcost_j(
                    dist2, lamqv, rate2 + (4 << md_mod.RATE_Q)), alpha)
            res[plane] = ((qcp, eop, recp, cost_m), cfl)
        if cfl_ok:
            use = (res[1][1][3] + res[2][1][3] < res[1][0][3] + res[2][0][3]) \
                & ~((res[1][1][4] == 0) & (res[2][1][4] == 0))
        else:
            use = torch.zeros(b, dtype=torch.bool, device=device)
        out = {"qc_y": qcy, "eob_y": eoy, "use_cfl": use}
        for plane, p in ((1, "u"), (2, "v")):
            (qcp, eop, recp, _), cfl = res[plane]
            if cfl_ok:
                qc2, eo2, rec2, _, alpha = cfl
                qsel = torch.where(use[:, None, None], qc2, qcp)
                esel = torch.where(use, eo2, eop)
                rsel = torch.where(use[:, None, None], rec2, recp)
                asel = torch.where(use, alpha, 0)
            else:
                qsel, esel, rsel = qcp, eop, recp
                asel = torch.zeros(b, dtype=torch.int64, device=device)
            _scatter(recon[plane], cxs, cys, rsel, cw_, ch_)
            out[f"qc_{p}"], out[f"eob_{p}"], out[f"alpha_{p}"] = \
                qsel, esel, asel
        return out

    return step


def make_flip_body(class_spec: tuple, n_waves: int, bd: int,
                   rdoq: bool = False):
    """class_spec: ((bw, bh), ...) in the order the classes run inside a
    wave. The returned program takes the current inter recon planes (the
    pass repairs poorly-predicted blocks in place), the source planes and
    per class its lanes (tensors in wave order), the [start, end) lane
    range of every wave and the modes that occur in each; it returns the
    recon planes (pixel dtype) and per class the narrowed outputs of its
    lanes in lane order."""
    stages = [_flip_stage(sh, bd, rdoq=rdoq) for sh in class_spec]

    def program(ry, ru, rv, src, lanes, ranges, modes):
        recon = [p.to(torch.int32) for p in (ry, ru, rv)]
        outs = [[] for _ in stages]
        for w in range(n_waves):
            for ci, step in enumerate(stages):
                s, e = ranges[ci][w]
                if e > s:
                    outs[ci].append(step(
                        recon, src, {k: v[s:e] for k, v in lanes[ci].items()},
                        modes[ci][w]))
        narrow = [_narrow_out({k: torch.cat([o[k] for o in per])
                               for k in per[0]}) for per in outs]
        return [p.to(ry.dtype) for p in recon], narrow

    return program


def host_recode_raises() -> None:
    """Where the JAX package decides and recodes flips on the host (RDOQ
    at qindex 0, which it gates per qindex there) the port raises."""
    raise NotImplementedError(
        "the host recode of intra flips at qindex 0 with RDOQ: not ported "
        "yet (comes with the non-fused inter slice; see ROADMAP.md Queue 1)")


def flip_apply_fused(enc, waves) -> None:
    """The whole intra-flip apply pass (inter.InterFrameEncoder's waves of
    accepted flips) on the recon's device. ``waves``: output of
    enc._flip_waves — lists of (r, c, size, li, mode) in coding order.
    Raises NotImplementedError where the JAX package takes its host
    recode (RDOQ at qindex 0)."""
    from svt_av1_tpu_torch.pipeline import avail, md
    from svt_av1_tpu_torch.pipeline.common import PendingQC
    cfg = enc.cfg
    if not waves:
        return
    qcache = {}

    def lane_q(r, c):
        qidx = None if enc.qmap is None \
            else int(enc.qmap[r // 16, c // 16])
        ent = qcache.get(qidx)
        if ent is None:
            qp, lam = enc._qp_for(qidx)
            ent = (int(qp.qindex), md.lam_to_q(lam))
            qcache[qidx] = ent
        return ent

    classes = {}
    for w, wave in enumerate(waves):
        for (r, c, size, li, m) in wave:
            qi, lamq = lane_q(r, c)
            if cfg.enable_rdoq and qi == 0:
                host_recode_raises()
            classes.setdefault(common.leaf_wh(size), []) \
                .append((w, r, c, li, m, qi, lamq))
    order = sorted(classes)
    device = enc.recon[0].device
    lanes, ranges, modes = [], [], []
    for sh in order:
        ent = classes[sh]
        w4, h4 = sh[0] >> 2, sh[1] >> 2
        wv = np.array([e[0] for e in ent])
        rs = np.array([e[1] for e in ent])
        cs = np.array([e[2] for e in ent])
        fm = np.array([e[4] for e in ent])
        # availability + edge replication clip at tile bounds (spec
        # 7.10.2 / 7.11.2)
        lr_, lc_, trs, tcs = enc._tile_local_coords(rs, cs)
        vab = avail.leaf_vert_ab_flags(enc.leaf_sizes, rs, cs, w4, h4,
                                       enc.mi_rows, enc.mi_cols)
        host = dict(
            xs=cs * 4, ys=rs * 4,
            ha=lr_ > 0, hl=lc_ > 0,
            htr=avail.has_top_right_wh_vec(lr_, lc_, w4, h4, tcs,
                                           vert_ab=vab),
            hbl=avail.has_bottom_left_wh_vec(lr_, lc_, w4, h4, trs,
                                             vert_ab=vab),
            mwv=(cs - lc_ + tcs) * 4, mhv=(rs - lr_ + trs) * 4, fm=fm,
            qv=np.array([e[5] for e in ent], np.int32),
            lamqv=np.array([e[6] for e in ent], np.int64))
        lanes.append({k: const(np.asarray(
            v, bool if k in ("ha", "hl", "htr", "hbl")
            else (np.int32 if k == "qv" else np.int64)), device)
            for k, v in host.items()})
        bounds = np.searchsorted(wv, np.arange(len(waves) + 1))
        ranges.append([(int(bounds[w]), int(bounds[w + 1]))
                       for w in range(len(waves))])
        modes.append([tuple(sorted(set(fm[bounds[w]:bounds[w + 1]]
                                       .tolist())))
                      for w in range(len(waves))])
    prog = make_flip_body(tuple(order), len(waves), cfg.bit_depth,
                          bool(cfg.enable_rdoq))
    recon, outs = prog(enc.recon[0], enc.recon[1], enc.recon[2],
                       enc.src, lanes, ranges, modes)
    enc.recon = recon
    # the coefficient tensors are resolved on the entropy thread
    # (PendingQC starts their copies now); the small outputs come back here
    for ci, sh in enumerate(order):
        o = outs[ci]
        pends = [PendingQC(o[f"qc_{p}"]) for p in ("y", "u", "v")]
        small = {k: v.cpu().numpy() for k, v in o.items()
                 if not k.startswith("qc_")}
        for j, (w, r, c, li, m, qi, lamq) in enumerate(classes[sh]):
            enc.block_is_inter[li] = False
            enc.intra_mode[li] = m
            for p in range(3):
                enc.qcoeff[p][li] = (pends[p], j)
            enc.eobs[0, li] = small["eob_y"][j]
            enc.eobs[1, li] = small["eob_u"][j]
            enc.eobs[2, li] = small["eob_v"][j]
            enc.intra_uv_cfl[li] = small["use_cfl"][j]
            enc.intra_alpha_u[li] = small["alpha_u"][j]
            enc.intra_alpha_v[li] = small["alpha_v"][j]
