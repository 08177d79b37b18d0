"""Inter frame encoder of the port (P and hierarchical-B frames).

The port of the JAX package's ``pipeline/inter.py`` on its device path.
Inter prediction has no in-frame dependency, so ME, mode decision,
transform and reconstruction run batched over all blocks of one shape at
once: one shape-group step per block shape on the torch device
(``ops/device_inter.shape_group``), issued for every group before any
result is read back. Where the config enables them (presets 0 and 1), the
interpolation-filter search and the inter tx-type sweep run inside that
step, between the luma decision and chroma, which then takes the blocks'
filters and inherited tx types: the JAX package's non-fused path, whose
host stages stay on the device here. Under adaptive quantization every
lane carries its superblock's qindex and lambda through the group and
the flip pass. The intra-flip pass then re-decides
poorly predicted blocks as intra (a batched decision on the device, then
an exact recode in dependency waves, ``ops/device_tile.flip_apply_fused``;
at qindex 0 with RDOQ too, where the trim leaves qindex-0 lanes untouched
as the JAX host recode does), and the deblocking filter, then CDEF and
loop restoration where the config enables them (``pipeline/postfilter.py``),
run on the device-resident recon. Only the syntax pass is sequential host
work: it walks coding order, builds the ref-MV stack from coded state
(``pipeline.mvp``), canonicalizes each block's MV into
NEAREST/NEAR/GLOBAL/NEWMV and emits bits.

Reference equivalents: MotionEstimationKernel (EbMotionEstimationProcess.c),
EncDec inter path (EbCodingLoop.c), write_modes_b inter syntax
(EbEntropyCoding.c:1724ff).
"""

from __future__ import annotations

import numpy as np
import torch

from svt_av1_tpu_torch.bitstream import obu
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.entropy import coeff as coeff_syntax
from svt_av1_tpu_torch.entropy import delta as delta_syntax
from svt_av1_tpu_torch.entropy import inter_modes
from svt_av1_tpu_torch.entropy import modes as mode_syntax
from svt_av1_tpu_torch.entropy import mv as mv_syntax
from svt_av1_tpu_torch.entropy.cdf import FrameContext
from svt_av1_tpu_torch.entropy.ctx import TileContexts
from svt_av1_tpu_torch.ops import device as dev_ops
from svt_av1_tpu_torch.ops import device_inter as di
from svt_av1_tpu_torch.ops import mc
from svt_av1_tpu_torch.ops import quant as quant_ops
from svt_av1_tpu_torch.pipeline import (analysis, common, md, mvp,
                                        postfilter, rd)
from svt_av1_tpu_torch.pipeline.intra import make_symbol_writer
from svt_av1_tpu_torch.pipeline.mvp import (GLOBALMV, LAST_FRAME, NEARESTMV,
                                            NEARMV, NEWMV)
from svt_av1_tpu_torch.utils.blocks import DC_PRED, DCT_DCT, PARTITION_SPLIT
from svt_av1_tpu_torch.utils.trace import span

resolve_qc = common.resolve_qc


def clamp_mvs_batch(mvs, xs, ys, bw, bh, plane_w, plane_h, ss: int = 0):
    """Vectorized mc.clamp_mv_for_padding over a batch (1/8-pel units)."""
    margin = (mc.REF_PAD - 5) << (2 + ss)
    xa = np.asarray(xs, dtype=np.int64)
    ya = np.asarray(ys, dtype=np.int64)
    r = np.clip(mvs[:, 0], -(ya << (2 + ss)) - margin,
                ((plane_h - ya - bh) << (2 + ss)) + margin)
    c = np.clip(mvs[:, 1], -(xa << (2 + ss)) - margin,
                ((plane_w - xa - bw) << (2 + ss)) + margin)
    return np.stack([r, c], axis=1)


class InterFrameEncoder:
    DELTA_Q_RES = 2

    def __init__(self, cfg: EncoderConfig, seq: obu.SequenceHeader,
                 ref_cache=None, film_grain=None):
        """ref_cache: the stream's {id(plane): (plane, padded, pyramid)}
        store of prepared references (see _padded_ref); the Encoder
        passes its own, so a slot is prepared once per stream.
        film_grain: the stream's film grain parameters (see
        common.frame_grain)."""
        self.cfg = cfg
        self.seq = seq
        self.film_grain = common.frame_grain(cfg, seq, film_grain)
        self._ref_cache = {} if ref_cache is None else ref_cache
        self.device = torch.device(cfg.device)
        self.mi_cols = seq.mi_cols
        self.mi_rows = seq.mi_rows
        self.qp = quant_ops.make_quant_params(cfg.base_q_idx,
                                              bit_depth=cfg.bit_depth)
        # tile grid (uniform spacing, spec 5.9.15): tile columns cut the
        # intra-flip wavefront critical path and parallelize host entropy
        self.tile_log2 = obu.clamp_tile_log2(seq, cfg.tile_cols_log2,
                                             cfg.tile_rows_log2)
        self.tile_rects_v = common.tile_rects(
            seq.sb_cols, seq.sb_rows, self.mi_cols, self.mi_rows,
            *self.tile_log2)
        self.lam = rd.rd_lambda(cfg.base_q_idx, cfg.bit_depth)
        # set by the Encoder: the previous coded source luma (the
        # variance AQ's temporal hint) and this frame's TPL offset map
        self.aq_prev_luma = None
        self.tpl_qmap = None
        # set by the Encoder: a drop-in for device_inter.shape_group_issue
        # (parallel/tiles.make_sharded_shape_group_issue), or None
        self.shape_group_issue = None

    def _padded_ref(self, planes, valid_hw):
        """Padded reference planes + HME pyramid on the device, cached per
        recon object: a slot's recon is padded and decimated once, not
        once per frame that reads it. Host planes (a key frame's recon)
        are uploaded first; device slots never leave the card.
        ``valid_hw``: (vh, vw) decoder-visible luma core when planes
        carry bucket-pad bands."""
        cache = self._ref_cache
        ent = cache.get(id(planes[0]))
        if ent is not None and ent[0] is planes[0]:
            return ent[1], ent[2]
        pdt = dev_ops.pix_dtype(self.cfg.bit_depth)
        planes_t = [p if isinstance(p, torch.Tensor)
                    else dev_ops.const(np.asarray(p).astype(np.int32),
                                       self.device).to(pdt)
                    for p in planes]
        padded, pyr = di.ref_prep_dev(planes_t, valid_hw=valid_hw)
        if len(cache) >= 24:
            for k in list(cache)[:8]:
                del cache[k]
        cache[id(planes[0])] = (planes[0], padded, pyr)
        return padded, pyr

    def _tile_local_coords(self, rs, cs):
        """Per-block tile-local (r, c) + tile mi dims for availability
        clipping (spec 7.10.2: out-of-tile neighbors are unavailable).
        One SB-indexed lookup table per frame; tiles are SB-aligned so
        position-within-SB terms are offset-invariant."""
        lut = getattr(self, "_tile_lut", None)
        if lut is None:
            sbr_n, sbc_n = self.seq.sb_rows, self.seq.sb_cols
            t = [np.zeros((sbr_n, sbc_n), np.int64) for _ in range(4)]
            for (mi_r0, mi_c0, mi_rs, mi_cs, sb_rs, sb_cs) \
                    in self.tile_rects_v:
                sl = (slice(mi_r0 // 16, mi_r0 // 16 + sb_rs),
                      slice(mi_c0 // 16, mi_c0 // 16 + sb_cs))
                t[0][sl], t[1][sl] = mi_r0, mi_c0
                t[2][sl], t[3][sl] = mi_rs, mi_cs
            lut = self._tile_lut = t
        rs = np.asarray(rs, dtype=np.int64)
        cs = np.asarray(cs, dtype=np.int64)
        sr, sc = rs // 16, cs // 16
        return (rs - lut[0][sr, sc], cs - lut[1][sr, sc],
                lut[2][sr, sc], lut[3][sr, sc])

    def encode(self, y, u, v, ref_planes, alt_planes=None,
               refresh_frame_flags: int = 0x01,
               ref_frame_idx=(0,) * 7, show_frame: bool = True,
               extra_refs=None, init_entropy=None, prev_gm=None):
        """``encode_compute`` then ``encode_syntax``; returns (tu,
        recon(padded, on the device))."""
        self.encode_compute(y, u, v, ref_planes, alt_planes,
                            refresh_frame_flags, ref_frame_idx,
                            show_frame, extra_refs)
        tu = self.encode_syntax(init_entropy, prev_gm)
        return tu, self.recon

    def encode_compute(self, y, u, v, ref_planes, alt_planes=None,
                       refresh_frame_flags: int = 0x01,
                       ref_frame_idx=(0,) * 7, show_frame: bool = True,
                       extra_refs=None):
        """Decision + reconstruction + in-loop filters on the device; leaves
        the syntax inputs on self for ``encode_syntax``. ref_planes: past
        reference recon [Y, U, V] (padded dims, host or device);
        alt_planes: optional future reference; extra_refs: additional
        named references {ref_id: planes}. self.recon (device) is final
        after this."""
        cfg = self.cfg
        device = self.device
        pdt = dev_ops.pix_dtype(cfg.bit_depth)
        src = common.pad_frame_planes(y, u, v, dtype=np.int32)
        self.src = [dev_ops.const(p, device).to(pdt) for p in src]
        self.recon = [torch.zeros(p.shape, dtype=pdt, device=device)
                      for p in src]
        from svt_av1_tpu_torch.entropy.inter_modes import (ALTREF_FRAME,
                                                           BWDREF_FRAME)
        self.refs = {}
        self.ref_pyrs = {}
        vhw = (self.seq.sb_rows * 64, self.seq.sb_cols * 64)
        self.refs[LAST_FRAME], self.ref_pyrs[LAST_FRAME] = \
            self._padded_ref(ref_planes, vhw)
        if alt_planes is not None:
            self.refs[ALTREF_FRAME], self.ref_pyrs[ALTREF_FRAME] = \
                self._padded_ref(alt_planes, vhw)
        for rid, planes in (extra_refs or {}).items():
            if rid not in self.refs and planes is not None:
                self.refs[rid], self.ref_pyrs[rid] = \
                    self._padded_ref(planes, vhw)
        self.fwd_refs = sorted(r for r in self.refs if r < BWDREF_FRAME)
        self.bwd_refs = sorted(r for r in self.refs if r >= BWDREF_FRAME)
        self.src_pyr = di.src_pyramid_dev(self.src[0])

        if cfg.fixed_partition_size is None:
            with span("inter_partition_dp"):
                self.leaf_sizes = rd.choose_partition_inter(
                    cfg, self.mi_cols, self.mi_rows,
                    ref_pyr=self.ref_pyrs[LAST_FRAME], src_pyr=self.src_pyr)
        else:
            self.leaf_sizes = common.fixed_leaf_sizes(
                self.mi_rows, self.mi_cols, self.seq.sb_rows,
                self.seq.sb_cols, cfg.fixed_partition_size)
        leaves = common.leaves_in_coding_order(
            self.leaf_sizes, self.mi_rows, self.mi_cols, self.seq.sb_rows,
            self.seq.sb_cols)
        n = len(leaves)
        self.leaf_index = {(r, c): i for i, (r, c, s) in enumerate(leaves)}
        self.mvs = np.zeros((n, 2), dtype=np.int64)
        self.block_ref = np.full(n, LAST_FRAME, dtype=np.int32)
        self.qcoeff = [[None] * n, [None] * n, [None] * n]
        self.eobs = np.zeros((3, n), dtype=np.int32)
        self.block_is_inter = np.ones(n, dtype=bool)
        self.intra_mode = np.zeros(n, dtype=np.int32)
        self.y_tx_type = np.zeros(n, dtype=np.int32)
        self.inter_cost = np.zeros(n, dtype=np.int64)
        self.block_comp = np.zeros(n, dtype=bool)
        self.mvs1 = np.zeros((n, 2), dtype=np.int64)
        self.intra_uv_cfl = np.zeros(n, dtype=bool)
        self.intra_alpha_u = np.zeros(n, dtype=np.int64)
        self.intra_alpha_v = np.zeros(n, dtype=np.int64)
        self.comp_ref0 = np.full(n, LAST_FRAME, dtype=np.int32)
        self.comp_ref1 = np.zeros(n, dtype=np.int32)
        self.interp_f = np.zeros(n, dtype=np.int32)
        self.reference_select = bool(self.fwd_refs and self.bwd_refs)
        self.qmap = None
        if cfg.adaptive_quantization:
            tq = self.tpl_qmap
            if cfg.adaptive_quantization == 2 and tq is not None:
                # MV-propagated TPL offsets from the GOP lookahead window,
                # anchored on this frame's own base qindex; an all-zero map
                # codes no deltas at all
                if np.any(tq):
                    self.qmap = np.clip(cfg.base_q_idx + tq,
                                        1, 255).astype(np.int32)
            else:
                classes = analysis.content_classes(
                    src[0], src[1], src[2], self.seq.sb_rows,
                    self.seq.sb_cols, cfg.bit_depth)
                self.qmap = analysis.variance_qmap(
                    src[0], self.seq.sb_rows, self.seq.sb_cols,
                    cfg.base_q_idx, self.DELTA_Q_RES,
                    prev_y=self.aq_prev_luma,
                    classes=classes)

        leaves = [(r, c, common.leaf_wh(v)) for r, c, v in leaves]
        larr = np.array([(r, c, wh[0], wh[1]) for r, c, wh in leaves],
                        dtype=np.int64)
        shape_key = larr[:, 2] * 1000 + larr[:, 3]
        # one shape-group step per block shape (ME + RD + compound, the
        # searches the config enables, both chroma planes), every group
        # issued before any result is read back; under adaptive
        # quantization each lane carries its SB's qindex
        batches = []
        for sk in np.unique(shape_key):
            sids = np.nonzero(shape_key == sk)[0]
            qvec = None if self.qmap is None else \
                self.qmap[larr[sids, 0] // 16, larr[sids, 1] // 16]
            batches.append((larr[sids], sids,
                            (int(sk) // 1000, int(sk) % 1000), qvec))
        with span("inter_blocks"):
            self._encode_blocks(batches)
        if cfg.intra_in_inter:
            with span("intra_flip"):
                self._intra_flip_pass(leaves)
        self._estimate_gm()

        lf_levels = (0, 0, 0, 0)
        if cfg.enable_dlf:
            with span("dlf"):
                lf_levels = dev_ops.dlf_search_apply_dev(
                    self.recon, self.src, self.leaf_sizes, self.mi_rows,
                    self.mi_cols, cfg.base_q_idx, cfg.bit_depth,
                    device=device)
        self.cdef_idx_map, self._cdef_kw, self.lr_rinfos, self._lr_kw = \
            postfilter.run_postfilters(
                cfg, self.recon, self.src,
                [(self.leaf_sizes, self.leaf_index, self.eobs, 0, 0)],
                self.mi_rows, self.mi_cols, self.lam)
        self._lf_levels = lf_levels
        self._show_frame = show_frame
        self._refresh_frame_flags = refresh_frame_flags
        self._ref_frame_idx = tuple(ref_frame_idx)
        return self.recon

    def encode_syntax(self, init_entropy=None, prev_gm=None) -> bytes:
        """Entropy coding + OBU assembly for the computed frame. Pure
        host work over state left by ``encode_compute`` — safe to run on
        a worker thread while the next frame's compute proceeds."""
        cfg = self.cfg
        carry = (not cfg.error_resilient) and init_entropy is not None
        self.init_entropy = init_entropy if carry else None
        # frame-level MVP state: each tile codes through a clipped view
        # (spatial scans stop at tile bounds, writes stitch into the
        # frame arrays); TMVP projections are shared slices
        fstate = mvp.MvpState(self.mi_rows, self.mi_cols)
        tc_ = getattr(self, "tmvp_ctx", None)
        if tc_ is not None and tc_["use"]:
            fstate.tpl = tc_["tpl"]
            fstate.rel_dist = tc_["rel_dist"]
            fstate.sign_bias = tc_["sign_bias"]
        self.frame_mvp_state = fstate
        frame_dims = (self.mi_rows, self.mi_cols)
        frame_leaves = self.leaf_sizes
        frame_index = self.leaf_index
        payloads = []
        with span("entropy"):
            for ti, rect in enumerate(self.tile_rects_v):
                payloads.append(self._syntax_pass(rect, fstate,
                                                  frame_leaves, frame_index))
                if ti == 0:
                    # context_update_tile_id = 0 (spec 6.8.2): tile 0's
                    # frame-end adapted state is what decoders save
                    tile0_entropy = (self.fc, self.nmv)
        self.mi_rows, self.mi_cols = frame_dims
        self.leaf_sizes, self.leaf_index = frame_leaves, frame_index
        self.fc, self.nmv = tile0_entropy
        gm_tuple = tuple(self.gm_mv.get(ref, (0, 0))
                         for ref in range(1, 8))
        no_end_update = cfg.disable_cdf_update or cfg.error_resilient
        tc = getattr(self, "tmvp_ctx", None) or {}
        fh = obu.FrameHeader(frame_type=obu.INTER_FRAME,
                             gm_trans=gm_tuple,
                             order_hint=tc.get("order_hint", 0),
                             use_ref_frame_mvs=tc.get("use", False),
                             ref_order_hints=tc.get("ref_order_hints",
                                                    (0,) * 8),
                             error_resilient=cfg.error_resilient,
                             primary_ref_frame=(0 if carry
                                                else obu.PRIMARY_REF_NONE),
                             prev_gm_trans=(prev_gm if carry and prev_gm
                                            else ((0, 0),) * 7),
                             disable_frame_end_update_cdf=no_end_update,
                             reference_select=self.reference_select,
                             delta_q_present=(self.qmap is not None),
                             interp_filter_switchable=(
                                 cfg.enable_interp_filter_search),
                             delta_q_res=self.DELTA_Q_RES,
                             film_grain=self.film_grain,
                             base_q_idx=cfg.base_q_idx,
                             disable_cdf_update=cfg.disable_cdf_update,
                             loop_filter_levels=self._lf_levels,
                             show_frame=self._show_frame,
                             refresh_frame_flags=self._refresh_frame_flags,
                             ref_frame_idx=self._ref_frame_idx,
                             tile_cols_log2=self.tile_log2[0],
                             tile_rows_log2=self.tile_log2[1],
                             **self._cdef_kw, **self._lr_kw)
        # the state a decoder saves into this frame's refresh slots
        # (spec: frame-end adapted CDFs unless end-update is disabled,
        # in which case the frame's starting state)
        if no_end_update:
            self.final_entropy = (
                (init_entropy[0].copy(), init_entropy[1].copy())
                if carry else (FrameContext(cfg.base_q_idx),
                               mv_syntax.NmvContext()))
        else:
            self.final_entropy = (self.fc, self.nmv)
        return (obu.temporal_delimiter_obu()
                + obu.write_frame_obu(self.seq, fh, payloads))

    def _qp_for(self, qidx):
        if qidx is None:
            return self.qp, self.lam
        if not hasattr(self, "_qp_cache"):
            self._qp_cache = {}
        if qidx not in self._qp_cache:
            self._qp_cache[qidx] = (
                quant_ops.make_quant_params(qidx,
                                            bit_depth=self.cfg.bit_depth),
                rd.rd_lambda(qidx, self.cfg.bit_depth))
        return self._qp_cache[qidx]

    def _leaf_vert_a(self, mi_row: int, mi_col: int, s4: int,
                     h4: int) -> bool:
        """Square member of a PARTITION_VERT_A parent (MVP top-right
        adjust, reference EbAdaptiveMotionVectorPrediction.c:882)."""
        from svt_av1_tpu_torch.pipeline import avail
        from svt_av1_tpu_torch.utils.blocks import PARTITION_VERT_A
        return avail.leaf_square_tshape(
            self.leaf_sizes, mi_row, mi_col, s4, h4, self.mi_rows,
            self.mi_cols) == PARTITION_VERT_A

    # --- the shape groups ----------------------------------------------------
    def _encode_blocks(self, batches) -> None:
        """One shape-group step per batch (ops/device_inter.shape_group:
        multi-ref ME + RD + compound, the interpolation-filter search and
        the inter tx-type sweep where the config enables them, both chroma
        planes) scatters the recon into the device frame planes. Every
        group is issued before any result is read back; the small decision
        outputs come back here, the coefficient tensors on the entropy
        thread (PendingQC, whose copies start now).

        batches: [(blocks larr, ids, (bw, bh), per-lane qindex or None)]."""
        cfg = self.cfg
        refs_order = sorted(self.refs)
        pos = {r: i for i, r in enumerate(refs_order)}
        fwd_pos = tuple(pos[r] for r in self.fwd_refs) \
            if self.reference_select else ()
        bwd_pos = tuple(pos[r] for r in self.bwd_refs) \
            if self.reference_select else ()
        issue = self.shape_group_issue or di.shape_group_issue
        issued = []
        with span("fused_issue", groups=len(batches)):
            for blocks, ids, wh, qvec in batches:
                lamv = None if qvec is None else \
                    rd.lane_lambdas(qvec, cfg.bit_depth)
                _, outs, _ = issue(
                    self.recon, [self.ref_pyrs[r] for r in refs_order],
                    [self.refs[r][1] for r in refs_order],
                    [self.refs[r][2] for r in refs_order],
                    self.src_pyr, self.src[1], self.src[2],
                    blocks[:, 1] * 4, blocks[:, 0] * 4, wh, self.qp,
                    self.lam, fwd_pos, bwd_pos, bd=cfg.bit_depth,
                    rdoq=cfg.enable_rdoq, qv=qvec, lamv=lamv,
                    filter_search=cfg.enable_interp_filter_search,
                    tx_search=cfg.enable_tx_type_search)
                issued.append((outs, ids))
        with span("fused_small_fetch"):
            small = [[outs[i].cpu().numpy()
                      for i in (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 13, 14)]
                     for outs, _ in issued]
        fwd_ids = np.asarray(self.fwd_refs or [LAST_FRAME])
        bwd_ids = np.asarray(self.bwd_refs or [0])
        for sm, (outs, ids) in zip(small, issued):
            (cost, mv0, mv1, pos_c, comp, fsel, bsel, eo, eou, eov, ftype,
             tts) = sm
            chosen_ref = np.asarray(refs_order)[pos_c.astype(np.int64)]
            self.mvs[ids] = mv0.astype(np.int64)
            self.block_ref[ids] = chosen_ref
            self.eobs[0, ids] = eo
            self.inter_cost[ids] = cost
            self.interp_f[ids] = ftype
            self.y_tx_type[ids] = tts
            if self.reference_select:
                self.mvs1[ids] = np.where(comp[:, None],
                                          mv1.astype(np.int64), 0)
                self.block_comp[ids] = comp
                self.comp_ref0[ids] = np.where(
                    comp, fwd_ids[fsel.astype(np.int64)], LAST_FRAME)
                self.comp_ref1[ids] = np.where(
                    comp, bwd_ids[bsel.astype(np.int64)], 0)
            self.eobs[1, ids] = eou
            self.eobs[2, ids] = eov
            for plane, oi in ((0, 7), (1, 9), (2, 11)):
                pend = common.PendingQC(outs[oi])
                for k, i in enumerate(ids):
                    self.qcoeff[plane][i] = (pend, k)

    # --- global motion estimation ---------------------------------------------
    def _estimate_gm(self) -> None:
        """Translation-only global motion from the decided MV field: the
        modal MV per reference becomes that ref's gm when it dominates
        (the role of SetGlobalMotionField's translation-only model,
        EbModeDecisionConfigurationProcess.c:317 — applied post-decision
        here: gm only changes *signaling*, blocks whose MV equals gm
        code as GLOBALMV)."""
        from collections import Counter
        self.gm_mv = {}
        for ref in self.refs:
            sel = [i for i in range(len(self.block_is_inter))
                   if self.block_is_inter[i] and not self.block_comp[i]
                   and int(self.block_ref[i]) == ref]
            if len(sel) < 4:
                continue
            counts = Counter((int(self.mvs[i, 0]), int(self.mvs[i, 1]))
                             for i in sel)
            mv, cnt = counts.most_common(1)[0]
            if mv == (0, 0) or cnt < max(4, len(sel) // 4):
                continue
            if abs(mv[0]) > 511 or abs(mv[1]) > 511 \
                    or mv[0] % 2 or mv[1] % 2:
                continue
            self.gm_mv[ref] = mv

    # --- intra-in-inter ---------------------------------------------------------
    def _intra_flip_pass(self, leaves) -> None:
        """Re-decide poorly-predicted blocks as intra (the reference's MD
        evaluates intra candidates inside inter frames). The decision
        pass evaluates every candidate block x mode in one batched full
        loop per shape against the inter reconstruction (open loop); the
        apply pass then recodes only the accepted flips in coding-order
        dependency waves with true final edges, so the reconstruction
        matches what the decoder reproduces bit for bit."""
        cfg = self.cfg
        costs = self.inter_cost
        thr = np.median(costs) * 1.2 + 1.0
        mode_bits = 6 << md.RATE_Q  # is_inter + y/uv mode signaling
        cand = []
        for (r, c, size) in leaves:
            li = self.leaf_index[(r, c)]
            _bw, _bh = common.leaf_wh(size)
            # evaluate when clearly worse than the frame's typical block
            # OR in absolute terms (~1 bit/px of estimated cost — a full
            # scene change makes every block bad, so a relative rule
            # alone never fires); 512 matches the q9 cost scale
            abs_thr = self.lam * (_bw * _bh) * 32.0
            if costs[li] <= thr and costs[li] <= abs_thr:
                continue
            cand.append((r, c, size, li))
        if not cand:
            return
        with span("flip_decision", n=len(cand)):
            flips = self._flip_decision_batch(cand, mode_bits)
        if not flips:
            return
        waves = self._flip_waves(flips)
        with span("flip_apply", n=len(flips), waves=len(waves)):
            from svt_av1_tpu_torch.ops import device_tile as dt
            dt.flip_apply_fused(self, waves)

    def _flip_waves(self, flips):
        """Dependency waves over accepted flips; tiles are layered
        independently (intra edges never cross a tile bound) and merged
        by wave index, so one step batches every tile's lanes — the
        critical path divides by the tile-column count."""
        if len(self.tile_rects_v) > 1:
            by_tile = {}
            for f in flips:
                lut = getattr(self, "_tile_lut", None)
                if lut is None:
                    self._tile_local_coords([0], [0])
                    lut = self._tile_lut
                key = (int(lut[0][f[0] // 16, f[1] // 16]),
                       int(lut[1][f[0] // 16, f[1] // 16]))
                by_tile.setdefault(key, []).append(f)
            merged = []
            for tf in by_tile.values():
                for w, wave in enumerate(self._flip_waves_one(tf)):
                    while len(merged) <= w:
                        merged.append([])
                    merged[w].extend(wave)
            return merged
        return self._flip_waves_one(flips)

    def _flip_waves_one(self, flips):
        """Dependency waves over accepted flips: a flip depends on any
        earlier-coding-order flip whose rect intersects its intra edge
        bands (above row incl. top-right reach 2*bw and the top-left
        pixel; left column incl. bottom-left reach 2*bh). Same-wave flips
        cannot see each other's pixels, so each wave recodes as one
        batch while exactly reproducing sequential coding-order edges."""
        cell = {}
        wave_of = []
        waves = []
        for k, (r, c, size, li, m) in enumerate(flips):
            bw, bh = common.leaf_wh(size)
            w4, h4 = bw >> 2, bh >> 2
            w = 0
            if r > 0:
                for cc in range(max(c - 1, 0),
                                min(c + 2 * w4 + 1, self.mi_cols)):
                    j = cell.get((r - 1, cc))
                    if j is not None:
                        w = max(w, wave_of[j] + 1)
            if c > 0:
                for rr in range(r, min(r + 2 * h4 + 1, self.mi_rows)):
                    j = cell.get((rr, c - 1))
                    if j is not None:
                        w = max(w, wave_of[j] + 1)
            wave_of.append(w)
            for rr in range(r, min(r + h4, self.mi_rows)):
                for cc in range(c, min(c + w4, self.mi_cols)):
                    cell[(rr, cc)] = k
            if w == len(waves):
                waves.append([])
            waves[w].append(flips[k])
        return waves

    def _flip_decision_batch(self, cand, mode_bits):
        """Batched open-loop intra-vs-inter decision over all candidate
        blocks, one device issue per block shape (sources, edges from the
        device recon and the candidate predictions all form there), read
        back after every group is issued: returns [(r, c, size, li,
        best_mode)] for accepted flips, in coding order. Under adaptive
        quantization each lane is priced at its SB's qindex and lambda."""
        from svt_av1_tpu_torch.pipeline import avail
        cfg = self.cfg
        cand_modes = tuple(cfg.intra_modes) or (0,)
        if cfg.enable_intra_edge_filter:
            # flip predictions bypass the intra edge filter process;
            # keep only process-exempt modes (non-directional + exact
            # V/H at delta 0) so signaled streams stay decoder-exact
            cand_modes = tuple(m for m in cand_modes
                               if m in (0, 1, 2, 9, 10, 11, 12)) or (0,)
        groups = {}
        for k, (r, c, size, li) in enumerate(cand):
            groups.setdefault(common.leaf_wh(size), []).append(k)
        flips = [None] * len(cand)
        pending = []
        for (bw, bh), ks in groups.items():
            rs = np.array([cand[k][0] for k in ks])
            cs = np.array([cand[k][1] for k in ks])
            xs, ys = cs * 4, rs * 4
            lr_, lc_, trs, tcs = self._tile_local_coords(rs, cs)
            ha = lr_ > 0
            hl = lc_ > 0
            vab = avail.leaf_vert_ab_flags(self.leaf_sizes, rs, cs,
                                           bw >> 2, bh >> 2,
                                           self.mi_rows, self.mi_cols)
            htr = avail.has_top_right_wh_vec(lr_, lc_, bw >> 2, bh >> 2,
                                             tcs, vert_ab=vab)
            hbl = avail.has_bottom_left_wh_vec(lr_, lc_, bw >> 2, bh >> 2,
                                               trs, vert_ab=vab)
            # tile right/bottom pixel bounds for edge replication (the
            # decision must price exactly the edges the recode uses)
            mxw = (cs - lc_ + tcs) * 4
            mxh = (rs - lr_ + trs) * 4
            qv = lams = None
            lamq = md.lam_to_q(self.lam)
            if self.qmap is not None:
                qv = self.qmap[rs // 16, cs // 16]
                lams = rd.lane_lambdas(qv, cfg.bit_depth)
                lamq = np.array([md.lam_to_q(lv) for lv in lams], np.int64)
            outs, _ = di.flip_decision_issue(
                self.src[0], self.recon[0], xs, ys, ha, hl, htr, hbl,
                cand_modes, (bw, bh), self.qp, self.lam, mxw, mxh,
                bd=cfg.bit_depth, rdoq=cfg.enable_rdoq, qv=qv, lamv=lams)
            pending.append((outs, len(ks), ks, lamq))
        for outs, b, ks, lamq in pending:
            vals = [o.cpu().numpy().astype(np.int64) for o in outs]
            best_cost = np.full(b, np.iinfo(np.int64).max)
            best_mode = np.zeros(b, dtype=np.int64)
            for mi, m in enumerate(cand_modes):
                cost_m = md.rdcost(vals[2 * mi], lamq,
                                   vals[2 * mi + 1] + mode_bits)
                bt = cost_m < best_cost
                best_cost = np.where(bt, cost_m, best_cost)
                best_mode = np.where(bt, m, best_mode)
            self._flip_accept(cand, ks, best_cost, best_mode, flips)
        return [f for f in flips if f is not None]

    def _flip_accept(self, cand, ks, best_cost, best_mode, flips):
        for j, k in enumerate(ks):
            li = cand[k][3]
            if best_cost[j] < self.inter_cost[li]:
                flips[k] = cand[k] + (int(best_mode[j]),)

    # --- sequential syntax pass (one call per tile) --------------------------
    def _syntax_pass(self, rect=None, fstate=None, frame_leaves=None,
                     frame_index=None) -> bytes:
        """Entropy-code one tile. Per spec 6.10.2/decode_tile, every
        tile starts from the frame's initial CDFs, fresh neighbor
        contexts and base_q_idx; block data is looked up through a
        tile-local leaf index into the frame-level decision arrays."""
        cfg = self.cfg
        if rect is None:                     # single-tile convenience
            rect = self.tile_rects_v[0]
            frame_leaves = self.leaf_sizes
            frame_index = self.leaf_index
        mi_r0, mi_c0, mi_rs, mi_cs, sb_rs, sb_cs = rect
        self.tile_mi_off = (mi_r0, mi_c0)
        self.mi_rows, self.mi_cols = mi_rs, mi_cs
        if len(self.tile_rects_v) == 1:
            self.leaf_sizes, self.leaf_index = frame_leaves, frame_index
        else:
            self.leaf_sizes = {}
            self.leaf_index = {}
            for (r, c), s in frame_leaves.items():
                if mi_r0 <= r < mi_r0 + mi_rs \
                        and mi_c0 <= c < mi_c0 + mi_cs:
                    self.leaf_sizes[(r - mi_r0, c - mi_c0)] = s
                    self.leaf_index[(r - mi_r0, c - mi_c0)] = \
                        frame_index[(r, c)]
        init = getattr(self, "init_entropy", None)
        if init is not None:
            self.fc = init[0].copy()
            self.nmv = init[1].copy()
        else:
            self.fc = FrameContext(cfg.base_q_idx)
            self.nmv = mv_syntax.NmvContext()
        self.w = make_symbol_writer(cfg.native_entropy,
                                    cfg.disable_cdf_update)
        self.ctxs = TileContexts(self.mi_cols, self.mi_rows)
        if fstate is None:
            fstate = self.frame_mvp_state
        self.mvp_state = fstate.tile_view(mi_r0, mi_c0, mi_rs, mi_cs)
        self._cdef_written = set()
        from svt_av1_tpu_torch.entropy import lr as lr_syntax
        self.lr_ref = [lr_syntax.LrRefState() for _ in range(3)]
        self.cur_qindex = cfg.base_q_idx
        for sb_y in range(0, sb_rs * 16, 16):
            for sb_x in range(0, sb_cs * 16, 16):
                self._read_deltas = self.qmap is not None
                lr_syntax.write_sb_units(self.w, self.fc, self.lr_rinfos,
                                         self.lr_ref, sb_y + mi_r0,
                                         sb_x + mi_c0,
                                         cfg.width, cfg.height)
                self._emit_partition(sb_y, sb_x, 64)
        return self.w.done()

    def _write_delta_q(self, mi_row, mi_col, size, skip) -> None:
        """Per-SB delta qindex (spec 5.11.5; QPM write side) at the SB's
        first block; a full-SB skip block codes nothing."""
        if self.qmap is None or not self._read_deltas:
            return
        self._read_deltas = False
        self.cur_qindex = delta_syntax.write_sb_delta(
            self.w, self.fc, self.cur_qindex,
            int(self.qmap[(mi_row + self.tile_mi_off[0]) // 16,
                          (mi_col + self.tile_mi_off[1]) // 16]),
            size, skip, self.DELTA_Q_RES)

    def _emit_partition(self, mi_row, mi_col, psize) -> None:
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        bsize = common.square_bsize(psize)
        hbs = psize >> 3
        half = psize >> 1
        partition, leaves = common.infer_partition(
            self.leaf_sizes, mi_row, mi_col, psize, self.mi_rows,
            self.mi_cols)
        mode_syntax.write_partition(self.w, self.fc, self.ctxs, partition,
                                    bsize, mi_row, mi_col,
                                    self.mi_cols, self.mi_rows)
        if partition == PARTITION_SPLIT:
            self._emit_partition(mi_row, mi_col, half)
            self._emit_partition(mi_row, mi_col + hbs, half)
            self._emit_partition(mi_row + hbs, mi_col, half)
            self._emit_partition(mi_row + hbs, mi_col + hbs, half)
            return
        # per-leaf emission + context update over each leaf's own extent
        # (reference EbEntropyCoding.c:4762 writes per coded block)
        for r, c, wh in leaves:
            self._emit_block(r, c, wh[0] if wh[0] == wh[1] else wh)
            self.ctxs.update_partition_ctx(r, c, common.rect_bsize(*wh),
                                           common.rect_bsize(*wh))

    def _emit_coeffs(self, li, mi_row, mi_col, bsize, bw, bh, skip,
                     tts, intra_dirs=None) -> None:
        """The three planes' coefficients of one block (or their skip
        context updates). tts: (luma, chroma) tx types; intra_dirs:
        (luma, chroma) modes of an intra block, None for inter."""
        cfg = self.cfg
        cw, ch = bw >> 1, bh >> 1
        x, y = mi_col * 4, mi_row * 4
        tx_y = common.tx_size_for_rect(bw, bh, 0)
        tx_uv = common.tx_size_for_rect(cw, ch, 1)
        plane_info = [(0, x, y, tx_y, bsize),
                      (1, x >> 1, y >> 1, tx_uv, common.rect_bsize(cw, ch)),
                      (2, x >> 1, y >> 1, tx_uv, common.rect_bsize(cw, ch))]
        for p, px, py, ts, pb in plane_info:
            x4, y4 = px >> 2, py >> 2
            if skip:
                self.ctxs.update_txb_ctx(p, x4, y4, ts, 0)
                continue
            skip_ctx, sign_ctx = self.ctxs.txb_ctx(p, pb, ts, x4, y4)
            kw = dict(is_inter=True) if intra_dirs is None else \
                dict(intra_dir=intra_dirs[int(p > 0)])
            cul = coeff_syntax.write_coeffs_txb(
                self.w, self.fc, resolve_qc(self.qcoeff[p][li]), ts,
                tts[int(p > 0)], plane_type=int(p > 0),
                txb_skip_ctx=skip_ctx, dc_sign_ctx=sign_ctx,
                base_qindex=cfg.base_q_idx, **kw)
            self.ctxs.update_txb_ctx(p, x4, y4, ts, cul)

    def _inter_tts(self, li, bw, bh):
        """(luma, chroma) tx types of an inter block: chroma inherits
        the luma type (spec 8.3.2), demoted to DCT when luma coded no
        coefficients or outside the chroma set."""
        tx_uv = common.tx_size_for_rect(bw >> 1, bh >> 1, 1)
        ltt = int(self.y_tx_type[li])
        ctt = common.chroma_tx_type_inter(
            ltt if self.eobs[0, li] > 0 else DCT_DCT, tx_uv, False)
        return ltt, ctt

    def _emit_block(self, mi_row, mi_col, size) -> None:
        cfg = self.cfg
        li = self.leaf_index[(mi_row, mi_col)]
        mv = (int(self.mvs[li, 0]), int(self.mvs[li, 1]))
        skip = int(self.eobs[:, li].sum() == 0)
        bw, bh = common.leaf_wh(size)
        bsize = common.rect_bsize(bw, bh)
        s4 = bw >> 2
        h4 = bh >> 2

        # inter_frame_mode_info order (spec 5.11.15): skip, is_inter, refs,
        # mode, drl, mv
        ref = int(self.block_ref[li])
        mode_syntax.write_skip(self.w, self.fc, self.ctxs, skip,
                               mi_row, mi_col)
        postfilter.write_cdef_idx(self.w, self.cdef_idx_map,
                                  self._cdef_written, mi_row, mi_col,
                                  self.tile_mi_off, skip)
        self._write_delta_q(mi_row, mi_col, size if bw == bh else 0, skip)
        if not self.block_is_inter[li]:
            self._emit_intra_block(mi_row, mi_col, size, li, skip)
            return
        inter_modes.write_is_inter(self.w, self.fc, self.mvp_state,
                                   mi_row, mi_col, 1)
        if self.block_comp[li]:
            self._emit_compound_tail(mi_row, mi_col, size, li, skip)
            return
        if self.reference_select:
            inter_modes.write_comp_inter(self.w, self.fc, self.mvp_state,
                                         mi_row, mi_col, 0)
        inter_modes.write_single_ref(self.w, self.fc, self.mvp_state,
                                     mi_row, mi_col, ref)
        gm_mv = self.gm_mv.get(ref, (0, 0))
        res = mvp.find_mv_stack(self.mvp_state, mi_row, mi_col, s4, ref,
                                gm_mv=gm_mv, h4=h4,
                                vert_a=self._leaf_vert_a(mi_row, mi_col,
                                                         s4, h4))
        if res.count >= 1 and mv == res.ref_list[0]:
            mode = NEARESTMV
        elif res.count >= 2 and mv == res.ref_list[1]:
            mode = NEARMV
        elif mv == gm_mv:
            mode = GLOBALMV
        else:
            mode = NEWMV
        inter_modes.write_inter_mode(self.w, self.fc, mode, res)
        inter_modes.write_drl_idx(self.w, self.fc, mode, 0, res)
        if mode == NEWMV:
            pred = res.stack[0][0] if res.count > 1 else res.ref_list[0]
            mv_syntax.write_mv(self.w, self.nmv, mv[0] - pred[0],
                               mv[1] - pred[1])
        f_coded = 0
        if cfg.enable_interp_filter_search:
            if inter_modes.needs_interp_filter(mode, bw, bh,
                                               gm_mv != (0, 0)):
                f_coded = int(self.interp_f[li])
                inter_modes.write_interp_filter(
                    self.w, self.fc, self.mvp_state, mi_row, mi_col,
                    ref, False, f_coded)
            # else the decoder assumes REGULAR: only reachable with a
            # zero gm MV, where phase-0 MC is filter-independent
        self.ctxs.set_mi(mi_row, mi_col, bsize, DC_PRED, skip)
        self.mvp_state.set_block(mi_row, mi_col, s4, ref, mv, mode,
                                 h4=h4)
        self.mvp_state.interp[mi_row:mi_row + h4,
                              mi_col:mi_col + s4] = f_coded
        self._emit_coeffs(li, mi_row, mi_col, bsize, bw, bh, skip,
                          self._inter_tts(li, bw, bh))

    def _emit_compound_tail(self, mi_row, mi_col, size, li, skip) -> None:
        """Compound (fwd, bwd) block syntax after skip/is_inter (spec
        5.11.25 compound branch). Modes used: NEAREST_NEARESTMV /
        NEAR_NEARMV / GLOBAL_GLOBALMV / NEAREST_NEWMV / NEW_NEARESTMV /
        NEW_NEWMV with DRL 0."""
        from svt_av1_tpu_torch.pipeline.mvp import (GLOBAL_GLOBALMV,
                                                    NEAR_NEARMV,
                                                    NEAREST_NEARESTMV,
                                                    NEAREST_NEWMV,
                                                    NEW_NEARESTMV, NEW_NEWMV)
        bw, bh = common.leaf_wh(size)
        bsize = common.rect_bsize(bw, bh)
        s4 = bw >> 2
        h4 = bh >> 2
        ref0 = int(self.comp_ref0[li])
        ref1 = int(self.comp_ref1[li])
        mv0 = (int(self.mvs[li, 0]), int(self.mvs[li, 1]))
        mv1 = (int(self.mvs1[li, 0]), int(self.mvs1[li, 1]))
        inter_modes.write_comp_inter(self.w, self.fc, self.mvp_state,
                                     mi_row, mi_col, 1)
        inter_modes.write_comp_refs(self.w, self.fc, self.mvp_state,
                                    mi_row, mi_col, ref0, ref1)
        gm_pair = (self.gm_mv.get(ref0, (0, 0)),
                   self.gm_mv.get(ref1, (0, 0)))
        res = mvp.find_mv_stack_comp(self.mvp_state, mi_row, mi_col, s4,
                                     ref0, ref1,
                                     gm=gm_pair, h4=h4,
                                     vert_a=self._leaf_vert_a(
                                         mi_row, mi_col, s4, h4))
        pair = (mv0, mv1)
        if res.count >= 1 and pair == res.ref_list[0]:
            mode = NEAREST_NEARESTMV
        elif res.count >= 2 and pair == res.ref_list[1]:
            mode = NEAR_NEARMV
        elif pair == gm_pair:
            mode = GLOBAL_GLOBALMV
        elif res.count >= 1 and mv0 == res.ref_list[0][0]:
            mode = NEAREST_NEWMV      # only the backward component is new
        elif res.count >= 1 and mv1 == res.ref_list[0][1]:
            mode = NEW_NEARESTMV
        else:
            mode = NEW_NEWMV
        inter_modes.write_inter_compound_mode(self.w, self.fc, mode, res)
        inter_modes.write_drl_idx(self.w, self.fc, mode, 0, res)
        pred = res.stack[0][0] if res.count > 1 else res.ref_list[0]
        if mode in (NEW_NEWMV, NEW_NEARESTMV):
            mv_syntax.write_mv(self.w, self.nmv, mv0[0] - pred[0][0],
                               mv0[1] - pred[0][1])
        if mode in (NEW_NEWMV, NEAREST_NEWMV):
            mv_syntax.write_mv(self.w, self.nmv, mv1[0] - pred[1][0],
                               mv1[1] - pred[1][1])
        f_coded = 0
        if self.cfg.enable_interp_filter_search:
            if inter_modes.needs_interp_filter(
                    mode, bw, bh, gm_pair[0] != (0, 0),
                    gm_pair[1] != (0, 0)):
                f_coded = int(self.interp_f[li])
                inter_modes.write_interp_filter(
                    self.w, self.fc, self.mvp_state, mi_row, mi_col,
                    ref0, True, f_coded)
        self.ctxs.set_mi(mi_row, mi_col, bsize, DC_PRED, skip)
        self.mvp_state.set_block(mi_row, mi_col, s4, ref0, mv0,
                                 mode, ref1=ref1, mv1=mv1, h4=h4)
        self.mvp_state.interp[mi_row:mi_row + h4,
                              mi_col:mi_col + s4] = f_coded
        self._emit_coeffs(li, mi_row, mi_col, bsize, bw, bh, skip,
                          self._inter_tts(li, bw, bh))

    def _emit_intra_block(self, mi_row, mi_col, size, li, skip) -> None:
        """Intra block syntax inside an inter frame (spec 5.11.19):
        is_inter=0, y mode via the size-group y_mode CDF, chroma mode,
        then intra-style coefficient coding."""
        from svt_av1_tpu_torch.ops import intra_dir
        m = int(self.intra_mode[li])
        bw, bh = common.leaf_wh(size)
        bsize = common.rect_bsize(bw, bh)
        inter_modes.write_is_inter(self.w, self.fc, self.mvp_state,
                                   mi_row, mi_col, 0)
        mode_syntax.write_intra_luma_mode_if(self.w, self.fc,
                                             max(bw, bh), m)
        if intra_dir.is_directional(m):
            mode_syntax.write_angle_delta(self.w, self.fc, m, 0)
        cfl_allowed = bw <= 32 and bh <= 32
        uv_mode = 13 if self.intra_uv_cfl[li] else m
        mode_syntax.write_intra_chroma_mode(self.w, self.fc, uv_mode, m,
                                            cfl_allowed)
        if uv_mode == 13:
            from svt_av1_tpu_torch.ops import cfl as cfl_ops
            cfl_ops.write_cfl_alphas(self.w, self.fc,
                                     int(self.intra_alpha_u[li]),
                                     int(self.intra_alpha_v[li]))
        elif intra_dir.is_directional(uv_mode):
            mode_syntax.write_angle_delta(self.w, self.fc, uv_mode, 0)
        self.ctxs.set_mi(mi_row, mi_col, bsize, m, skip)
        self.mvp_state.set_block(mi_row, mi_col, bw >> 2,
                                 mvp.INTRA_FRAME, (0, 0), 0, h4=bh >> 2)
        tx_uv = common.tx_size_for_rect(bw >> 1, bh >> 1, 1)
        tt_u = common.chroma_tx_type(uv_mode, tx_uv, False)
        self._emit_coeffs(li, mi_row, mi_col, bsize, bw, bh, skip,
                          (DCT_DCT, tt_u), intra_dirs=(m, uv_mode))
