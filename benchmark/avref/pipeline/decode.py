"""The decoder: reconstructs frames from the encoder's bitstreams.

A frozen copy of the port's ``pipeline/decode.py``, itself a spec-mirror
decoder that reads every syntax element from the bits. It shares the
context and geometry helpers with the encoder (copied beside it), so a
fault the two share decodes without a mismatch.
"""

from __future__ import annotations

import numpy as np

from benchmark.avref.bitstream import obu
from benchmark.avref.entropy import coeff as coeff_syntax
from benchmark.avref.entropy import lr as lr_syntax
from benchmark.avref.entropy import modes as mode_syntax
from benchmark.avref.entropy import mv as mv_syntax
from benchmark.avref.entropy.cdf import FrameContext
from benchmark.avref.entropy.ctx import TileContexts
from benchmark.avref.entropy.writer import SymbolReader
from benchmark.avref.pipeline import common, mvp
from benchmark.avref.ops import cdef as cdef_ops
from benchmark.avref.ops import intra as intra_ops
from benchmark.avref.ops import intra_dir
from benchmark.avref.ops import quant as quant_ops
from benchmark.avref.ops import restoration as rst_ops
from benchmark.avref.ops import transforms as tx_ops
from benchmark.avref.pipeline import avail, common
from benchmark.avref.utils.blocks import (PARTITION_HORZ, PARTITION_HORZ_4,
                                          PARTITION_HORZ_A, PARTITION_HORZ_B,
                                          PARTITION_NONE, PARTITION_SPLIT,
                                          PARTITION_VERT, PARTITION_VERT_4,
                                          PARTITION_VERT_A, PARTITION_VERT_B,
                                          TX_HEIGHT, TX_WIDTH)


class FrameDecoder:
    def __init__(self, seq: obu.SequenceHeader, fh: obu.FrameHeader,
                 refs=None, init_entropy=None):
        self.seq = seq
        self.fh = fh
        # (FrameContext, NmvContext) loaded from the primary ref's slot
        # (spec 6.8.2 load_cdfs) or None for PRIMARY_REF_NONE
        self.init_entropy = init_entropy
        self.is_inter = fh.frame_type != obu.KEY_FRAME
        self.refs = refs  # padded reference planes (inter frames)
        self.mi_cols = seq.mi_cols
        self.mi_rows = seq.mi_rows
        self.bd = seq.bit_depth
        self.qp = quant_ops.make_quant_params(fh.base_q_idx,
                                              bit_depth=self.bd)
        pw, ph = seq.sb_cols * 64, seq.sb_rows * 64
        dt = common.pixel_dtype(self.bd)
        self.recon = [np.zeros((ph, pw), dtype=dt),
                      np.zeros((ph // 2, pw // 2), dtype=dt),
                      np.zeros((ph // 2, pw // 2), dtype=dt)]
        self.max_wh = [(self.mi_cols * 4, self.mi_rows * 4),
                       (self.mi_cols * 2, self.mi_rows * 2),
                       (self.mi_cols * 2, self.mi_rows * 2)]
        self.lr_rinfos = None
        if fh.lr_params is not None and any(fh.lr_params[0]):
            types, size_y, size_uv = fh.lr_params
            self.lr_rinfos = []
            for p in range(3):
                ss = 1 if p else 0
                Wp = (seq.width + ss) >> ss
                Hp = (seq.height + ss) >> ss
                size = size_y if p == 0 else size_uv
                lims, hn, vn = rst_ops.unit_limits(Wp, Hp, size, ss)
                self.lr_rinfos.append(rst_ops.RestorationInfo(
                    frame_restoration_type=types[p], unit_size=size,
                    units=[rst_ops.RestorationUnitInfo()
                           for _ in lims], hunits=hn, vunits=vn))

    def _read_lr(self, mi_row: int, mi_col: int) -> None:
        """read_lr mirror (spec 5.11.57) at each superblock
        (frame-absolute coords: LR units span the frame, spec
        whole_frame_rect, while syntax rides each tile's coder)."""
        if self.lr_rinfos is None:
            return
        mi_row = mi_row + self.tile_mi_off[0]
        mi_col = mi_col + self.tile_mi_off[1]
        for p in range(3):
            ri = self.lr_rinfos[p]
            if ri.frame_restoration_type == rst_ops.RESTORE_NONE:
                continue
            ss = 1 if p else 0
            Wp = (self.seq.width + ss) >> ss
            Hp = (self.seq.height + ss) >> ss
            for idx in rst_ops.units_in_sb(mi_row, mi_col, 16, Wp, Hp,
                                           ri.unit_size, ss, ss):
                ri.units[idx] = lr_syntax.read_lr_unit(
                    self.r, self.fc, ri.frame_restoration_type,
                    self.lr_ref[p], p > 0)

    def decode_frame(self, tile_payloads):
        frame_recon = self.recon
        frame_mi_rows, frame_mi_cols = self.mi_rows, self.mi_cols
        rects = common.tile_rects(self.seq.sb_cols, self.seq.sb_rows,
                                  frame_mi_cols, frame_mi_rows,
                                  self.fh.tile_cols_log2,
                                  self.fh.tile_rows_log2)
        assert len(rects) == len(tile_payloads)
        frame_leaves = {}
        frame_skip = np.zeros((frame_mi_rows, frame_mi_cols), dtype=bool)
        self.cdef_idx_map = None
        if self.seq.enable_cdef:
            self.cdef_idx_map = np.full((self.seq.sb_rows,
                                         self.seq.sb_cols), -1,
                                        dtype=np.int32)
        # frame-level MVP state: tiles decode through clipped views
        # (spec 7.10.2 scans stop at tile bounds) that stitch into one
        # frame motion field for the TMVP save
        self.frame_mvp_state = mvp.MvpState(frame_mi_rows, frame_mi_cols)
        tc = getattr(self, "tmvp_ctx", None)
        if tc is not None:
            self.frame_mvp_state.tpl, self.frame_mvp_state.rel_dist, \
                self.frame_mvp_state.sign_bias = tc
        for (mi_r0, mi_c0, mi_rs, mi_cs, sb_rs, sb_cs), data in \
                zip(rects, tile_payloads):
            y0, x0 = mi_r0 * 4, mi_c0 * 4
            ph, pw = sb_rs * 64, sb_cs * 64
            self.recon = [frame_recon[0][y0:y0 + ph, x0:x0 + pw],
                          frame_recon[1][y0 // 2:(y0 + ph) // 2,
                                         x0 // 2:(x0 + pw) // 2],
                          frame_recon[2][y0 // 2:(y0 + ph) // 2,
                                         x0 // 2:(x0 + pw) // 2]]
            self.mi_rows, self.mi_cols = mi_rs, mi_cs
            self.max_wh = [(mi_cs * 4, mi_rs * 4),
                           (mi_cs * 2, mi_rs * 2), (mi_cs * 2, mi_rs * 2)]
            self.tile_mi_off = (mi_r0, mi_c0)
            self._decode_one_tile(data, sb_rs, sb_cs)
            if (mi_r0, mi_c0) == rects[0][:2]:
                tile0_entropy = (self.fc, self.nmv)
            for (r, c), s in self.leaf_sizes.items():
                frame_leaves[(r + mi_r0, c + mi_c0)] = s
            frame_skip[mi_r0:mi_r0 + mi_rs, mi_c0:mi_c0 + mi_cs] = \
                self.ctxs.mi_skip[:mi_rs, :mi_cs] > 0
        # the state saved into this frame's refresh slots (spec 7.20 /
        # 6.8.2: frame-end update takes tile context_update_tile_id's
        # adapted CDFs unless disabled, in which case the starting state)
        if self.fh.disable_frame_end_update_cdf:
            self.final_entropy = (
                (self.init_entropy[0].copy(), self.init_entropy[1].copy())
                if self.init_entropy is not None
                else (FrameContext(self.fh.base_q_idx),
                      mv_syntax.NmvContext()))
        else:
            self.final_entropy = tile0_entropy
        self.recon = frame_recon
        self.mi_rows, self.mi_cols = frame_mi_rows, frame_mi_cols
        self.mvp_state = self.frame_mvp_state  # stitched motion field
        if any(self.fh.loop_filter_levels):
            from benchmark.avref.ops import dlf
            dlf.loop_filter_frame(self.recon, frame_leaves, self.mi_rows,
                                  self.mi_cols, self.fh.loop_filter_levels,
                                  bd=self.bd)
        lr_bounds = None
        if self.lr_rinfos is not None:
            lr_bounds = []
            for p in range(3):
                ss = 1 if p else 0
                Hp = (self.seq.height + ss) >> ss
                Wp = (self.seq.width + ss) >> ss
                lr_bounds.append(rst_ops.save_deblock_boundary_lines(
                    self.recon[p][:Hp, :Wp], Hp, ss))
        if self.seq.enable_cdef:
            skip8 = frame_skip[0::2, 0::2] & frame_skip[0::2, 1::2] \
                & frame_skip[1::2, 0::2] & frame_skip[1::2, 1::2]
            cdef_ops.cdef_frame(self.recon, skip8, self.cdef_idx_map,
                                self.fh.cdef_y_strengths,
                                self.fh.cdef_uv_strengths,
                                self.fh.cdef_damping, self.mi_rows,
                                self.mi_cols, self.bd)
        if self.lr_rinfos is not None:
            rst_ops.loop_restoration_filter_frame(
                self.recon, self.lr_rinfos, lr_bounds, self.seq.width,
                self.seq.height, self.seq.bit_depth)
        w, h = self.seq.width, self.seq.height
        return [self.recon[0][:h, :w],
                self.recon[1][:(h + 1) // 2, :(w + 1) // 2],
                self.recon[2][:(h + 1) // 2, :(w + 1) // 2]]

    def _read_delta_q(self, mi_row: int, mi_col: int, size: int,
                      skip: int) -> None:
        """read_delta_qindex mirror (spec 5.11.5)."""
        if not self.fh.delta_q_present or not self._read_deltas:
            return
        self._read_deltas = False
        if size == 64 and skip:
            return
        from benchmark.avref.entropy import delta as delta_syntax
        d = delta_syntax.read_delta_qindex(self.r, self.fc)
        self.cur_qindex = delta_syntax.apply_delta(self.cur_qindex, d,
                                                   self.fh.delta_q_res)
        if self.cur_qindex not in self._dq_cache:
            self._dq_cache[self.cur_qindex] = quant_ops.make_quant_params(
                self.cur_qindex, bit_depth=self.bd)
        self.qp = self._dq_cache[self.cur_qindex]

    def _decode_one_tile(self, data: bytes, sb_rs: int, sb_cs: int):
        if self.init_entropy is not None:
            self.fc = self.init_entropy[0].copy()
            self.nmv = self.init_entropy[1].copy()
        else:
            self.fc = FrameContext(self.fh.base_q_idx)
            self.nmv = mv_syntax.NmvContext()
        self.r = SymbolReader(data,
                              disable_cdf_update=self.fh.disable_cdf_update)
        self.ctxs = TileContexts(self.mi_cols, self.mi_rows)
        # neighbor-smoothness maps for the intra edge filter's filt_type
        # (tile-local availability; luma at mi, chroma at 2-mi units)
        self._sm_y = np.zeros((self.mi_rows, self.mi_cols), dtype=bool)
        self._sm_uv = np.zeros(((self.mi_rows + 1) >> 1,
                                (self.mi_cols + 1) >> 1), dtype=bool)
        self._ftype = (0, 0)
        self.mvp_state = self.frame_mvp_state.tile_view(
            self.tile_mi_off[0], self.tile_mi_off[1], self.mi_rows,
            self.mi_cols)
        self.leaf_sizes = {}
        self.lr_ref = [lr_syntax.LrRefState() for _ in range(3)]
        # per-tile delta-q state reset (spec 6.10.2: CurrentQIndex is
        # re-initialised to base_q_idx at every tile start). The qp cache
        # must be rebuilt from base_q_idx — reusing the running self.qp
        # here would carry the PREVIOUS tile's last delta'd qindex into
        # this tile's dequant.
        self.cur_qindex = self.fh.base_q_idx
        self._dq_cache = {self.cur_qindex: quant_ops.make_quant_params(
            self.cur_qindex, bit_depth=self.bd)}
        self.qp = self._dq_cache[self.cur_qindex]
        for sb_y in range(0, sb_rs * 16, 16):
            for sb_x in range(0, sb_cs * 16, 16):
                self._read_deltas = self.fh.delta_q_present
                self._read_lr(sb_y, sb_x)
                self._decode_partition(sb_y, sb_x, 64)

    def _decode_partition(self, mi_row: int, mi_col: int, size: int) -> None:
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        bsize = common.square_bsize(size)
        partition = mode_syntax.read_partition(
            self.r, self.fc, self.ctxs, bsize, mi_row, mi_col,
            self.mi_cols, self.mi_rows)
        if partition == PARTITION_SPLIT:
            hbs = size >> 3
            half = size >> 1
            self._decode_partition(mi_row, mi_col, half)
            self._decode_partition(mi_row, mi_col + hbs, half)
            self._decode_partition(mi_row + hbs, mi_col, half)
            self._decode_partition(mi_row + hbs, mi_col + hbs, half)
        elif partition == PARTITION_NONE:
            self._decode_block(mi_row, mi_col, size)
            self.ctxs.update_partition_ctx(mi_row, mi_col, bsize, bsize)
            self.leaf_sizes[(mi_row, mi_col)] = size
        else:
            # non-none leaf layouts: ordered (r, c, (w, h)) per partition
            # type (spec 5.11.4 block order); clipped leaves are skipped
            hbs = size >> 3
            half = size >> 1
            quarter = size >> 2
            qbs = size >> 4
            sq = (half, half)
            rh, rv = (size, half), (half, size)
            layouts = {
                PARTITION_HORZ: [(0, 0, rh), (hbs, 0, rh)],
                PARTITION_VERT: [(0, 0, rv), (0, hbs, rv)],
                PARTITION_HORZ_A: [(0, 0, sq), (0, hbs, sq), (hbs, 0, rh)],
                PARTITION_HORZ_B: [(0, 0, rh), (hbs, 0, sq),
                                   (hbs, hbs, sq)],
                PARTITION_VERT_A: [(0, 0, sq), (hbs, 0, sq), (0, hbs, rv)],
                PARTITION_VERT_B: [(0, 0, rv), (0, hbs, sq),
                                   (hbs, hbs, sq)],
                PARTITION_HORZ_4: [(i * qbs, 0, (size, quarter))
                                   for i in range(4)],
                PARTITION_VERT_4: [(0, i * qbs, (quarter, size))
                                   for i in range(4)],
            }
            if partition not in layouts:
                raise NotImplementedError(f"partition type {partition}")
            for dr, dc, wh in layouts[partition]:
                rr, cc = mi_row + dr, mi_col + dc
                if rr >= self.mi_rows or cc >= self.mi_cols:
                    continue
                # square members of mixed-vertical partitions follow the
                # TL,BL,TR coding order: availability + MVP adjust
                self._leaf_part = partition if wh[0] == wh[1] else None
                skip0 = mode_syntax.read_skip(self.r, self.fc, self.ctxs,
                                              rr, cc)
                self._read_cdef(rr, cc, skip0)
                self._read_delta_q(rr, cc, 0, skip0)
                if self.is_inter:
                    self._decode_inter_tail(rr, cc, wh, skip0)
                else:
                    self._decode_intra_tail(rr, cc, wh, skip0, kf=True)
                self.leaf_sizes[(rr, cc)] = \
                    wh[0] if wh[0] == wh[1] else wh
                # per-leaf partition-context update (mirrors the emit
                # side; equals the one-shot parent update for the
                # equal-leaf types)
                self.ctxs.update_partition_ctx(
                    rr, cc, common.rect_bsize(*wh), common.rect_bsize(*wh))

    def _read_cdef(self, mi_row: int, mi_col: int, skip: int) -> None:
        """read_cdef mirror: cdef_idx literal at the first non-skip block
        of each 64x64."""
        if self.cdef_idx_map is None or skip:
            return
        sbr = (mi_row + self.tile_mi_off[0]) // 16
        sbc = (mi_col + self.tile_mi_off[1]) // 16
        if self.cdef_idx_map[sbr, sbc] == -1:
            self.cdef_idx_map[sbr, sbc] = self.r.read_literal(
                self.fh.cdef_bits)

    def _leaf_vert_a(self) -> bool:
        """Current leaf is a square member of a PARTITION_VERT_A parent
        (MVP top-right adjust, reference
        EbAdaptiveMotionVectorPrediction.c:882)."""
        from benchmark.avref.utils.blocks import PARTITION_VERT_A
        return getattr(self, "_leaf_part", None) == PARTITION_VERT_A

    def _decode_block(self, mi_row: int, mi_col: int, size: int) -> None:
        self._leaf_part = None
        if self.is_inter:
            self._decode_inter_block(mi_row, mi_col, size)
        else:
            self._decode_intra_block(mi_row, mi_col, size)

    def _decode_inter_block(self, mi_row: int, mi_col: int,
                            size: int) -> None:
        skip = mode_syntax.read_skip(self.r, self.fc, self.ctxs,
                                     mi_row, mi_col)
        self._read_cdef(mi_row, mi_col, skip)
        self._read_delta_q(mi_row, mi_col, size, skip)
        self._decode_inter_tail(mi_row, mi_col, size, skip)

    def _decode_inter_tail(self, mi_row: int, mi_col: int, size,
                           skip: int) -> None:
        from benchmark.avref.entropy import inter_modes
        from benchmark.avref.ops import mc
        from benchmark.avref.pipeline.mvp import (GLOBALMV, LAST_FRAME,
                                                  NEARESTMV, NEARMV)
        x, y = mi_col * 4, mi_row * 4
        bw, bh = common.leaf_wh(size)
        bsize = common.rect_bsize(bw, bh)
        s4 = bw >> 2
        h4 = bh >> 2
        is_inter = inter_modes.read_is_inter(self.r, self.fc,
                                             self.mvp_state, mi_row, mi_col)
        if not is_inter:
            # intra block inside an inter frame (spec 5.11.19)
            self._decode_intra_tail(mi_row, mi_col, size, skip, kf=False)
            self.mvp_state.set_block(mi_row, mi_col, s4, mvp.INTRA_FRAME,
                                     (0, 0), 0, h4=h4)
            return
        if self.fh.reference_select and inter_modes.read_comp_inter(
                self.r, self.fc, self.mvp_state, mi_row, mi_col):
            self._decode_compound_tail(mi_row, mi_col, size, skip)
            return
        ref = inter_modes.read_single_ref(self.r, self.fc, self.mvp_state,
                                          mi_row, mi_col)
        gm_mv = self.fh.gm_trans[ref - 1]
        res = mvp.find_mv_stack(self.mvp_state, mi_row, mi_col, s4, ref,
                                gm_mv=gm_mv, h4=h4,
                                vert_a=self._leaf_vert_a())
        mode = inter_modes.read_inter_mode(self.r, self.fc, res)
        drl = inter_modes.read_drl_idx(self.r, self.fc, mode, res)
        if mode == NEARESTMV:
            mv = res.ref_list[0]
        elif mode == NEARMV:
            mv = res.ref_list[1] if drl == 0 else res.stack[1 + drl][0]
        elif mode == GLOBALMV:
            mv = gm_mv
        else:
            pred = res.stack[drl][0] if res.count > 1 else res.ref_list[0]
            dr, dc = mv_syntax.read_mv(self.r, self.nmv)
            mv = (pred[0] + dr, pred[1] + dc)
        ftype = 0
        if self.fh.interp_filter_switchable \
                and inter_modes.needs_interp_filter(mode, bw, bh,
                                                    gm_mv != (0, 0)):
            ftype = inter_modes.read_interp_filter(
                self.r, self.fc, self.mvp_state, mi_row, mi_col, ref,
                False)
        self.ctxs.set_mi(mi_row, mi_col, bsize, 0, skip)
        self.mvp_state.set_block(mi_row, mi_col, s4, ref, mv, mode,
                                 h4=h4)
        self.mvp_state.interp[mi_row:mi_row + h4,
                              mi_col:mi_col + s4] = ftype

        cw, ch = bw >> 1, bh >> 1
        tx_y = common.tx_size_for_rect(bw, bh, 0)
        tx_uv = common.tx_size_for_rect(cw, ch, 1)
        plane_info = [(0, x, y, (bw, bh), tx_y, bsize, 0),
                      (1, x >> 1, y >> 1, (cw, ch), tx_uv,
                       common.rect_bsize(cw, ch), 1),
                      (2, x >> 1, y >> 1, (cw, ch), tx_uv,
                       common.rect_bsize(cw, ch), 1)]
        ref_planes = self.refs[ref]
        ltt = 0   # luma tx type; inter chroma inherits it (spec 8.3.2)
        # MC reads reference pixels at FRAME coordinates (legal across
        # tile bounds, spec 7.11.3); recon writes stay tile-local views
        oy, ox = self.tile_mi_off[0] * 4, self.tile_mi_off[1] * 4
        for p, px, py, psz, ts, pb, ss in plane_info:
            pw, ph = psz
            pred = self._single_pred(ref_planes[p], px + (ox >> ss),
                                     py + (oy >> ss), mv, pw, ph,
                                     ss, ftype)
            x4, y4 = px >> 2, py >> 2
            if skip:
                self.recon[p][py:py + ph, px:px + pw] = pred
                self.ctxs.update_txb_ctx(p, x4, y4, ts, 0)
                continue
            skip_ctx, sign_ctx = self.ctxs.txb_ctx(p, pb, ts, x4, y4)
            qcoeff, tx_type, cul = coeff_syntax.read_coeffs_txb(
                self.r, self.fc, ts, plane_type=int(p > 0),
                txb_skip_ctx=skip_ctx, dc_sign_ctx=sign_ctx, is_inter=True,
                base_qindex=self.fh.base_q_idx,
                uv_tx_type=(0 if p == 0 else common.chroma_tx_type_inter(
                    ltt, ts, self.fh.reduced_tx_set)))
            self.ctxs.update_txb_ctx(p, x4, y4, ts, cul)
            if p == 0 and np.any(qcoeff):
                ltt = int(tx_type)
            if not np.any(qcoeff):
                self.recon[p][py:py + ph, px:px + pw] = pred
                continue
            tcw, tch = common.coded_dims(ts)
            log_scale = quant_ops.tx_scale(ts)
            dq = quant_ops.dequantize(qcoeff.reshape(1, -1), self.qp,
                                      log_scale)
            full = np.zeros((1, ph, pw), dtype=np.int64)
            full[0, :tch, :tcw] = dq.reshape(tch, tcw)
            resid = tx_ops.inverse_tx2d(full, tx_type, pw, ph,
                                        bd=self.bd)[0]
            self.recon[p][py:py + ph, px:px + pw] = tx_ops.recon_add(
                pred[None].astype(np.int64), resid[None], bd=self.bd)[0]

    # prediction seams (overridden by verify.indep's checking decoder) ---------
    def _single_pred(self, ref_plane, px, py, mv, pw, ph, ss,
                     ftype=0):
        from benchmark.avref.ops import mc
        return mc.mc_block_batch(ref_plane, np.array([px]),
                                 np.array([py]), np.array([mv]), pw, ph,
                                 ss=ss, bd=self.bd, ftype=ftype)[0]

    def _compound_pred(self, rp0, rp1, px, py, mv0, mv1, pw, ph, ss,
                       ftype=0):
        from benchmark.avref.ops import mc
        c0 = mc.mc_block_batch_conv(rp0, np.array([px]), np.array([py]),
                                    np.array([mv0]), pw, ph, ss=ss,
                                    bd=self.bd, ftype=ftype)
        c1 = mc.mc_block_batch_conv(rp1, np.array([px]), np.array([py]),
                                    np.array([mv1]), pw, ph, ss=ss,
                                    bd=self.bd, ftype=ftype)
        return mc.compound_average(c0, c1, self.bd)[0]

    def _decode_compound_tail(self, mi_row: int, mi_col: int, size: int,
                              skip: int) -> None:
        """Compound (bidir) block: refs, compound mode, DRL, MVs, then
        averaged prediction (spec 5.11.25/7.11.3; reference
        av1_jnt_convolve_2d_c average path)."""
        from benchmark.avref.entropy import inter_modes
        from benchmark.avref.ops import mc
        from benchmark.avref.pipeline.mvp import (GLOBAL_GLOBALMV,
                                              NEAR_NEARMV,
                                              NEAREST_NEARESTMV,
                                              NEAREST_NEWMV,
                                              NEW_NEARESTMV, NEW_NEWMV)
        x, y = mi_col * 4, mi_row * 4
        bw, bh = common.leaf_wh(size)
        bsize = common.rect_bsize(bw, bh)
        s4 = bw >> 2
        h4 = bh >> 2
        fwd, bwd = inter_modes.read_comp_refs(self.r, self.fc,
                                              self.mvp_state, mi_row,
                                              mi_col)
        gm_pair = (self.fh.gm_trans[fwd - 1], self.fh.gm_trans[bwd - 1])
        res = mvp.find_mv_stack_comp(self.mvp_state, mi_row, mi_col, s4,
                                     fwd, bwd, gm=gm_pair, h4=h4,
                                     vert_a=self._leaf_vert_a())
        mode = inter_modes.read_inter_compound_mode(self.r, self.fc, res)
        drl = inter_modes.read_drl_idx(self.r, self.fc, mode, res)
        if mode == NEAREST_NEARESTMV:
            mv0, mv1 = res.ref_list[0]
        elif mode == NEAR_NEARMV:
            pair = res.ref_list[1] if drl == 0 else res.stack[1 + drl][0]
            mv0, mv1 = pair
        elif mode == GLOBAL_GLOBALMV:
            mv0, mv1 = gm_pair
        elif mode in (NEW_NEWMV, NEAREST_NEWMV, NEW_NEARESTMV):
            pred = res.stack[drl][0] if res.count > 1 else res.ref_list[0]
            if mode == NEW_NEARESTMV or mode == NEW_NEWMV:
                d0 = mv_syntax.read_mv(self.r, self.nmv)
                mv0 = (pred[0][0] + d0[0], pred[0][1] + d0[1])
            else:
                mv0 = res.ref_list[0][0]
            if mode == NEAREST_NEWMV or mode == NEW_NEWMV:
                d1 = mv_syntax.read_mv(self.r, self.nmv)
                mv1 = (pred[1][0] + d1[0], pred[1][1] + d1[1])
            else:
                mv1 = res.ref_list[0][1]
        else:
            raise NotImplementedError(f"compound mode {mode}")
        ftype = 0
        if self.fh.interp_filter_switchable \
                and inter_modes.needs_interp_filter(
                    mode, bw, bh, gm_pair[0] != (0, 0),
                    gm_pair[1] != (0, 0)):
            ftype = inter_modes.read_interp_filter(
                self.r, self.fc, self.mvp_state, mi_row, mi_col, fwd,
                True)
        self.ctxs.set_mi(mi_row, mi_col, bsize, 0, skip)
        self.mvp_state.set_block(mi_row, mi_col, s4, fwd, mv0, mode,
                                 ref1=bwd, mv1=mv1, h4=h4)
        self.mvp_state.interp[mi_row:mi_row + h4,
                              mi_col:mi_col + s4] = ftype
        cw, ch = bw >> 1, bh >> 1
        tx_y = common.tx_size_for_rect(bw, bh, 0)
        tx_uv = common.tx_size_for_rect(cw, ch, 1)
        plane_info = [(0, x, y, (bw, bh), tx_y, bsize, 0),
                      (1, x >> 1, y >> 1, (cw, ch), tx_uv,
                       common.rect_bsize(cw, ch), 1),
                      (2, x >> 1, y >> 1, (cw, ch), tx_uv,
                       common.rect_bsize(cw, ch), 1)]
        rp0 = self.refs[fwd]
        rp1 = self.refs[bwd]
        ltt = 0   # luma tx type; inter chroma inherits it (spec 8.3.2)
        oy, ox = self.tile_mi_off[0] * 4, self.tile_mi_off[1] * 4
        for p, px, py, psz, ts, pb, ss in plane_info:
            pw, ph = psz
            pred = self._compound_pred(rp0[p], rp1[p], px + (ox >> ss),
                                       py + (oy >> ss), mv0, mv1,
                                       pw, ph, ss, ftype)
            x4, y4 = px >> 2, py >> 2
            if skip:
                self.recon[p][py:py + ph, px:px + pw] = pred
                self.ctxs.update_txb_ctx(p, x4, y4, ts, 0)
                continue
            skip_ctx, sign_ctx = self.ctxs.txb_ctx(p, pb, ts, x4, y4)
            qcoeff, tx_type, cul = coeff_syntax.read_coeffs_txb(
                self.r, self.fc, ts, plane_type=int(p > 0),
                txb_skip_ctx=skip_ctx, dc_sign_ctx=sign_ctx, is_inter=True,
                base_qindex=self.fh.base_q_idx,
                uv_tx_type=(0 if p == 0 else common.chroma_tx_type_inter(
                    ltt, ts, self.fh.reduced_tx_set)))
            self.ctxs.update_txb_ctx(p, x4, y4, ts, cul)
            if p == 0 and np.any(qcoeff):
                ltt = int(tx_type)
            if not np.any(qcoeff):
                self.recon[p][py:py + ph, px:px + pw] = pred
                continue
            tcw, tch = common.coded_dims(ts)
            log_scale = quant_ops.tx_scale(ts)
            dq = quant_ops.dequantize(qcoeff.reshape(1, -1), self.qp,
                                      log_scale)
            full = np.zeros((1, ph, pw), dtype=np.int64)
            full[0, :tch, :tcw] = dq.reshape(tch, tcw)
            resid = tx_ops.inverse_tx2d(full, tx_type, pw, ph,
                                        bd=self.bd)[0]
            self.recon[p][py:py + ph, px:px + pw] = tx_ops.recon_add(
                pred[None].astype(np.int64), resid[None], bd=self.bd)[0]

    def _decode_intra_block(self, mi_row: int, mi_col: int,
                            size: int) -> None:
        skip = mode_syntax.read_skip(self.r, self.fc, self.ctxs,
                                     mi_row, mi_col)
        self._read_cdef(mi_row, mi_col, skip)
        self._read_delta_q(mi_row, mi_col, size, skip)
        self._decode_intra_tail(mi_row, mi_col, size, skip, kf=True)

    def _decode_intra_tail(self, mi_row: int, mi_col: int, size: int,
                           skip: int, kf: bool) -> None:
        """Mode info + reconstruction of an intra block; keyframes use
        the neighbor-ctx kf_y_mode CDF, inter frames the size-group
        y_mode CDF (spec 5.11.18 vs 5.11.19)."""
        x, y = mi_col * 4, mi_row * 4
        bw, bh = common.leaf_wh(size)
        bsize = common.rect_bsize(bw, bh)
        if kf:
            y_mode = mode_syntax.read_intra_luma_mode_kf(self.r, self.fc,
                                                         self.ctxs, mi_row,
                                                         mi_col)
        else:
            y_mode = mode_syntax.read_intra_luma_mode_if(self.r, self.fc,
                                                         max(bw, bh))
        y_delta = mode_syntax.read_angle_delta(self.r, self.fc, y_mode) \
            if intra_dir.is_directional(y_mode) else 0
        cfl_allowed = bw <= 32 and bh <= 32
        uv_mode = mode_syntax.read_intra_chroma_mode(self.r, self.fc,
                                                     y_mode, cfl_allowed)
        self._cfl_alphas = (0, 0)
        if uv_mode == 13:  # UV_CFL_PRED
            from benchmark.avref.ops import cfl as cfl_ops
            self._cfl_alphas = cfl_ops.read_cfl_alphas(self.r, self.fc)
        uv_delta = mode_syntax.read_angle_delta(self.r, self.fc, uv_mode) \
            if intra_dir.is_directional(uv_mode) else 0
        self.ctxs.set_mi(mi_row, mi_col, bsize, y_mode, skip)
        if self.seq.enable_intra_edge_filter:
            r2, c2 = mi_row >> 1, mi_col >> 1
            fy = (mi_row > 0 and self._sm_y[mi_row - 1, mi_col]) \
                or (mi_col > 0 and self._sm_y[mi_row, mi_col - 1])
            fuv = (r2 > 0 and self._sm_uv[r2 - 1, c2]) \
                or (c2 > 0 and self._sm_uv[r2, c2 - 1])
            self._ftype = (int(fy), int(fuv))
            if intra_dir.is_smooth_mode(y_mode):
                self._sm_y[mi_row:mi_row + (bh >> 2),
                           mi_col:mi_col + (bw >> 2)] = True
            if intra_dir.is_smooth_mode(uv_mode):
                self._sm_uv[r2:r2 + max(1, bh >> 3),
                            c2:c2 + max(1, bw >> 3)] = True
        from benchmark.avref.utils.blocks import (PARTITION_VERT_A,
                                              PARTITION_VERT_B)
        vab = getattr(self, "_leaf_part", None) in (PARTITION_VERT_A,
                                                    PARTITION_VERT_B)
        self._htr = avail.has_top_right_wh(mi_row, mi_col, bw >> 2,
                                           bh >> 2, self.mi_cols,
                                           vert_ab=vab)
        self._hbl = avail.has_bottom_left_wh(mi_row, mi_col, bw >> 2,
                                             bh >> 2, self.mi_rows,
                                             vert_ab=vab)

        cw, ch = bw >> 1, bh >> 1
        cx, cy = x >> 1, y >> 1
        tx_y = common.tx_size_for_rect(bw, bh, 0)
        tx_uv = common.tx_size_for_rect(cw, ch, 1)
        tt_u = common.chroma_tx_type(uv_mode, tx_uv,
                                     self.fh.reduced_tx_set)
        plane_info = [(0, x, y, tx_y, y_mode, y_delta, bsize),
                      (1, cx, cy, tx_uv, uv_mode, uv_delta,
                       common.rect_bsize(cw, ch)),
                      (2, cx, cy, tx_uv, uv_mode, uv_delta,
                       common.rect_bsize(cw, ch))]
        for p, px, py, ts, m, d, pb in plane_info:
            if skip:
                self._predict_into(p, px, py, ts, m, d, None, 0)
                self.ctxs.update_txb_ctx(p, px >> 2, py >> 2, ts, 0)
            else:
                self._decode_txb(p, px, py, ts, m, d, pb, tt_u)

    def _decode_txb(self, plane: int, x: int, y: int, tx_size: int,
                    mode: int, delta: int, plane_bsize: int,
                    uv_tx_type: int) -> None:
        x4, y4 = x >> 2, y >> 2
        skip_ctx, sign_ctx = self.ctxs.txb_ctx(plane, plane_bsize, tx_size,
                                               x4, y4)
        qcoeff, tx_type, cul = coeff_syntax.read_coeffs_txb(
            self.r, self.fc, tx_size, plane_type=int(plane > 0),
            txb_skip_ctx=skip_ctx, dc_sign_ctx=sign_ctx, intra_dir=mode,
            base_qindex=self.fh.base_q_idx, uv_tx_type=uv_tx_type)
        self.ctxs.update_txb_ctx(plane, x4, y4, tx_size, cul)
        self._predict_into(plane, x, y, tx_size, mode, delta, qcoeff,
                           tx_type)

    def _predict_into(self, plane: int, x: int, y: int, tx_size: int,
                      mode: int, delta: int, qcoeff, tx_type: int) -> None:
        tw, th = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
        cw, ch = common.coded_dims(tx_size)
        recon = self.recon[plane]
        max_w, max_h = self.max_wh[plane]
        ha = np.array([y > 0])
        hl = np.array([x > 0])
        above1, left1 = intra_ops.prepare_edges_av1(
            recon, np.array([x]), np.array([y]), tw, th, ha, hl,
            np.array([self._htr]), np.array([self._hbl]), bd=self.bd,
            max_w=max_w, max_h=max_h)
        if mode == 13 and plane > 0:  # UV_CFL_PRED
            from benchmark.avref.ops import cfl as cfl_ops
            dc = intra_ops.predict(0, above1[:, 1:], left1[:, 1:],
                                   above1[:, 0], tw, th, have_above=ha,
                                   have_left=hl, bd=self.bd)
            luma = self.recon[0][2 * y:2 * (y + th),
                                 2 * x:2 * (x + tw)][None]
            ac = cfl_ops.luma_ac_420(luma)
            alpha = self._cfl_alphas[plane - 1]
            pred = cfl_ops.predict(dc, ac, np.array([alpha]),
                                   bd=self.bd)[0]
        else:
            edge = None
            if self.seq.enable_intra_edge_filter:
                ft = self._ftype[int(plane > 0)]
                edge = (np.array([ft], dtype=np.int32),
                        np.array([np.clip(max_w - x, 0, tw)]),
                        np.array([np.clip(max_h - y, 0, th)]))
            pred = intra_ops.predict_any(mode, delta, above1, left1, tw, th,
                                         ha, hl, bd=self.bd, edge=edge)[0]
        if qcoeff is None or not np.any(qcoeff):
            recon[y:y + th, x:x + tw] = np.clip(
                pred, 0, (1 << self.bd) - 1).astype(self.recon[plane].dtype)
            return
        log_scale = quant_ops.tx_scale(tx_size)
        dq = quant_ops.dequantize(qcoeff.reshape(1, -1), self.qp, log_scale)
        full = np.zeros((1, th, tw), dtype=np.int64)
        full[0, :ch, :cw] = dq.reshape(ch, cw)
        resid = tx_ops.inverse_tx2d(full, tx_type, tw, th, bd=self.bd)[0]
        recon[y:y + th, x:x + tw] = tx_ops.recon_add(pred[None],
                                                     resid[None],
                                                     bd=self.bd)[0]


class StreamDecoder:
    """Multi-frame decoder with reference-slot management (the decoder-side
    analogue of the reference's reference queue, EbPictureManagerProcess)."""

    frame_decoder_cls = FrameDecoder   # seam for checking decoders

    def __init__(self, seq: obu.SequenceHeader = None):
        self.seq = seq
        self.slots = [None] * 8       # padded recon planes per slot
        self.slot_info = [None] * 8   # TMVP facts (pipeline.tmvp.SlotInfo)
        # SavedCdfs / SavedGmParams stores (spec 7.20 reference frame
        # update): entropy state + gm params per slot for primary-ref
        # CDF carry
        self.slot_entropy = [None] * 8
        self.slot_gm = [((0, 0),) * 7] * 8
        self.metadata = {}            # metadata_type -> parsed fields

    def _crop(self, planes):
        w, h = self.seq.width, self.seq.height
        return [planes[0][:h, :w],
                planes[1][:(h + 1) // 2, :(w + 1) // 2],
                planes[2][:(h + 1) // 2, :(w + 1) // 2]]

    def decode_tu(self, tu: bytes):
        """Returns cropped recon planes of the shown frame, or None (the
        TU coded a non-shown frame)."""
        from benchmark.avref.entropy.inter_modes import ALTREF_FRAME
        from benchmark.avref.ops import mc
        from benchmark.avref.pipeline.mvp import LAST_FRAME
        recon = None
        for obu_type, payload in obu.parse_obus(tu):
            if obu_type == obu.OBU_TEMPORAL_DELIMITER:
                continue
            if obu_type == obu.OBU_METADATA:
                mtype, md_vals = obu.parse_metadata_obu(payload)
                self.metadata[mtype] = md_vals
                continue
            if obu_type == obu.OBU_SEQUENCE_HEADER:
                self.seq = obu.parse_sequence_header_obu(payload)
            elif obu_type == obu.OBU_FRAME_HEADER:
                slot = obu.parse_show_existing(payload)
                assert slot is not None, "bare frame headers unsupported"
                assert self.slots[slot] is not None
                recon = self._crop(self.slots[slot])
            elif obu_type == obu.OBU_FRAME:
                assert self.seq is not None, "no sequence header seen"
                slot_hints = tuple(
                    si.order_hint if si is not None else 0
                    for si in self.slot_info)
                fh, tiles = obu.parse_frame_obu(payload, self.seq,
                                                slot_gm=self.slot_gm,
                                                slot_hints=slot_hints)
                refs = None
                if fh.frame_type != obu.KEY_FRAME:
                    # all 7 named references from ref_frame_idx (spec
                    # 6.8.2); distinct slots padded once and shared
                    refs = {}
                    padded = {}
                    assert self.slots[fh.ref_frame_idx[0]] is not None, \
                        "missing LAST reference"
                    for rid in range(LAST_FRAME, ALTREF_FRAME + 1):
                        slot = fh.ref_frame_idx[rid - 1]
                        if self.slots[slot] is None:
                            continue
                        if slot not in padded:
                            padded[slot] = [mc.pad_reference(p)
                                            for p in self.slots[slot]]
                        refs[rid] = padded[slot]
                init_entropy = None
                if fh.primary_ref_frame != obu.PRIMARY_REF_NONE:
                    init_entropy = self.slot_entropy[
                        fh.ref_frame_idx[fh.primary_ref_frame]]
                # temporal MV context (spec 7.9), identical to the
                # encoder-side derivation in pipeline.encoder
                from benchmark.avref.pipeline import tmvp
                bits = self.seq.order_hint_bits
                hint = fh.order_hint
                named_hints = [slot_hints[fh.ref_frame_idx[r - 1]]
                               for r in range(1, 8)]
                rel_dist = [0] * 8
                sign_bias = [0] * 8
                for r in range(1, 8):
                    rel_dist[r] = obu.get_relative_dist(
                        hint, named_hints[r - 1], bits)
                    sign_bias[r] = int(obu.get_relative_dist(
                        named_hints[r - 1], hint, bits) > 0)
                tmvp_ctx = None
                if fh.use_ref_frame_mvs:
                    tmvp_ctx = (tmvp.build_tpl_field(
                        self.seq.mi_rows, self.seq.mi_cols, hint,
                        fh.ref_frame_idx, self.slot_info, bits),
                        rel_dist, sign_bias)
                dec = self.frame_decoder_cls(self.seq, fh, refs,
                                             init_entropy=init_entropy)
                dec.tmvp_ctx = tmvp_ctx
                out = dec.decode_frame(tiles)
                if fh.show_frame:
                    recon = out
                if fh.frame_type == obu.KEY_FRAME:
                    new_info = tmvp.SlotInfo(order_hint=fh.order_hint,
                                             is_intra=True)
                else:
                    fr, fm = tmvp.save_motion_field(
                        dec.mvp_state, [-d for d in rel_dist])
                    new_info = tmvp.SlotInfo(
                        order_hint=fh.order_hint,
                        ref_order_hints=tuple(named_hints),
                        is_intra=False, field_ref=fr, field_mv=fm)
                for i in range(8):
                    if (fh.refresh_frame_flags >> i) & 1:
                        self.slots[i] = dec.recon
                        self.slot_entropy[i] = dec.final_entropy
                        self.slot_gm[i] = fh.gm_trans \
                            if fh.frame_type != obu.KEY_FRAME \
                            else ((0, 0),) * 7
                        self.slot_info[i] = new_info
            else:
                raise NotImplementedError(f"obu type {obu_type}")
        return recon


