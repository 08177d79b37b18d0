"""Wavefront-batched intra encoder: the keyframe encode pass of the port.

The port of the JAX package's ``pipeline/wavefront.py`` with its device
backend. Blocks on each anti-diagonal have no mutual prediction
dependencies, so every wave is one batched step (mode decision + transform
+ quant + recon for all blocks of the diagonal at once) on the torch
device, followed by a separate sequential syntax pass (entropy stage) that
emits the decisions through the native range coder.

Key frames take the fused tile programs (``ops/device_tile.py``) wherever
the JAX package's device backend takes them: with several tiles every
tile defers into one frame-batched program and the recon stays on the
device through deblocking into the reference slots; a single tile runs
its own program. Key frames whose candidates engage the intra edge filter
(``common.edge_filter_active``), key frames under variance AQ (each lane
then carries its superblock's qindex and lambda into the decide core),
and tiles with leaves below 8 px, take the per-wave loop
(``_wave_loop``): per wave and leaf shape the prediction
edges, each lane's filt_type (from the tile's neighbour-smoothness maps)
and its real above / left sample counts are prepared on the host from the
numpy recon, each plane's wave goes to the device and its decisions and
recon come back.
"""

from __future__ import annotations

import numpy as np
import torch

from svt_av1_tpu_torch.bitstream import obu
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.entropy import coeff as coeff_syntax
from svt_av1_tpu_torch.entropy import delta as delta_syntax
from svt_av1_tpu_torch.entropy import lr as lr_syntax
from svt_av1_tpu_torch.entropy import modes as mode_syntax
from svt_av1_tpu_torch.entropy.cdf import FrameContext
from svt_av1_tpu_torch.entropy.ctx import TileContexts
from svt_av1_tpu_torch.ops import intra as intra_ops
from svt_av1_tpu_torch.ops import intra_dir
from svt_av1_tpu_torch.ops import device_tile
from svt_av1_tpu_torch.ops import quant as quant_ops
from svt_av1_tpu_torch.ops import step_graphs
from svt_av1_tpu_torch.ops.device import dlf_search_apply_dev
from svt_av1_tpu_torch.ops.device_md import decide_block_batch_dev
from svt_av1_tpu_torch.pipeline import (analysis, avail, common,
                                        postfilter, rd)
from svt_av1_tpu_torch.pipeline.intra import make_symbol_writer
from svt_av1_tpu_torch.utils.blocks import PARTITION_SPLIT
from svt_av1_tpu_torch.utils.trace import span


class WavefrontIntraEncoder:
    """Batched-wave keyframe encoder."""

    def __init__(self, cfg: EncoderConfig, film_grain=None):
        """film_grain: the stream's film grain parameters (see
        common.frame_grain)."""
        self.cfg = cfg
        self.seq = common.sequence_header(cfg)
        self.film_grain = common.frame_grain(cfg, self.seq, film_grain)
        self.order_hint = 0           # set by the driver (display index)
        self.mi_cols = self.seq.mi_cols
        self.mi_rows = self.seq.mi_rows
        self.qp = quant_ops.make_quant_params(cfg.base_q_idx,
                                              bit_depth=cfg.bit_depth)
        self.lam = rd.rd_lambda(cfg.base_q_idx, cfg.bit_depth)
        # the fused tile programs take key frames unless the intra edge
        # filter can engage (the JAX gate): those need per-lane filt_type
        # operands, which only the per-wave loop carries
        self._edge = common.edge_filter_active(cfg)
        self._fused = not self._edge
        self.qmap = self.qmap_t = None
        self._classes = None
        # the previous coded source luma (set by the Encoder): the
        # variance AQ's temporal-stability hint
        self.aq_prev_luma = None
        self._tile_count = 1
        self._defer_tiles = None
        self._defer_waves = None
        # set by parallel/tiles.py: no tile defers into the frame program,
        # and each uniform tile's analysis is ``tile_hook(self, cands)``
        # (True when it filled the tile) in place of analyze_tile_fused
        self._no_defer = False
        self.tile_hook = None
        # the fused programs' class-step runner (its CUDA graphs and
        # buffers); the Encoder puts its own on each key frame's encoder,
        # so that graphs captured in one key frame serve the next
        self.class_graphs = step_graphs.ClassGraphs()

    # --- batched wave compute on the torch device ------------------------------
    def _wave_compute(self, plane: int, parts, size, cands, forced=None,
                      cfl_luma=None, ftype=None, qv=None, lamv=None):
        """Blocks of one wave, one leaf shape, from one or more tiles:
        mode decision + T/Q/IQ/recon in one device call. parts: per tile
        (tile, xs [b], ys [b], htr [b], hbl [b]), plane pixel positions
        and above-right / bottom-left availability inside the tile
        (``tile``: a per-wave tile record, see ``_wave_tile``). ``forced``:
        (modes [B], deltas [B]) to reuse instead of deciding (the V plane
        reuses the uv choice made on U — one shared chroma mode).
        ``cfl_luma``: co-located luma recon [B, 2s, 2s] (chroma planes,
        CfL-eligible). ``ftype``: [B] filt_type of the intra edge filter
        (None: off). ``qv``/``lamv``: [B] per-lane qindex and lambda
        under adaptive quantization (None: the frame's). B is the parts'
        lanes in order. Returns (modes,
        deltas, qcoeff [B,ch,cw], eob, alphas, tx types), all [B]."""
        cfg = self.cfg
        bw, bh = common.leaf_wh(size)
        per_tile = []
        for tile, xs, ys, htr, hbl in parts:
            src = tile["src"][plane]
            max_w, max_h = tile["max_wh"][plane]
            ha, hl = ys > 0, xs > 0
            above1, left1 = intra_ops.prepare_edges_av1(
                tile["recon"][plane], xs, ys, bw, bh, ha, hl, htr, hbl,
                bd=cfg.bit_depth, max_w=max_w, max_h=max_h)
            # the real sample counts (spec numPx = Min(w, MaxX - x + 1))
            per_tile.append((
                np.stack([src[y:y + bh, x:x + bw] for x, y in zip(xs, ys)]),
                above1, left1, ha, hl, np.clip(max_w - xs, 0, bw),
                np.clip(max_h - ys, 0, bh)))
        srcs, above1, left1, ha, hl, n_top, n_left = (
            np.concatenate(a) for a in zip(*per_tile))
        edge = None if ftype is None else (ftype, n_top, n_left)
        best, deltas, qcoeff, eob, recon_blocks, _, alphas, tts = \
            decide_block_batch_dev(
                plane, srcs.astype(np.int64), above1, left1, ha, hl, cands,
                self.qp, size, self.lam, bd=cfg.bit_depth, nfl=cfg.nfl,
                forced=forced, cfl_luma=cfl_luma,
                tx_search=(plane == 0 and cfg.enable_tx_type_search
                           and cfg.base_q_idx > 0),
                rdoq=cfg.enable_rdoq, qv=qv, lamv=lamv, edge=edge,
                device=cfg.device)
        i = 0
        for tile, xs, ys, _, _ in parts:
            recon = tile["recon"][plane]
            for x, y in zip(xs, ys):
                recon[y:y + bh, x:x + bw] = recon_blocks[i]
                i += 1
        return best, deltas, qcoeff, eob, alphas, tts

    # --- adaptive quantization (QPM) ------------------------------------------
    DELTA_Q_RES = 2  # coded deltas step 1 << 2 = 4 qindex units

    def _variance_qmap(self, y_padded) -> np.ndarray:
        """Per-SB qindex from local variance (the reference's
        SourceBasedOperations/QPM: flat areas get finer quantization,
        busy areas coarser; Av1QpModulationLcu EbCodingLoop.c:2222), with
        the previous source luma (``aq_prev_luma``, set by the Encoder)
        as the temporal-stability hint. Offsets are multiples of
        1 << DELTA_Q_RES so every SB-to-SB delta is codable."""
        return analysis.variance_qmap(y_padded, self.seq.sb_rows,
                                      self.seq.sb_cols,
                                      self.cfg.base_q_idx,
                                      self.DELTA_Q_RES,
                                      prev_y=self.aq_prev_luma,
                                      classes=self._classes)

    def _write_delta_q(self, mi_row, mi_col, size, skip) -> None:
        """Per-SB qindex delta at the first block of the SB (spec
        5.11.5: a full-SB skip block codes nothing and leaves the
        running qindex unchanged)."""
        if self.qmap_t is None or not self._read_deltas:
            return
        self._read_deltas = False
        self.cur_qindex = delta_syntax.write_sb_delta(
            self.w, self.fc, self.cur_qindex,
            int(self.qmap_t[mi_row // 16, mi_col // 16]), size, skip,
            self.DELTA_Q_RES)

    # --- leaf enumeration + dependency waves ----------------------------------
    def _fixed_leaf_sizes(self, target: int):
        """Uniform partition leaf map {(mi_row, mi_col): size}, with the
        edge-split rule the emit pass uses."""
        sizes = {}

        def rec(mi_row, mi_col, psize):
            if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
                return
            hbs = psize >> 3
            crosses = not ((mi_row + hbs) < self.mi_rows
                           and (mi_col + hbs) < self.mi_cols)
            if psize > target or (crosses and psize > 8):
                half = psize >> 1
                rec(mi_row, mi_col, half)
                rec(mi_row, mi_col + hbs, half)
                rec(mi_row + hbs, mi_col, half)
                rec(mi_row + hbs, mi_col + hbs, half)
            else:
                sizes[(mi_row, mi_col)] = psize

        for sb_y in range(0, self.sb_rows_t * 16, 16):
            for sb_x in range(0, self.sb_cols_t * 16, 16):
                rec(sb_y, sb_x, 64)
        return sizes

    def _leaves(self):
        """Leaf blocks (mi_row, mi_col, (w, h)) in coding order
        (square leaves normalized to tuples)."""
        raw = common.leaves_in_coding_order(self.leaf_sizes, self.mi_rows,
                                            self.mi_cols, self.sb_rows_t,
                                            self.sb_cols_t)
        return [(r, c, common.leaf_wh(v)) for r, c, v in raw]

    @staticmethod
    def _dependency_waves(leaves, mi_cols, mi_rows):
        """Topological wave index per leaf: a leaf waits for every
        earlier-coded leaf its extended above row / left column strips can
        read — 2x the block dimension, covering the above-right /
        bottom-left reference extensions (longest-path layering). Later
        leaves in the strips are spec-unavailable (replicated), so only
        earlier ones (j < i in coding order) become dependencies."""
        idx_map = np.full((mi_rows, mi_cols), -1, dtype=np.int64)
        for i, (r, c, wh) in enumerate(leaves):
            mw, mh = wh[0] >> 2, wh[1] >> 2
            idx_map[r:r + mh, c:c + mw] = i
        wave = np.zeros(len(leaves), dtype=np.int64)
        for i, (r, c, wh) in enumerate(leaves):
            mw, mh = wh[0] >> 2, wh[1] >> 2
            w = 0
            if r > 0:
                deps = idx_map[r - 1, c:min(c + 2 * mw, mi_cols)]
                deps = deps[(deps >= 0) & (deps < i)]
                if len(deps):
                    w = max(w, int(wave[deps].max()) + 1)
            if c > 0:
                deps = idx_map[r:min(r + 2 * mh, mi_rows), c - 1]
                deps = deps[(deps >= 0) & (deps < i)]
                if len(deps):
                    w = max(w, int(wave[deps].max()) + 1)
            wave[i] = w
        return wave

    # --- main ------------------------------------------------------------------
    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """``encode_compute`` then ``package_syntax`` on this thread.
        Returns (tu_bytes, display recon, stats)."""
        recon = self.encode_compute(y, u, v)
        tu, stats = self.package_syntax()
        return tu, recon, stats

    def encode_compute(self, y: np.ndarray, u: np.ndarray,
                       v: np.ndarray):
        """The frame's device work: partition, waves, deblocking. Returns
        the display-cropped recon; ``package_syntax`` then codes the
        decisions (on the encoder's entropy worker, off this thread)."""
        cfg = self.cfg
        frame_src = common.pad_frame_planes(y, u, v, dtype=np.int32)
        frame_recon = [np.zeros(p.shape,
                                dtype=common.pixel_dtype(cfg.bit_depth))
                       for p in frame_src]
        frame_mi_rows, frame_mi_cols = self.mi_rows, self.mi_cols

        self.tile_log2 = obu.clamp_tile_log2(self.seq, cfg.tile_cols_log2,
                                             cfg.tile_rows_log2)
        rects = common.tile_rects(self.seq.sb_cols, self.seq.sb_rows,
                                  frame_mi_cols, frame_mi_rows,
                                  *self.tile_log2)
        self.qmap = None
        if cfg.adaptive_quantization == 1:
            # variance AQ; under TPL AQ (2) the key frame codes flat — its
            # quality boost comes from key-frame qp scaling, and the TPL
            # redistribution applies to the inter frames that reference
            # it (EbInitialRateControlProcess.c:954)
            self._classes = analysis.content_classes(
                frame_src[0], frame_src[1], frame_src[2], self.seq.sb_rows,
                self.seq.sb_cols, cfg.bit_depth)
            self.qmap = self._variance_qmap(frame_src[0])
            # per-lane qindex rides the per-wave loop's decide operands;
            # the fused tile programs take one qindex (the JAX gate)
            self._fused = False
        tile_states = []
        frame_leaves = {}
        self._tile_count = len(rects)
        # several tiles: each tile's analysis defers into one frame-batched
        # program whose step w runs wave w of every tile (the JAX gate)
        self._defer_tiles = [] if self._fused and len(rects) > 1 \
            and not self._no_defer else None
        # the per-wave loop likewise runs wave w of every tile as one step
        # (tiles share no prediction edge, so the lanes are independent)
        self._defer_waves = [] if not self._fused and len(rects) > 1 \
            else None
        for rect in rects:
            mi_r0, mi_c0 = rect[0], rect[1]
            self._enter_tile(frame_src, frame_recon, rect)
            self._analyze_tile()
            st = {k: getattr(self, k) for k in
                  ("src", "recon", "mi_rows", "mi_cols", "sb_rows_t",
                   "sb_cols_t", "max_wh", "leaf_sizes", "leaf_index",
                   "y_mode", "uv_mode", "y_delta", "uv_delta", "alpha_u",
                   "alpha_v", "qcoeff", "eobs", "y_tx_type", "qmap_t")}
            st["rect"] = rect
            tile_states.append(st)
            for (r, c), s in self.leaf_sizes.items():
                frame_leaves[(r + mi_r0, c + mi_c0)] = s
        if self._defer_tiles:
            with span("intra_tiles_fused", tiles=len(self._defer_tiles)):
                frame_recon = device_tile.run_tiles_fused(
                    self, self._defer_tiles, frame_src, frame_recon,
                    common.intra_candidates(cfg))
        self._defer_tiles = None
        if self._defer_waves:
            with span("waves", tiles=len(self._defer_waves)):
                self._wave_loop(self._defer_waves,
                                common.intra_candidates(cfg))
        self._defer_waves = None
        if len(rects) == 1 and isinstance(self.recon[0], torch.Tensor):
            frame_recon = self.recon    # the tile's program kept it there

        self.mi_rows, self.mi_cols = frame_mi_rows, frame_mi_cols
        self.leaf_sizes = frame_leaves
        recon = self._package_compute(frame_src, frame_recon, frame_leaves,
                                      tile_states)
        # restore the whole padded frame (reference slots read enc.recon)
        self.src, self.recon = frame_src, frame_recon
        return recon

    def _enter_tile(self, frame_src, frame_recon, rect) -> None:
        self._cur_rect = rect
        mi_r0, mi_c0, mi_rs, mi_cs, sb_rs, sb_cs = rect
        y0, x0 = mi_r0 * 4, mi_c0 * 4
        ph, pw = sb_rs * 64, sb_cs * 64
        self.src = [frame_src[0][y0:y0 + ph, x0:x0 + pw],
                    frame_src[1][y0 // 2:(y0 + ph) // 2,
                                 x0 // 2:(x0 + pw) // 2],
                    frame_src[2][y0 // 2:(y0 + ph) // 2,
                                 x0 // 2:(x0 + pw) // 2]]
        self.recon = [frame_recon[0][y0:y0 + ph, x0:x0 + pw],
                      frame_recon[1][y0 // 2:(y0 + ph) // 2,
                                     x0 // 2:(x0 + pw) // 2],
                      frame_recon[2][y0 // 2:(y0 + ph) // 2,
                                     x0 // 2:(x0 + pw) // 2]]
        self.mi_rows, self.mi_cols = mi_rs, mi_cs
        self.sb_rows_t, self.sb_cols_t = sb_rs, sb_cs
        self.qmap_t = None
        if self.qmap is not None:
            sr, sc = mi_r0 // 16, mi_c0 // 16
            self.qmap_t = self.qmap[sr:sr + sb_rs, sc:sc + sb_cs]

    def _analyze_tile(self) -> None:
        """Leaf map (partition DP or fixed grid), then the tile's waves:
        deferred into the frame program, or its own fused program, or
        (leaves below 8 px) the per-wave loop."""
        cfg = self.cfg
        self.max_wh = [(self.mi_cols * 4, self.mi_rows * 4),
                       (self.mi_cols * 2, self.mi_rows * 2),
                       (self.mi_cols * 2, self.mi_rows * 2)]

        cands = common.intra_candidates(cfg)
        if cfg.fixed_partition_size is not None:
            self.leaf_sizes = self._fixed_leaf_sizes(cfg.fixed_partition_size)
        else:
            with span("intra_partition_dp"):
                self.leaf_sizes = rd.choose_partition(
                    np.asarray(self.src[0],
                               dtype=common.pixel_dtype(cfg.bit_depth)),
                    cfg, self.mi_cols, self.mi_rows)
        leaves = self._leaves()
        n = len(leaves)
        self.leaf_index = {(r, c): i for i, (r, c, s) in enumerate(leaves)}
        self.y_mode = np.zeros(n, dtype=np.int32)
        self.uv_mode = np.zeros(n, dtype=np.int32)
        self.y_delta = np.zeros(n, dtype=np.int32)
        self.uv_delta = np.zeros(n, dtype=np.int32)
        self.alpha_u = np.zeros(n, dtype=np.int64)
        self.alpha_v = np.zeros(n, dtype=np.int64)
        self.qcoeff = [[None] * n, [None] * n, [None] * n]
        self.eobs = np.zeros((3, n), dtype=np.int32)
        self.y_tx_type = np.zeros(n, dtype=np.int32)
        # neighbour-smoothness maps of the intra edge filter's filt_type,
        # tile-local like every availability rule: luma per mi, chroma
        # per chroma 4 px (2 mi)
        self._sm_y = np.zeros((self.mi_rows, self.mi_cols), dtype=bool)
        self._sm_uv = np.zeros(((self.mi_rows + 1) >> 1,
                                (self.mi_cols + 1) >> 1), dtype=bool)

        if self._fused:
            if self._defer_tiles is not None:
                meta = device_tile.tile_lane_meta(self, cands)
                if meta is not None:
                    self._defer_tiles.append(meta)
                    return
            with span("intra_tile_fused"):
                analyze = self.tile_hook or device_tile.analyze_tile_fused
                if analyze(self, cands):
                    return
                if device_tile.analyze_tile_fused_mixed(self, cands):
                    return
        tile = self._wave_tile(leaves)
        if self._defer_waves is not None:
            self._defer_waves.append(tile)
            return
        with span("waves"):
            self._wave_loop([tile], cands)

    def _wave_tile(self, leaves) -> dict:
        """The current tile as the per-wave loop sees it: its planes and
        pixel bounds, its decision arrays (the same objects the tile's
        state keeps, so the loop's writes land there), its smoothness
        maps, its SB qindex map under adaptive quantization (or None), and
        per leaf its (mi_row, mi_col, w, h), dependency wave, shape key and
        above-right / bottom-left availability."""
        larr = np.array([(r, c, wh[0], wh[1]) for r, c, wh in leaves],
                        dtype=np.int64).reshape(-1, 4)
        vab_all = [avail.leaf_vert_ab(
            self.leaf_sizes, r, c, wh[0] >> 2, wh[1] >> 2,
            self.mi_rows, self.mi_cols) for r, c, wh in leaves]
        tile = {k: getattr(self, k) for k in
                ("src", "recon", "max_wh", "y_mode", "uv_mode", "y_delta",
                 "uv_delta", "alpha_u", "alpha_v", "qcoeff", "eobs",
                 "y_tx_type", "_sm_y", "_sm_uv", "qmap_t")}
        tile.update(
            larr=larr,
            waves=self._dependency_waves(leaves, self.mi_cols, self.mi_rows),
            shape_key=larr[:, 2] * 1000 + larr[:, 3],
            htr=np.array([avail.has_top_right_wh(
                r, c, wh[0] >> 2, wh[1] >> 2, self.mi_cols, vert_ab=vab)
                for (r, c, wh), vab in zip(leaves, vab_all)], dtype=bool),
            hbl=np.array([avail.has_bottom_left_wh(
                r, c, wh[0] >> 2, wh[1] >> 2, self.mi_rows, vert_ab=vab)
                for (r, c, wh), vab in zip(leaves, vab_all)], dtype=bool))
        return tile

    def _wave_loop(self, tiles, cands) -> None:
        """The per-wave loop over ``tiles`` (``_wave_tile`` records): step w
        codes wave w of every tile, one device decide per plane and leaf
        shape over all tiles' lanes of that shape, on host-prepared
        edges."""
        n_waves = max((int(t["waves"].max()) + 1 for t in tiles
                       if len(t["waves"])), default=0)
        for wv in range(n_waves):
            groups = {}
            for t in tiles:
                in_wave = np.nonzero(t["waves"] == wv)[0]
                keys = t["shape_key"][in_wave]
                for sk in np.unique(keys):
                    groups.setdefault(int(sk), []).append(
                        (t, in_wave[keys == sk]))
            for sk in sorted(groups):
                self._code_wave(groups[sk], sk // 1000, sk % 1000, cands)

    def _code_wave(self, parts, bw, bh, cands):
        """Decide and code the leaves of one wave, all bw x bh, given per
        tile as (tile, leaf ids): luma, then U (which picks the chroma
        mode), then V (forced to U's choice), storing the decisions in
        each tile's arrays. Under adaptive quantization every lane carries
        its SB's qindex and lambda (one call covers every AQ group)."""
        lanes = [(t, t["larr"][ids, 1] * 4, t["larr"][ids, 0] * 4,
                  t["htr"][ids], t["hbl"][ids]) for t, ids in parts]
        half = [(t, xs >> 1, ys >> 1, htr, hbl)
                for t, xs, ys, htr, hbl in lanes]
        fty = ftuv = None
        if self._edge:
            rc = [(t["larr"][ids, 0], t["larr"][ids, 1]) for t, ids in parts]
            fty = np.concatenate([_ftype_from(t["_sm_y"], r, c)
                                  for (t, _), (r, c) in zip(parts, rc)])
            ftuv = np.concatenate([_ftype_from(t["_sm_uv"], r >> 1, c >> 1)
                                   for (t, _), (r, c) in zip(parts, rc)])
        qv = lamv = None
        if self.qmap is not None:
            qv = np.concatenate([t["qmap_t"][t["larr"][ids, 0] // 16,
                                             t["larr"][ids, 1] // 16]
                                 for t, ids in parts])
            lamv = rd.lane_lambdas(qv, self.cfg.bit_depth)
        best, bdel, qc, eo, _, ytt = self._wave_compute(
            0, lanes, (bw, bh), cands, ftype=fty, qv=qv, lamv=lamv)
        cfl_luma = None
        if bw <= 32 and bh <= 32:  # cfl_allowed
            cfl_luma = np.concatenate([
                np.stack([t["recon"][0][y:y + bh, x:x + bw]
                          for x, y in zip(xs, ys)])
                for t, xs, ys, _, _ in lanes])
        bestc, cdel, qcc, eoc, au, _ = self._wave_compute(
            1, half, (bw >> 1, bh >> 1), cands, cfl_luma=cfl_luma,
            ftype=ftuv, qv=qv, lamv=lamv)
        _, _, qcv, eov, av, _ = self._wave_compute(
            2, half, (bw >> 1, bh >> 1), cands, forced=(bestc, cdel),
            cfl_luma=cfl_luma, ftype=ftuv, qv=qv, lamv=lamv)
        k0 = 0
        for t, ids in parts:
            sl = slice(k0, k0 + len(ids))
            k0 += len(ids)
            if self._edge:
                rows, cols = t["larr"][ids, 0], t["larr"][ids, 1]
                _mark_smooth(t["_sm_y"], rows, cols, best[sl], bw >> 2,
                             bh >> 2)
                _mark_smooth(t["_sm_uv"], rows >> 1, cols >> 1, bestc[sl],
                             max(1, bw >> 3), max(1, bh >> 3))
            t["y_mode"][ids] = best[sl]
            t["y_delta"][ids] = bdel[sl]
            t["eobs"][0, ids] = eo[sl]
            t["y_tx_type"][ids] = ytt[sl]
            t["uv_mode"][ids] = bestc[sl]
            t["uv_delta"][ids] = cdel[sl]
            t["alpha_u"][ids] = au[sl]
            t["eobs"][1, ids] = eoc[sl]
            t["alpha_v"][ids] = av[sl]
            t["eobs"][2, ids] = eov[sl]
            for k, i in zip(range(sl.start, sl.stop), ids):
                t["qcoeff"][0][i] = qc[k]
                t["qcoeff"][1][i] = qcc[k]
                t["qcoeff"][2][i] = qcv[k]

    def _package_compute(self, frame_src, frame_recon, frame_leaves,
                         tile_states):
        """The in-loop filters on the device (deblocking, then CDEF and LR
        as the config enables them) + display crop. Syntax inputs are
        parked on ``self._pkg`` for ``package_syntax`` — which may run
        later on the encoder's entropy worker, off the compute thread.
        The crop carries no film grain: the Encoder adds it to the
        display output (``Encoder.get_packet``)."""
        cfg = self.cfg
        lf_levels = (0, 0, 0, 0)
        if cfg.enable_dlf:
            with span("dlf"):
                lf_levels = dlf_search_apply_dev(
                    frame_recon, frame_src, frame_leaves, self.mi_rows,
                    self.mi_cols, cfg.base_q_idx, cfg.bit_depth,
                    device=cfg.device)
        self.cdef_idx_map, cdef_kw, self.lr_rinfos, lr_kw = \
            postfilter.run_postfilters(
                cfg, frame_recon, frame_src,
                [(st["leaf_sizes"], st["leaf_index"], st["eobs"],
                  st["rect"][0], st["rect"][1]) for st in tile_states],
                self.mi_rows, self.mi_cols, self.lam)
        recon = [frame_recon[0][:cfg.height, :cfg.width],
                 frame_recon[1][:(cfg.height + 1) // 2,
                                :(cfg.width + 1) // 2],
                 frame_recon[2][:(cfg.height + 1) // 2,
                                :(cfg.width + 1) // 2]]
        self._pkg = dict(tile_states=tile_states, lf_levels=lf_levels,
                         cdef_kw=cdef_kw, lr_kw=lr_kw,
                         frame_src=frame_src, frame_recon=frame_recon)
        return recon

    def package_syntax(self):
        """Per-tile syntax + OBU assembly from the state parked by
        _package_compute. Returns (tu_bytes, stats); sets
        self.final_entropy."""
        cfg = self.cfg
        pkg = self._pkg
        # syntax pass per tile (the entropy stage runs after the filter
        # stages, mirroring the reference pipeline order)
        payloads = []
        for ti, st in enumerate(pkg["tile_states"]):
            for k, v in st.items():
                if k != "rect":
                    setattr(self, k, v)
            self.tile_mi_off = (st["rect"][0], st["rect"][1])
            with span("entropy"):
                payloads.append(self._syntax_pass())
            if ti == 0:
                # context_update_tile_id = 0: the state a decoder saves
                # into every slot this key frame refreshes (spec 6.8.2;
                # adapted unless frame-end update is disabled below)
                tile0_fc = self.fc
        no_end_update = cfg.disable_cdf_update or cfg.error_resilient
        fh = obu.FrameHeader(order_hint=self.order_hint,
                             base_q_idx=cfg.base_q_idx,
                             disable_cdf_update=cfg.disable_cdf_update,
                             disable_frame_end_update_cdf=no_end_update,
                             loop_filter_levels=pkg["lf_levels"],
                             tile_cols_log2=self.tile_log2[0],
                             tile_rows_log2=self.tile_log2[1],
                             delta_q_present=(self.qmap is not None),
                             delta_q_res=self.DELTA_Q_RES,
                             film_grain=self.film_grain,
                             **pkg["cdef_kw"], **pkg["lr_kw"])
        from svt_av1_tpu_torch.entropy import mv as mv_syntax
        self.final_entropy = (
            FrameContext(cfg.base_q_idx) if no_end_update else tile0_fc,
            mv_syntax.NmvContext())
        md_obus = b""
        if cfg.content_light is not None:
            md_obus += obu.write_metadata_hdr_cll(*cfg.content_light)
        if cfg.mastering_display is not None:
            md_obus += obu.write_metadata_hdr_mdcv(*cfg.mastering_display)
        tu = (obu.temporal_delimiter_obu()
              + obu.write_sequence_header_obu(self.seq)
              + md_obus
              + obu.write_frame_obu(self.seq, fh, payloads))
        # per-tile syntax re-bound self.src/recon to tile views; restore
        # the whole padded frame (reference slots read enc.recon)
        self.src = pkg["frame_src"]
        self.recon = pkg["frame_recon"]
        tb = sum(len(t) for t in payloads)
        return tu, {"tile_bytes": tb, "tu_bytes": len(tu)}

    # --- sequential syntax pass ---------------------------------------------------
    def _syntax_pass(self) -> bytes:
        cfg = self.cfg
        self.fc = FrameContext(cfg.base_q_idx)
        self.w = make_symbol_writer(cfg.native_entropy,
                                    cfg.disable_cdf_update)
        self.ctxs = TileContexts(self.mi_cols, self.mi_rows)
        self._cdef_written = set()
        self.lr_ref = [lr_syntax.LrRefState() for _ in range(3)]
        self.cur_qindex = cfg.base_q_idx
        r0, c0 = self.tile_mi_off
        for sb_y in range(0, self.sb_rows_t * 16, 16):
            for sb_x in range(0, self.sb_cols_t * 16, 16):
                self._read_deltas = self.qmap_t is not None
                # the restoration units whose syntax lands at this SB
                lr_syntax.write_sb_units(self.w, self.fc, self.lr_rinfos,
                                         self.lr_ref, sb_y + r0, sb_x + c0,
                                         cfg.width, cfg.height)
                self._emit_partition(sb_y, sb_x, 64)
        return self.w.done()

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
        # per-leaf emission + partition-context update over each leaf's
        # own extent (the reference writes partition_context_lookup per
        # coded block, EbEntropyCoding.c:4762)
        for r, c, wh in leaves:
            self._emit_block(r, c, wh[0] if wh[0] == wh[1] else wh)
            self.ctxs.update_partition_ctx(r, c, common.rect_bsize(*wh),
                                           common.rect_bsize(*wh))

    def _emit_block(self, mi_row, mi_col, size) -> None:
        cfg = self.cfg
        x, y = mi_col * 4, mi_row * 4
        li = self.leaf_index[(mi_row, mi_col)]
        bw, bh = common.leaf_wh(size)
        bsize = common.rect_bsize(bw, bh)
        cw, ch = bw >> 1, bh >> 1
        y_mode = int(self.y_mode[li])
        uv_mode = int(self.uv_mode[li])
        tx_y = common.tx_size_for_rect(bw, bh, 0)
        tx_uv = common.tx_size_for_rect(cw, ch, 1)
        tt_u = common.chroma_tx_type(uv_mode, tx_uv, False)
        skip = int(self.eobs[:, li].sum() == 0)

        mode_syntax.write_skip(self.w, self.fc, self.ctxs, skip,
                               mi_row, mi_col)
        postfilter.write_cdef_idx(self.w, self.cdef_idx_map,
                                  self._cdef_written, mi_row, mi_col,
                                  self.tile_mi_off, skip)
        self._write_delta_q(mi_row, mi_col, size if bw == bh else 0, skip)
        mode_syntax.write_intra_luma_mode_kf(self.w, self.fc, self.ctxs,
                                             y_mode, mi_row, mi_col)
        if intra_dir.is_directional(y_mode):
            mode_syntax.write_angle_delta(self.w, self.fc, y_mode,
                                          int(self.y_delta[li]))
        alpha_u = int(self.alpha_u[li])
        alpha_v = int(self.alpha_v[li])
        if uv_mode == 13 and alpha_u == 0 and alpha_v == 0:
            uv_mode = 0  # alpha-(0,0) CfL == DC prediction; code as DC
        mode_syntax.write_intra_chroma_mode(self.w, self.fc, uv_mode,
                                            y_mode, bw <= 32 and bh <= 32)
        if uv_mode == 13:
            from svt_av1_tpu_torch.ops import cfl as cfl_ops
            cfl_ops.write_cfl_alphas(self.w, self.fc, alpha_u, alpha_v)
        if intra_dir.is_directional(uv_mode):
            mode_syntax.write_angle_delta(self.w, self.fc, uv_mode,
                                          int(self.uv_delta[li]))
        self.ctxs.set_mi(mi_row, mi_col, bsize, y_mode, skip)

        tt_y = int(self.y_tx_type[li])
        plane_info = [(0, x, y, tx_y, tt_y, y_mode, bsize),
                      (1, x >> 1, y >> 1, tx_uv, tt_u, uv_mode,
                       common.rect_bsize(cw, ch)),
                      (2, x >> 1, y >> 1, tx_uv, tt_u, uv_mode,
                       common.rect_bsize(cw, ch))]
        for p, px, py, ts, tt, m, pb in plane_info:
            x4, y4 = px >> 2, py >> 2
            if skip:
                self.ctxs.update_txb_ctx(p, x4, y4, ts, 0)
                continue
            skip_ctx, sign_ctx = self.ctxs.txb_ctx(p, pb, ts, x4, y4)
            cul = coeff_syntax.write_coeffs_txb(
                self.w, self.fc, common.resolve_qc(self.qcoeff[p][li]),
                ts, tt,
                plane_type=int(p > 0), txb_skip_ctx=skip_ctx,
                dc_sign_ctx=sign_ctx, intra_dir=m,
                base_qindex=cfg.base_q_idx)
            self.ctxs.update_txb_ctx(p, x4, y4, ts, cul)


def encode_keyframe_wavefront(y, u, v, cfg: EncoderConfig):
    """One key frame through ``WavefrontIntraEncoder``: (tu_bytes,
    display recon, stats)."""
    return WavefrontIntraEncoder(cfg).encode(y, u, v)


def _ftype_from(sm: np.ndarray, rows: np.ndarray,
                cols: np.ndarray) -> np.ndarray:
    """Per-lane filt_type from a smoothness map (reference get_filt_type:
    above or left neighbour smooth -> 1; unavailable neighbours count as
    non-smooth)."""
    above = np.where(rows > 0, sm[np.maximum(rows - 1, 0), cols], False)
    left = np.where(cols > 0, sm[rows, np.maximum(cols - 1, 0)], False)
    return (above | left).astype(np.int32)


def _mark_smooth(sm: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                 modes: np.ndarray, mw: int, mh: int) -> None:
    """Record SMOOTH-family decisions into a smoothness map over each
    block's extent (``rows``/``cols``/``mw``/``mh`` in the map's units)."""
    for r0, c0, m in zip(rows, cols, modes):
        if intra_dir.is_smooth_mode(int(m)):
            sm[r0:r0 + mh, c0:c0 + mw] = True
