"""Top-level encoder of the port: GOP structure, reference management and
the streaming API.

The port of the JAX package's ``pipeline/encoder.py``: the reference's
public lifecycle (``EbApi.h:505-592``: init → send_picture → get_packet →
flush) and its PictureDecision mini-GOP assembly
(``EbPictureDecisionProcess.c:816``). Frames arrive in display order; with
``hierarchical_levels`` > 0 they are re-ordered into a hierarchical-B
pyramid (anchor coded first, not shown; middles reference past and future
anchors; display via show_existing_frame), otherwise a low-delay KEY + P
chain. CQP qp-scaling sets each frame's quantizer by temporal layer; VBR
rate control (``pipeline/rc.py``) sets it from the coded bits and a
lookahead window instead. The encoder also runs the stream-level tools:
source denoising, the lookahead queue, TPL adaptive quantization over each
mini-GOP, film grain (its parameters in the headers, the noise added to
the display output only) and checkpoints (``save_state`` /
``load_state``).

Host entropy runs on one ordered worker thread while the next frames
compute on the device: jobs run in submission order, so the CDF-carry
chain, and the bytes, equal a serial run's.
"""

from __future__ import annotations

import copy
import dataclasses
import io
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional

import numpy as np
import torch

from svt_av1_tpu_torch.bitstream import obu
from svt_av1_tpu_torch.bitstream.ivf import (patch_ivf_frame_count,
                                             write_ivf_frame,
                                             write_ivf_header)
from svt_av1_tpu_torch.config import EncoderConfig, RateControlMode
from svt_av1_tpu_torch.entropy.inter_modes import (ALTREF2_FRAME,
                                                   GOLDEN_FRAME, LAST2_FRAME)
from svt_av1_tpu_torch.ops import grain as grain_ops
from svt_av1_tpu_torch.ops import step_graphs
from svt_av1_tpu_torch.pipeline import analysis, common, tmvp
from svt_av1_tpu_torch.pipeline.common import pad_to_multiple
from svt_av1_tpu_torch.pipeline.inter import InterFrameEncoder
from svt_av1_tpu_torch.pipeline.rc import RateControl
from svt_av1_tpu_torch.pipeline.scd import SceneChangeDetector, luma_stats
from svt_av1_tpu_torch.pipeline.wavefront import WavefrontIntraEncoder
from svt_av1_tpu_torch.utils.trace import setup_step, span


def check_device(device: str) -> torch.device:
    """The torch device of a config; a CUDA device without a card raises
    (there is no CPU fallback: ask for ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


class Encoder:
    """Streaming encoder: send_picture / get_packet semantics.

    get_packet returns (tu_bytes, display_recon_or_None): a None recon
    means the TU coded a non-shown frame (its display arrives later via a
    show_existing TU)."""

    # CQP qp-scaling quantizer-step ratios per temporal layer (the
    # reference's delta_rate_new, EbRateControlProcess.c:1143; key
    # frames target 0.25x the nominal step, EbRateControlProcess.c:1129)
    QPS_KEY_RATIO = 0.25
    QPS_LAYER_RATIO = (0.40, 0.7, 0.85, 1.0, 1.0, 1.0)

    # how many frames of host entropy may trail the compute front. CQP
    # qindex choices do not depend on coded bits, so the bound is memory:
    # each in-flight frame holds its coefficient copies. Under rate
    # control every frame's bits reach the controller before the next
    # frame's qindex is chosen (depth 0), as in the JAX package's host
    # backend, whose streams are the reference: the feedback is applied
    # in submission order and never depends on the worker's speed.
    SYNTAX_DEPTH = 4
    SYNTAX_DEPTH_RC = 0

    @setup_step("encoder_init")
    def __init__(self, cfg: EncoderConfig, shape_group_issue=None):
        """``shape_group_issue``: a drop-in for
        ``ops.device_inter.shape_group_issue`` that every inter frame of
        this encoder issues its shape groups through (the strip-sharded
        one of ``parallel/tiles.py``); None keeps the module's."""
        assert cfg.hierarchical_levels <= 5, \
            "pyramid depth capped at 5 (reference MAX_HIERARCHICAL_LEVELS)"
        check_device(cfg.device)
        self.cfg = cfg
        self._shape_group_issue = shape_group_issue
        self.seq = common.sequence_header(cfg)
        # film grain synthesis parameters (display output only)
        self._grain = grain_ops.resolved_params(cfg) \
            if self.seq.film_grain_params_present else None
        self._slots = [None] * 8   # padded recon per slot (host or device)
        # the slots' prepared references (padding + HME pyramid), shared
        # by every inter frame of the stream
        self._ref_cache = {}
        # per-slot saved entropy state (FrameContext, NmvContext) and gm
        # params — the decoder-side SavedCdfs/SavedGmParams stores that
        # primary_ref_frame CDF carry reads from (spec 6.8.2)
        self._slot_entropy = [None] * 8
        self._slot_gm = [((0, 0),) * 7] * 8
        # per-slot TMVP facts (order hint, that frame's ref hints, its
        # 8x8 motion field) — the encoder-side mirror of the decoder's
        # slot_info store
        self._slot_info = [None] * 8
        self._syntax_pool = None
        self._syntax_pending: List = []  # [(future, is_key, layer)]
        self._base_slot = 0        # slot of the most recent past anchor
        self._golden_slot = 7      # slot of the last keyframe (GOLDEN)
        self._ld_last2 = None      # low-delay: slot of the frame before LAST
        self._frame_idx = 0        # display-order index of next input
        self._key_disp = 0         # display index of the last keyframe
        self._group: List[tuple] = []
        self._out: List = []       # [(bytes or future, recon or None)]
        self._scd = SceneChangeDetector() \
            if cfg.scene_change_detection else None
        # lookahead queue [(y, u, v, complexity, histogram)], the last
        # queued decimated luma, and the head frame's complexity weight
        self._la: List[tuple] = []
        self._la_prev = None
        self._la_weight = 1.0
        self._prev_luma = None       # previous coded source luma (AQ hint)
        # the key frames' class-step runner: CUDA graphs and buffers of
        # this encoder alone (ops/step_graphs.py)
        self._class_graphs = step_graphs.ClassGraphs()
        self._tpl_prev_luma = None   # the luma the next mini-GOP refs
        self._tpl_maps = {}          # display index -> TPL offset map
        self._rc = None
        if cfg.rate_control_mode == RateControlMode.VBR \
                and cfg.target_bit_rate > 0:
            self._rc = RateControl(cfg.target_bit_rate,
                                   cfg.frame_rate_num / cfg.frame_rate_den,
                                   cfg.intra_period,
                                   start_qindex=cfg.base_q_idx,
                                   hierarchical_levels=cfg.hierarchical_levels)

    # --- internals -----------------------------------------------------------
    def _cfg_for(self, is_key: bool, layer: int = 0) -> EncoderConfig:
        cfg = self.cfg
        if self._rc is not None:
            cfg = dataclasses.replace(
                cfg, qindex_override=self._rc.frame_qindex(
                    is_key, self._la_weight, layer))
        elif cfg.enable_qp_scaling and cfg.qindex_override is None:
            from svt_av1_tpu_torch.ops.quant import qindex_for_qstep_scale
            ratio = self.QPS_KEY_RATIO if is_key else \
                self.QPS_LAYER_RATIO[min(layer,
                                         len(self.QPS_LAYER_RATIO) - 1)]
            if ratio < 1.0:
                cfg = dataclasses.replace(
                    cfg, qindex_override=qindex_for_qstep_scale(
                        cfg.base_q_idx, ratio, cfg.bit_depth))
        if cfg.qindex_override is not None and (
                cfg.min_qp_allowed > 0 or cfg.max_qp_allowed < 63):
            # reference min_qp_allowed/max_qp_allowed clamps (CLIP3 at
            # every per-frame qp assignment, EbRateControlProcess.c)
            cfg = dataclasses.replace(cfg, qindex_override=int(np.clip(
                cfg.qindex_override, max(1, cfg.min_qp_allowed * 4),
                cfg.max_qp_allowed * 4)))
        return cfg

    def _qp_file_qp(self, disp_idx):
        """qp-file override for display frame ``disp_idx`` or None
        (reference --use-q-file semantics: value replaces the frame qp,
        -1/absent keeps it; ignored under rate control)."""
        qf = self.cfg.qp_file
        if (qf is None or disp_idx is None or self._rc is not None
                or disp_idx >= len(qf) or qf[disp_idx] < 0):
            return None
        return int(qf[disp_idx])

    def _crop(self, padded):
        cfg = self.cfg
        return [padded[0][:cfg.height, :cfg.width],
                padded[1][:(cfg.height + 1) // 2, :(cfg.width + 1) // 2],
                padded[2][:(cfg.height + 1) // 2, :(cfg.width + 1) // 2]]

    def _aq_prev(self, y):
        """Previous coded source luma, padded like this frame (the
        variance AQ's temporal hint); updates the tracker."""
        prev = self._prev_luma
        self._prev_luma = pad_to_multiple(y, 64)
        return prev

    def _submit(self, job, is_key: bool, layer: int = 0):
        """Queue a syntax job on the ordered entropy worker; keep at most
        SYNTAX_DEPTH (under rate control SYNTAX_DEPTH_RC) jobs in
        flight."""
        if self._syntax_pool is None:
            self._syntax_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="entropy")
        fut = self._syntax_pool.submit(job)
        self._syntax_pending.append((fut, is_key, layer))
        depth = self.SYNTAX_DEPTH if self._rc is None \
            else self.SYNTAX_DEPTH_RC
        while len(self._syntax_pending) > depth:
            self._reap_one()
        return fut

    def _reap_one(self) -> None:
        """Join the oldest in-flight entropy job and feed its bits to the
        rate controller (join order is submission order, so the updates
        run in coding order)."""
        fut, is_key, layer = self._syntax_pending.pop(0)
        with span("entropy_wait"):
            tu = fut.result()
        if self._rc is not None:
            self._rc.update(len(tu) * 8, is_key, layer)

    def _join_syntax(self) -> None:
        """Wait for all in-flight entropy jobs (in submission order)."""
        while self._syntax_pending:
            self._reap_one()

    def _encode_key(self, y, u, v, disp_idx: int) -> None:
        self._join_syntax()
        cfg = self._cfg_for(True)
        qv = self._qp_file_qp(disp_idx)
        if qv is not None:
            cfg = dataclasses.replace(cfg, qp=qv, qindex_override=None)
        enc = WavefrontIntraEncoder(cfg, film_grain=self._grain)
        enc.class_graphs = self._class_graphs
        enc.aq_prev_luma = self._aq_prev(y)
        self._key_disp = disp_idx
        hint = 0
        enc.order_hint = hint
        with span("keyframe"):
            recon = enc.encode_compute(y, u, v)
        for i in range(8):
            self._slots[i] = enc.recon
            self._slot_gm[i] = ((0, 0),) * 7
            self._slot_info[i] = tmvp.SlotInfo(order_hint=hint,
                                               is_intra=True)
        self._base_slot = 0
        self._golden_slot = 7
        self._ld_last2 = None
        if self.cfg.adaptive_quantization == 2:
            self._tpl_prev_luma = y   # the anchor the next mini-GOP refs

        # keyframe host entropy runs on the ordered syntax worker while
        # the next frames compute. The slot entropy stores are written
        # inside the job; only later syntax jobs read them, and the
        # single worker serializes those after this one.
        def key_syntax_job(enc=enc):
            tu, _ = enc.package_syntax()
            for i in range(8):
                self._slot_entropy[i] = enc.final_entropy
            return tu

        self._out.append((self._submit(key_syntax_job, True), recon))

    def _encode_inter(self, y, u, v, last_slot, alt_slot, refresh_slot,
                      show, layer: int = 0, extra_slots=None,
                      disp_idx=None) -> list:
        """Encode one inter frame; returns its padded recon (on the
        device). refresh_slot None = non-reference frame
        (refresh_frame_flags 0, the leaf-B case of the hierarchical
        pyramid). layer: temporal layer (pyramid level; 0 = anchor/P):
        under rate control the controller's per-layer budget, else the
        qp-scaling step (or, with qp scaling off, a fixed +12 qindex per
        layer). extra_slots: {ref_id: slot} additional
        named references; a slot whose content is the same object as an
        already-chosen ref is dropped."""
        cfg = self._cfg_for(False, layer)
        if layer and self._rc is None and not self.cfg.enable_qp_scaling:
            cfg = dataclasses.replace(
                cfg, qindex_override=int(np.clip(
                    cfg.base_q_idx + 12 * layer, 1, 255)))
        qv = self._qp_file_qp(disp_idx)
        if qv is not None:   # qp-file pins the frame qp exactly
            cfg = dataclasses.replace(cfg, qp=qv, qindex_override=None)
        enc = InterFrameEncoder(cfg, self.seq, self._ref_cache,
                                film_grain=self._grain)
        enc.aq_prev_luma = self._aq_prev(y)
        enc.tpl_qmap = self._tpl_maps.get(disp_idx)
        enc.shape_group_issue = self._shape_group_issue
        idx = [last_slot] * 7
        alt = None
        used = [self._slots[last_slot]]
        if alt_slot is not None:
            idx[6] = alt_slot
            alt = self._slots[alt_slot]
            used.append(alt)
        extra = {}
        for rid, slot in (extra_slots or {}).items():
            if slot is None:
                continue
            planes = self._slots[slot]
            if planes is None or any(planes is u_ for u_ in used):
                continue
            idx[rid - 1] = slot
            extra[rid] = planes
            used.append(planes)
        rff = 0 if refresh_slot is None else 1 << refresh_slot
        # temporal MV context: current hint, per-slot hints, projected
        # field from the slot stores (the decoder rebuilds the same from
        # its own slots — spec 7.9). Slot TMVP/gm stores are refreshed on
        # this thread right after each frame's compute, so no in-flight
        # syntax job is ever waited on here.
        hint = ((disp_idx or 0) - self._key_disp) & 127
        bits = self.seq.order_hint_bits
        slot_hints = tuple(si.order_hint if si is not None else 0
                           for si in self._slot_info)
        named_hints = [slot_hints[idx[r - 1]] for r in range(1, 8)]
        rel_dist = [0] * 8       # dist(cur, ref) per named ref
        sign_bias = [0] * 8
        for r in range(1, 8):
            rel_dist[r] = obu.get_relative_dist(hint, named_hints[r - 1],
                                                bits)
            sign_bias[r] = int(obu.get_relative_dist(named_hints[r - 1],
                                                     hint, bits) > 0)
        use_tmvp = (self.seq.enable_ref_frame_mvs
                    and not cfg.error_resilient)
        tpl = None
        if use_tmvp:
            with span("tmvp_build"):
                tpl = tmvp.build_tpl_field(self.seq.mi_rows,
                                           self.seq.mi_cols, hint, idx,
                                           self._slot_info, bits)
        with span("inter_frame"):
            enc.tmvp_ctx = dict(order_hint=hint,
                                ref_order_hints=slot_hints,
                                use=use_tmvp, tpl=tpl,
                                rel_dist=rel_dist, sign_bias=sign_bias)
            padded = enc.encode_compute(
                y, u, v, self._slots[last_slot], alt_planes=alt,
                refresh_frame_flags=rff, ref_frame_idx=idx,
                show_frame=show, extra_refs=extra)
        if refresh_slot is not None:
            # every slot store a LATER frame's compute may read is
            # refreshed here, straight from the decisions — syntax owns
            # only the entropy store (read exclusively by later syntax
            # jobs, which the single ordered worker runs after this one)
            self._slots[refresh_slot] = padded
            self._slot_gm[refresh_slot] = tuple(
                enc.gm_mv.get(ref, (0, 0)) for ref in range(1, 8))
            fr, fm = tmvp.save_motion_field(
                tmvp.field_state_from_decisions(enc),
                [-d for d in rel_dist])
            self._slot_info[refresh_slot] = tmvp.SlotInfo(
                order_hint=hint,
                ref_order_hints=tuple(named_hints),
                is_intra=False, field_ref=fr, field_mv=fm)
        # gm prediction base for the frame header: captured now — a later
        # frame may refresh this slot's gm store before the worker runs
        # this frame's job
        prev_gm_val = self._slot_gm[last_slot]

        def syntax_job(enc=enc, last=last_slot, refresh=refresh_slot,
                       prev_gm=prev_gm_val):
            tu = enc.encode_syntax(self._slot_entropy[last], prev_gm)
            if refresh is not None:
                self._slot_entropy[refresh] = enc.final_entropy
            return tu

        self._out.append((self._submit(syntax_job, False, layer),
                          self._crop(padded) if show else None))
        return padded

    def _flush_group(self) -> None:
        """Encode the buffered mini-GOP as a hierarchical pyramid with
        interleaved display (decode order = the reference RA pattern:
        anchor first, then an in-order traversal where leaf Bs are coded
        shown with refresh_frame_flags 0 and interior Bs surface later
        via show_existing_frame)."""
        group = self._group
        self._group = []
        if not group:
            return
        g = len(group)
        self._tpl_maps = {}
        if self.cfg.adaptive_quantization == 2:
            # MV-propagated TPL over the mini-GOP window (display order):
            # areas that later frames predict from get finer quantization
            # (InitialRateControl TPL, EbInitialRateControlProcess.c:954)
            with span("tpl"):
                maps = analysis.tpl_group_qmaps(
                    [e[1] for e in group], self.cfg.base_q_idx,
                    InterFrameEncoder.DELTA_Q_RES, self.seq.sb_rows,
                    self.seq.sb_cols, prev_luma=self._tpl_prev_luma)
            self._tpl_maps = {e[0]: m for e, m in zip(group, maps)}
            self._tpl_prev_luma = group[-1][1]
        base = self._base_slot
        anchor_slot = 1 if base != 1 else 2
        golden = self._golden_slot
        free = [s for s in range(8)
                if s not in (base, anchor_slot, golden)]
        adi, ay, au, av = group[-1]
        # multi-ref lists (Av1GenerateRpsInfo analogue): every frame also
        # sees the GOP's base anchor (GOLDEN, long-term past) and the
        # GOP-end anchor (ALTREF2, far future) beyond its nearest pair
        self._encode_inter(ay, au, av, base, None, anchor_slot,
                           show=(g == 1),
                           extra_slots={GOLDEN_FRAME: golden},
                           disp_idx=adi)

        def rec(lo_idx, hi_idx, lo_slot, hi_slot, level):
            """Code + display frames lo_idx+1 .. hi_idx-1 in display
            order; slots are released once a subtree is displayed."""
            if hi_idx - lo_idx <= 1:
                return
            extra = {GOLDEN_FRAME: base if lo_slot != base else golden,
                     ALTREF2_FRAME: anchor_slot}
            mid = (lo_idx + hi_idx) // 2
            mdi, my, mu, mv_ = group[mid]
            if hi_idx - lo_idx == 2:
                # leaf B: nothing references it -> code it shown directly
                self._encode_inter(my, mu, mv_, lo_slot, hi_slot, None,
                                   show=True, layer=level,
                                   extra_slots=extra, disp_idx=mdi)
                return
            s = free.pop(0)
            self._encode_inter(my, mu, mv_, lo_slot, hi_slot, s,
                               show=False, layer=level,
                               extra_slots=extra, disp_idx=mdi)
            rec(lo_idx, mid, lo_slot, s, level + 1)
            self._out.append((obu.show_existing_frame_tu(s),
                              self._crop(self._slots[s])))
            rec(mid, hi_idx, s, hi_slot, level + 1)
            free.append(s)

        rec(-1, g - 1, base, anchor_slot, 1)
        if g > 1:
            self._out.append((obu.show_existing_frame_tu(anchor_slot),
                              self._crop(self._slots[anchor_slot])))
        self._base_slot = anchor_slot

    def _is_key(self, idx: int) -> bool:
        period = self.cfg.intra_period
        if idx == 0:
            return True
        if period < 0:
            return False
        if period == 0:
            return True
        return idx % (period + 1) == 0

    def _encode_one(self, y, u, v) -> None:
        cfg = self.cfg
        is_key = self._is_key(self._frame_idx)
        if self._scd is not None:
            with span("scd"):
                if self._scd.is_scene_change(y):
                    is_key = True  # CRA/IDR on detected scene cut
        self._frame_idx += 1
        disp = self._frame_idx - 1
        if cfg.hierarchical_levels == 0:
            if is_key:
                self._encode_key(y, u, v, disp_idx=disp)
            else:
                # low-delay P: LAST/LAST2 rotate through slots 0 and 1,
                # GOLDEN pins the last keyframe (slot 7) — the reference's
                # LDP ref list (Av1GenerateRpsInfo low-delay branch)
                prev = self._base_slot
                refresh = 1 - prev if prev in (0, 1) else 0
                extra = {GOLDEN_FRAME: self._golden_slot}
                if self._ld_last2 is not None:
                    extra[LAST2_FRAME] = self._ld_last2
                self._encode_inter(y, u, v, prev, None, refresh,
                                   show=True, extra_slots=extra,
                                   disp_idx=disp)
                self._ld_last2 = prev
                self._base_slot = refresh
            return
        if is_key:
            self._flush_group()
            self._encode_key(y, u, v, disp_idx=disp)
            return
        self._group.append((disp, y, u, v))
        if len(self._group) == (1 << cfg.hierarchical_levels):
            self._flush_group()

    # --- public ---------------------------------------------------------------
    def _resolve_auto_grain(self, y) -> None:
        """film_grain_strength -1: the full noise model estimated from
        the first frame (an AR fit and per-intensity scaling points),
        carried in the config so every frame header sends the same
        parameters."""
        params = analysis.estimate_grain_params(
            y, self.cfg.bit_depth, seed=self.cfg.film_grain_seed)
        use = params.apply_grain
        self.cfg = dataclasses.replace(
            self.cfg, film_grain_strength=0,
            film_grain_params=params if use else None)
        self.seq.film_grain_params_present = use
        self._grain = params if use else None

    def send_picture(self, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> None:
        """Accept one frame (display order). Denoising, when on, comes
        first; under rate control with lookahead a frame is encoded once
        its complexity window has filled (the InitialRateControl
        lookahead)."""
        if self.cfg.film_grain_strength == -1:
            self._resolve_auto_grain(y)
        if self.cfg.enable_source_denoise:
            with span("denoise"):
                nc = analysis.classify_picture_noise(y)
                y, u, v = analysis.denoise_source(y, u, v, nc, self.cfg.qp)
        lad = self.cfg.look_ahead_distance
        if lad > 0 and self._rc is not None:
            # the decimated-luma histogram rides the lookahead so the
            # drain can spot in-window scene cuts
            d, hist = luma_stats(y)
            c = 1.0
            if self._la_prev is not None and self._la_prev.shape == d.shape:
                c = float(np.mean(np.abs(
                    d.astype(np.int32) - self._la_prev.astype(np.int32))))
                # a frame never costs more than its open-loop intra
                # estimate (OIS feeding InitialRateControl,
                # EbMotionEstimation.c:7419); both per-pixel SAD scale
                ois = analysis.ois_intra_cost(d)
                if ois.size:
                    c = min(c, float(ois.mean()) / 256.0)
            self._la_prev = d
            self._la.append((y, u, v, max(c, 1e-3), hist))
            if len(self._la) > lad:
                self._drain_lookahead()
            return
        self._encode_one(y, u, v)

    def _drain_lookahead(self, all_frames: bool = False) -> None:
        """Encode queued frames, each with its complexity window (cut at
        the first in-window scene cut) as the controller's lookahead."""
        while self._la and (all_frames or len(self._la) >
                            self.cfg.look_ahead_distance):
            y, u, v, c, hist = self._la.pop(0)
            window = [c] + [e[3] for e in self._la]
            cut = analysis.histogram_cut_index(
                [hist] + [e[4] for e in self._la])
            if cut is not None:
                window = window[:cut]
            self._la_weight = c / max(np.mean(window), 1e-3)
            if self._rc is not None:
                self._rc.set_lookahead(window)
            self._encode_one(y, u, v)
            self._la_weight = 1.0

    def flush(self) -> None:
        """End of stream: encode any buffered frames, wait for the
        entropy worker, then stop it."""
        self._drain_lookahead(all_frames=True)
        self._flush_group()
        self._join_syntax()
        if self._syntax_pool is not None:
            self._syntax_pool.shutdown()
            self._syntax_pool = None

    # --- checkpoints ------------------------------------------------------------
    def save_state(self) -> dict:
        """Serializable encoder state between frames: reference slots (as
        numpy, so a checkpoint resumes on any device), entropy and TMVP
        slot stores, the GOP buffer, the rate-control, lookahead and
        scene-detector state. The JAX package's ``save_state`` layout
        (version 3): ``convert.state_from_jax`` maps its dicts onto this.
        Packets not yet taken with ``get_packet`` stay queued.

        The adaptive-quantization history (the previous source luma of
        the variance AQ, the TPL anchor luma and the TPL maps) is not
        saved, as in the JAX package: under ``adaptive_quantization`` a
        resumed stream equals the JAX package's resumed stream, not the
        uninterrupted one."""
        self._join_syntax()
        self._out = [(tu if isinstance(tu, bytes) else tu.result(), rec)
                     for tu, rec in self._out]
        # slots are saved with their aliasing (after a key frame all 8
        # share one recon): the multi-ref dedup keys on object identity,
        # so the resumed stream needs the same sharing
        uniq, alias = _shared(self._slots, lambda sl: [
            p.cpu().numpy().copy() if isinstance(p, torch.Tensor)
            else p.copy() for p in sl])
        euniq, ealias = _shared(self._slot_entropy,
                                lambda e: (e[0].copy(), e[1].copy()))
        return {
            "version": 3,
            "cfg": dataclasses.asdict(self.cfg),
            "slots_uniq": uniq,
            "slots_alias": alias,
            "entropy_uniq": euniq,
            "entropy_alias": ealias,
            "slot_gm": list(self._slot_gm),
            "slot_info": [
                None if si is None else {
                    "order_hint": si.order_hint,
                    "ref_order_hints": tuple(si.ref_order_hints),
                    "is_intra": si.is_intra,
                    "field_ref": None if si.field_ref is None
                    else si.field_ref.copy(),
                    "field_mv": None if si.field_mv is None
                    else si.field_mv.copy(),
                } for si in self._slot_info],
            "base_slot": self._base_slot,
            "golden_slot": self._golden_slot,
            "ld_last2": self._ld_last2,
            "frame_idx": self._frame_idx,
            "key_disp": self._key_disp,
            "group": copy.deepcopy(self._group),
            "la": copy.deepcopy(self._la),
            "la_prev": None if self._la_prev is None
            else self._la_prev.copy(),
            # deep copies: the controller updates its per-layer list in
            # place, which must not reach a checkpoint already taken
            "rc": None if self._rc is None
            else copy.deepcopy(self._rc.__dict__),
            "scd": None if self._scd is None
            else copy.deepcopy(self._scd.__dict__),
        }

    @classmethod
    def load_state(cls, state: dict, device: Optional[str] = None
                   ) -> "Encoder":
        """Rebuild an Encoder mid-stream from ``save_state()`` output;
        ``device`` (default: the saved config's) may differ from the
        device the checkpoint was taken on."""
        assert state.get("version") == 3  # display-indexed group entries
        kw = dict(state["cfg"])
        if device is not None:
            kw["device"] = device
        enc = cls(EncoderConfig(**kw))
        uniq = [[p.copy() for p in sl] for sl in state["slots_uniq"]]
        enc._slots = [None if a is None else uniq[a]
                      for a in state["slots_alias"]]
        euniq = [(e[0].copy(), e[1].copy()) for e in state["entropy_uniq"]]
        enc._slot_entropy = [None if a is None else euniq[a]
                             for a in state["entropy_alias"]]
        enc._slot_gm = [tuple(map(tuple, g)) for g in state["slot_gm"]]
        enc._slot_info = [None if d is None else tmvp.SlotInfo(**d)
                          for d in state["slot_info"]]
        enc._base_slot = state["base_slot"]
        enc._golden_slot = state["golden_slot"]
        enc._ld_last2 = state["ld_last2"]
        enc._frame_idx = state["frame_idx"]
        enc._key_disp = state["key_disp"]
        enc._group = list(state["group"])
        enc._la = list(state["la"])
        enc._la_prev = state["la_prev"]
        if state["rc"] is not None:
            enc._rc.__dict__.update(copy.deepcopy(state["rc"]))
        if state["scd"] is not None and enc._scd is not None:
            enc._scd.__dict__.update(copy.deepcopy(state["scd"]))
        return enc

    def get_packet(self):
        if not self._out:
            return None
        tu, recon = self._out.pop(0)
        if not isinstance(tu, bytes):   # pending entropy job
            with span("entropy_wait"):
                tu = tu.result()
        if recon is not None:
            with span("recon_fetch"):
                recon = [p.cpu().numpy() if isinstance(p, torch.Tensor)
                         else p for p in recon]
            if self._grain is not None:
                # display-path grain only: reference slots stay grain-free
                # (spec 7.18.3 applies grain after output;
                # grainSynthesis.c:1174)
                with span("grain"):
                    recon = grain_ops.apply_grain(recon, self._grain,
                                                  self.cfg.bit_depth)
        return tu, recon


def _shared(items, copy_fn):
    """(copies of the distinct objects among ``items``, per item the index
    of its copy or None): objects that several items share are stored
    once, so a loader can restore the sharing."""
    uniq, alias, seen = [], [], {}
    for it in items:
        if it is None:
            alias.append(None)
            continue
        if id(it) not in seen:
            seen[id(it)] = len(uniq)
            uniq.append(copy_fn(it))
        alias.append(seen[id(it)])
    return uniq, alias


def encode_ivf(frames: Iterable[tuple], cfg: EncoderConfig,
               shape_group_issue=None) -> bytes:
    """Encode an iterable of (y, u, v) frames to an IVF byte stream
    (``shape_group_issue``: see ``Encoder``)."""
    enc = Encoder(cfg, shape_group_issue=shape_group_issue)
    buf = io.BytesIO()
    frames = list(frames)
    write_ivf_header(buf, cfg.width, cfg.height, cfg.frame_rate_num,
                     cfg.frame_rate_den, len(frames))
    n = 0
    for f in frames:
        enc.send_picture(*f)
        while (pkt := enc.get_packet()) is not None:
            write_ivf_frame(buf, pkt[0], n)
            n += 1
    enc.flush()
    while (pkt := enc.get_packet()) is not None:
        write_ivf_frame(buf, pkt[0], n)
        n += 1
    patch_ivf_frame_count(buf, n)
    return buf.getvalue()
