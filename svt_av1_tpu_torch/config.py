"""Encoder configuration of the PyTorch port.

The same fields, defaults and validation as the JAX package's
``EncoderConfig`` (which mirrors the reference's
``EbSvtAv1EncConfiguration``, ``Source/API/EbApi.h:129-494``), except the
compute selector: ``device`` (a torch device string, ``"cuda"`` by default)
takes the place of ``backend``. Entry points run on that device; a
``"cuda"`` config on a machine without a card raises instead of falling
back to the CPU.

The port covers all-intra streams (with the normative intra edge filter
of the directional presets), low-delay P and hierarchical-B random access
(compound prediction, TMVP, the intra-flip pass, and the inter
interpolation-filter and tx-type searches), the in-loop post-filters,
variance and TPL adaptive quantization, VBR rate control with lookahead,
film grain (flat and auto-estimated), source denoising and SATD
partition scoring. ``mesh_shape`` is accepted and read by nothing, as in
the JAX package: the sharded functions of ``parallel/tiles.py`` take
their devices as an argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


class RateControlMode:
    CQP = 0  # constant qindex (reference: EbApi.h:368-374 rate_control_mode=0)
    VBR = 1  # ABR/VBR lookahead model (reference mode 1) — post-MVP


class IntraRefreshType:
    CRA = 1  # open GOP
    IDR = 2  # closed GOP


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Static encoder configuration (frozen: hashable, shareable)."""

    # --- source description -------------------------------------------------
    width: int = 854
    height: int = 480
    bit_depth: int = 8            # 8 or 10 (10-bit path post-MVP)
    frame_rate_num: int = 30
    frame_rate_den: int = 1

    # --- coding structure ----------------------------------------------------
    sb_size: int = 64             # superblock size (64 keeps wavefronts wide;
                                  # SURVEY.md §7.4.2)
    intra_period: int = -1        # -1 = first frame only (all-intra when 0)
    intra_refresh_type: int = IntraRefreshType.IDR
    hierarchical_levels: int = 0  # 0 = flat (inter post-MVP)

    # --- rate control ---------------------------------------------------------
    rate_control_mode: int = RateControlMode.CQP
    qp: int = 40                  # 0..63 CLI-style qp; mapped to qindex
    # per-display-frame qp overrides (reference --use-q-file,
    # EbAppConfig.c:694): entry i replaces frame i's qp; -1 keeps the
    # configured qp; frames beyond the list keep it too. CQP only.
    qp_file: Optional[Tuple[int, ...]] = None
    target_bit_rate: int = 0      # bits/s (VBR mode)
    look_ahead_distance: int = 0  # frames of lookahead for VBR weighting
    qindex_override: Optional[int] = None  # exact qindex (set by RC)
    # CQP qp-scaling: key frames encode at 0.25x the nominal quantizer
    # step, temporal layers at 0.40/0.7/0.85/1.0x (the reference's
    # enable_qp_scaling_flag, default on — EbEncHandle.c:2033,
    # EbRateControlProcess.c:1123-1155). Ignored under rate control or
    # qp-file override.
    enable_qp_scaling: bool = True

    # --- tools ----------------------------------------------------------------
    enable_cdef: bool = False     # post-MVP round work
    enable_restoration: bool = False
    enable_dlf: bool = True
    enable_tx_type_search: bool = False
    # RDOQ-lite: RD-optimal trailing-coefficient trim after quantize
    # (the dominant win of av1_optimize_txb at coarse quantizers; the
    # reference v0.4.0 has no RDOQ). Encoder-side only — streams stay
    # conformant; host and device backends trim with identical integer
    # math (md.rdoq_trim / device_md.rdoq_trim_j).
    enable_rdoq: bool = True
    # Normative intra edge filter + upsample on directional prediction
    # (sequence header enable_intra_edge_filter; reference
    # EbIntraPrediction.c:215/:316 and invocation :8415-8465). Applies
    # to keyframe directional modes (the inter-frame flip candidates
    # are restricted to process-exempt modes when this is on). Default
    # on, like the reference: it is bits-AND-quality positive at every
    # tested qp and the known cause of the coarse-q keyframe BD-rate
    # deficit (round-4 VERDICT missing #4).
    enable_intra_edge_filter: bool = True
    disable_cdf_update: bool = False
    # True: every inter frame is error-resilient (PRIMARY_REF_NONE —
    # contexts reset per frame, any frame loss recoverable). False
    # (default): forward CDF carry — inter frames start from the LAST
    # ref's saved (frame-end-adapted) CDFs and gm params, like the
    # reference's primary_ref_frame path (spec 6.8.2 load_cdfs;
    # ref: EbEntropyCoding.c write_uncompressed_header_obu).
    error_resilient: bool = False
    native_entropy: bool = True   # C range coder (falls back to Python)
    film_grain_strength: int = 0  # 0 off; 1..64 flat strength; -1 auto
    # source denoising before encode (reference enable_denoise_flag,
    # default 0 — EbEncHandle.c:2120): noise-classified weak filtering,
    # frame-based or flat-blocks-only (EbPictureAnalysisProcess.c:3409)
    enable_source_denoise: bool = False
    # HDR metadata OBUs, emitted on keyframe TUs (spec 5.8.3/5.8.4 —
    # the SEI-equivalent side channel; the reference has no SEI path)
    content_light: Optional[Tuple[int, int]] = None      # (max_cll, max_fall)
    mastering_display: Optional[tuple] = None  # (primaries3, wp, max_l, min_l)
    # CICP color description for the sequence header's color_config
    # (reference EbApi.h color description fields; None = unspecified)
    color_primaries: Optional[int] = None
    transfer_characteristics: Optional[int] = None
    matrix_coefficients: Optional[int] = None
    color_range: int = 0
    # qp clamps (reference min_qp_allowed/max_qp_allowed, EbApi.h):
    # bound every per-frame qindex choice (qp scaling, RC, qp-file)
    min_qp_allowed: int = 0
    max_qp_allowed: int = 63
    film_grain_seed: int = 45231  # 16-bit LFSR seed for grain synthesis
    # Full noise-model parameters (ops.grain.FilmGrainParams or its
    # asdict form) — set by auto estimation (film_grain_strength -1) or
    # directly by API users; overrides the flat-strength synthesis.
    film_grain_params: Optional[object] = None

    # --- mode decision budget (static shapes for XLA) --------------------------
    # Intra modes scored in the batched mode decision (all 13 AV1 modes by
    # default; DC must be present). Directional modes additionally sweep
    # angle_deltas (0 = base angle only; spec range -3..3).
    intra_modes: Tuple[int, ...] = tuple(range(13))
    angle_deltas: Tuple[int, ...] = (0,)
    # Full-loop candidates kept after the fast loop (reference NFL,
    # EbProductCodingLoop.c set_nfl:628).
    nfl: int = 3
    # Partition: block sizes the RD search may choose (square, SB..min).
    min_partition_size: int = 8
    max_partition_size: int = 64
    # Uniform partition size when partition RD is off (None = RD search).
    fixed_partition_size: Optional[int] = 16

    # --- compute device ---------------------------------------------------------
    # torch device of the pixel path ("cuda", "cuda:1", or "cpu" for the
    # plain PyTorch versions of every kernel). Streams are byte-identical
    # on every device (integer RD costs).
    device: str = "cuda"

    # --- tiles / parallelism ----------------------------------------------------
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    # Device mesh shape for sharded encode: (data/frames, tiles).
    mesh_shape: Optional[Tuple[int, int]] = None

    # --- misc -------------------------------------------------------------------
    stat_report: bool = True
    recon_enabled: bool = False
    scene_change_detection: bool = True  # auto keyframes on scene cuts
    intra_in_inter: bool = True   # allow intra blocks inside inter frames
    # order hints + temporal MV prediction (seq enable_order_hint /
    # enable_ref_frame_mvs + per-frame use_ref_frame_mvs; spec 7.9)
    enable_tmvp: bool = True
    enable_rect_partitions: bool = True  # HORZ/VERT arms in partition RD
    # keyframe partition DP scoring: SATD of the open-loop intra
    # residual (reference OIS, EbMotionEstimation.c:7419) instead of the
    # full T/Q loop per depth — ~10x cheaper keyframe analysis
    intra_dp_satd: bool = False
    # per-block switchable interpolation filter RD search (REGULAR/
    # SMOOTH/SHARP; reference av1_is_interp_needed +
    # write_mb_interp_filter, EbInterPrediction.c:3523,
    # EbEntropyCoding.c:2024)
    enable_interp_filter_search: bool = False
    # 0 off; 1 = variance AQ; 2 = TPL AQ (MV-propagated lookahead
    # importance on hierarchical inter frames, variance AQ elsewhere)
    adaptive_quantization: int = 0  # 1 = variance AQ (per-SB
                                    # delta qindex, reference QPM)

    def __post_init__(self):
        if self.width % 2 or self.height % 2:
            raise ValueError("4:2:0 requires even dimensions")
        if not (64 <= self.width <= 4096 and 64 <= self.height <= 2304):
            raise ValueError("supported sizes: 64x64..4096x2304 "
                             "(reference: Docs user guide :127-130)")
        if self.bit_depth not in (8, 10):
            raise ValueError("bit_depth must be 8 or 10")
        if not 0 <= self.qp <= 63:
            raise ValueError("qp must be in 0..63")
        if self.sb_size != 64:
            raise ValueError("only 64x64 superblocks supported")
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ValueError("device must be 'cuda[:N]' or 'cpu'")

    # geometry helpers ---------------------------------------------------------
    @property
    def sb_cols(self) -> int:
        return (self.width + self.sb_size - 1) // self.sb_size

    @property
    def sb_rows(self) -> int:
        return (self.height + self.sb_size - 1) // self.sb_size

    @property
    def padded_width(self) -> int:
        return self.sb_cols * self.sb_size

    @property
    def padded_height(self) -> int:
        return self.sb_rows * self.sb_size

    @property
    def base_q_idx(self) -> int:
        """Map CLI-style qp (0..63) to an AV1 qindex (0..255).

        The reference maps qp via quantizer_to_qindex (4*qp clamped); we use
        the same convention so ``-q 40`` operating points line up. A rate
        controller sets ``qindex_override`` for exact per-frame control.
        """
        if self.qindex_override is not None:
            return self.qindex_override
        return min(255, self.qp * 4)

