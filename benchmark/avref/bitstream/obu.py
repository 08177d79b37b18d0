"""OBU framing and the sequence and frame header parsers (AV1 spec 5.5
sequence header, 5.9 frame header, 5.11 tile group).

Scope: a single operating point, no superres, no frame-id numbers, 4:2:0.
A stream that enables film grain is refused: no configuration states it.
"""

from __future__ import annotations

import dataclasses

from benchmark.avref.bitstream.bitio import BitReader, read_uleb128

# OBU types (spec 6.2.2)
OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7
OBU_PADDING = 15

# frame types (spec 6.8.2)
KEY_FRAME = 0
INTER_FRAME = 1
INTRA_ONLY_FRAME = 2
SWITCH_FRAME = 3

PRIMARY_REF_NONE = 7
NUM_REF_FRAMES = 8

# (seq_level_idx, max_h, max_v, max_pic_size) — AV1 levels annex A.3
_LEVELS = [(0, 2048, 1152, 147456), (1, 2816, 1584, 278784),
           (4, 4352, 2448, 665856), (5, 5504, 3096, 1065024),
           (8, 6144, 3456, 2359296), (12, 8192, 4352, 8912896),
           (13, 8192, 4352, 8912896), (14, 8192, 4352, 8912896)]


@dataclasses.dataclass
class SequenceHeader:
    """Sequence-level state shared by writer, encoder, and decoder."""
    width: int
    height: int
    bit_depth: int = 8
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_order_hint: bool = False
    order_hint_bits: int = 0
    enable_ref_frame_mvs: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    enable_superres: bool = False
    film_grain_params_present: bool = False
    seq_profile: int = 0
    still_picture: bool = False
    # color_config (spec 5.5.2): CICP code points (ISO 23091-4); None =
    # color_description_present_flag 0 (unspecified)
    color_primaries: int = None
    transfer_characteristics: int = None
    matrix_coefficients: int = None
    color_range: int = 0          # 0 studio swing, 1 full swing

    @property
    def frame_width_bits(self) -> int:
        return max(1, (self.width - 1).bit_length())

    @property
    def frame_height_bits(self) -> int:
        return max(1, (self.height - 1).bit_length())

    @property
    def sb_size(self) -> int:
        return 128 if self.use_128x128_superblock else 64

    @property
    def mi_cols(self) -> int:
        return 2 * ((self.width + 7) >> 3)

    @property
    def mi_rows(self) -> int:
        return 2 * ((self.height + 7) >> 3)

    @property
    def sb_cols(self) -> int:
        shift = 5 if self.use_128x128_superblock else 4
        return (self.mi_cols + (1 << shift) - 1) >> shift

    @property
    def sb_rows(self) -> int:
        shift = 5 if self.use_128x128_superblock else 4
        return (self.mi_rows + (1 << shift) - 1) >> shift


@dataclasses.dataclass
class FrameHeader:
    """Per-frame header state (subset actually signaled by the MVP writer)."""
    frame_type: int = KEY_FRAME
    show_frame: bool = True
    base_q_idx: int = 40
    disable_cdf_update: bool = False
    disable_frame_end_update_cdf: bool = True
    tx_mode_select: bool = False      # False = TX_MODE_LARGEST
    reduced_tx_set: bool = False
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    loop_filter_levels: tuple = (0, 0, 0, 0)
    refresh_frame_flags: int = 0xFF
    order_hint: int = 0
    # inter-frame fields
    error_resilient: bool = True    # True: PRIMARY_REF_NONE per frame
    # forward CDF carry (spec 6.8.2 load_cdfs / load_previous): index into
    # ref_frame_idx of the frame whose saved CDFs/gm params seed this one;
    # 7 = PRIMARY_REF_NONE. Only coded when !intra && !error_resilient.
    primary_ref_frame: int = 7
    # prediction base for gm param delta coding (PrevGmParams of the
    # primary ref frame; spec 5.9.24 read_global_param) — NOT coded, both
    # sides derive it from their slot stores.
    prev_gm_trans: tuple = ((0, 0),) * 7
    ref_frame_idx: tuple = (0, 0, 0, 0, 0, 0, 0)  # slots for LAST..ALTREF
    # temporal MV prediction (spec 5.9.2; needs seq.enable_ref_frame_mvs)
    use_ref_frame_mvs: bool = False
    # order hints of all 8 slots at this frame (for the resilient-mode
    # ref_order_hint syntax and the skip-mode derivation)
    ref_order_hints: tuple = (0,) * 8
    # cdef fields (used when seq.enable_cdef)
    cdef_damping: int = 3
    cdef_bits: int = 2
    cdef_y_strengths: tuple = (0, 0, 0, 0)
    cdef_uv_strengths: tuple = (0, 0, 0, 0)
    film_grain: object = None     # FilmGrainParams (ops.grain) or None
    # lr_params (spec 5.9.20): (frame_restoration_types[3], unit_size_y,
    # unit_size_uv) in plane pixels, or None when restoration is off
    lr_params: object = None
    reference_select: bool = False  # frame allows per-block compound
    delta_q_present: bool = False   # per-SB delta qindex (spec 5.9.17)
    delta_q_res: int = 2            # log2 step of coded deltas
    # per-ref (LAST..ALTREF) global translation MV, 1/8-pel (row, col);
    # components must be even (allow_high_precision_mv = 0)
    gm_trans: tuple = ((0, 0),) * 7
    # per-block switchable interpolation filter (spec is_filter_switchable;
    # blocks code REGULAR/SMOOTH/SHARP — reference write_mb_interp_filter,
    # EbEntropyCoding.c:2024)
    interp_filter_switchable: bool = False


def get_relative_dist(a: int, b: int, bits: int) -> int:
    """Signed wrap-around order-hint distance (spec 5.9.3)."""
    if bits <= 0:
        return 0
    diff = a - b
    m = 1 << (bits - 1)
    return (diff & (m - 1)) - (diff & m)


def skip_mode_allowed(seq, order_hint: int, ref_hints,
                      reference_select: bool) -> bool:
    """spec 5.9.22 skipModeAllowed: a nearest fwd/bwd pair (or two
    forward refs) exists among the 7 named refs' order hints."""
    if not reference_select or not seq.enable_order_hint:
        return False
    bits = seq.order_hint_bits
    fwd = bwd = -1
    fwd_hint = bwd_hint = -1
    for i in range(7):
        h = ref_hints[i]
        d = get_relative_dist(h, order_hint, bits)
        if d < 0:
            if fwd < 0 or get_relative_dist(h, fwd_hint, bits) > 0:
                fwd, fwd_hint = i, h
        elif d > 0:
            if bwd < 0 or get_relative_dist(h, bwd_hint, bits) < 0:
                bwd, bwd_hint = i, h
    if fwd < 0:
        return False
    if bwd >= 0:
        return True
    snd = -1
    snd_hint = -1
    for i in range(7):
        h = ref_hints[i]
        if get_relative_dist(h, fwd_hint, bits) < 0:
            if snd < 0 or get_relative_dist(h, snd_hint, bits) > 0:
                snd, snd_hint = i, h
    return snd >= 0


# metadata_type values (spec 6.7.1)
METADATA_TYPE_HDR_CLL = 1
METADATA_TYPE_HDR_MDCV = 2
METADATA_TYPE_ITUT_T35 = 4


def parse_metadata_obu(payload: bytes):
    """(metadata_type, dict) from a metadata OBU payload."""
    mtype, pos = read_uleb128(payload, 0)
    r = BitReader(payload[pos:])
    if mtype == METADATA_TYPE_HDR_CLL:
        return mtype, {"max_cll": r.read(16), "max_fall": r.read(16)}
    if mtype == METADATA_TYPE_HDR_MDCV:
        prim = [(r.read(16), r.read(16)) for _ in range(3)]
        wp = (r.read(16), r.read(16))
        return mtype, {"primaries": prim, "white_point": wp,
                       "max_luminance": r.read(32),
                       "min_luminance": r.read(32)}
    return mtype, {"raw": payload[pos:]}


def parse_show_existing(payload: bytes):
    """Returns slot index if this OBU_FRAME_HEADER is a show_existing
    header, else None."""
    r = BitReader(payload)
    if r.read_bit() != 1:
        return None
    return r.read(3)


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


# global motion (spec 5.9.24/5.9.25; reference WriteGlobalMotion
# EbEntropyCoding.c:3611, write_global_motion_params :3542).
# Translation-only with allow_high_precision_mv = 0:
#   trans_bits = GM_ABS_TRANS_ONLY_BITS - 1 = 8
#   trans_prec_diff = GM_TRANS_ONLY_PREC_DIFF + 1 = 14
# coded value v relates to the 1/8-pel MV component as mv = 2 * v
# (wmmat = v << 14; mv = wmmat >> 13), so components are always even.
_GM_TRANS_BITS = 8
_GM_SUBEXP_K = 3


def _inv_recenter_nonneg(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _inv_recenter_finite_nonneg(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _inv_recenter_nonneg(r, v)
    return n - 1 - _inv_recenter_nonneg(n - 1 - r, v)


def read_primitive_quniform(r, n: int) -> int:
    if n <= 1:
        return 0
    l = (n - 1).bit_length()
    m = (1 << l) - n
    v = r.read_literal(l - 1)
    if v < m:
        return v
    return (v << 1) - m + r.read_bit()


def read_primitive_subexpfin(r, n: int, k: int) -> int:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            return read_primitive_quniform(r, n - mk) + mk
        if r.read_bit():
            i += 1
            mk += a
        else:
            return r.read_literal(b) + mk


def read_primitive_refsubexpfin(r, n: int, k: int, ref: int) -> int:
    return _inv_recenter_finite_nonneg(n, ref,
                                       read_primitive_subexpfin(r, n, k))


def _read_gm_component(r, prev: int = 0) -> int:
    n = (1 << _GM_TRANS_BITS) + 1
    scaled_n = (n << 1) - 1
    return read_primitive_refsubexpfin(r, scaled_n, _GM_SUBEXP_K,
                                       prev + n - 1) - (n - 1)


def _parse_global_motion(r: BitReader, prev_all=None):
    prev_all = prev_all or ((0, 0),) * 7
    out = []
    for i in range(7):
        if not r.read_bit():
            out.append((0, 0))
            continue
        assert r.read_bit() == 0, "rot-zoom gm unsupported"
        assert r.read_bit() == 1, "affine gm unsupported"
        prev = prev_all[i]
        col = _read_gm_component(r, prev[1] >> 1) << 1
        row = _read_gm_component(r, prev[0] >> 1) << 1
        out.append((row, col))
    return tuple(out)


# =============================== parser twin ===============================

def parse_obus(data: bytes):
    """Split a temporal unit into (obu_type, payload) tuples."""
    pos = 0
    out = []
    while pos < len(data):
        hdr = data[pos]
        assert hdr & 0x80 == 0, "forbidden bit set"
        obu_type = (hdr >> 3) & 0xF
        has_size = (hdr >> 1) & 1
        pos += 1
        if (hdr >> 2) & 1:  # extension
            pos += 1
        assert has_size, "size field required by this parser"
        size, pos = read_uleb128(data, pos)
        out.append((obu_type, data[pos:pos + size]))
        pos += size
    return out


def parse_sequence_header_obu(payload: bytes) -> SequenceHeader:
    r = BitReader(payload)
    profile = r.read(3)
    still = r.read_bit()
    reduced = r.read_bit()
    assert not reduced, "reduced_still_picture_header unsupported"
    assert r.read_bit() == 0  # timing_info
    assert r.read_bit() == 0  # initial_display_delay
    assert r.read(5) == 0     # operating_points_cnt_minus_1
    r.read(12)                # operating_point_idc
    level = r.read(5)
    if level > 7:
        r.read_bit()          # seq_tier
    wbits = r.read(4) + 1
    hbits = r.read(4) + 1
    width = r.read(wbits) + 1
    height = r.read(hbits) + 1
    assert r.read_bit() == 0  # frame_id_numbers
    use128 = bool(r.read_bit())
    filter_intra = bool(r.read_bit())
    intra_edge = bool(r.read_bit())
    r.read_bit()              # enable_interintra_compound
    r.read_bit()              # enable_masked_compound
    r.read_bit()              # enable_warped_motion
    r.read_bit()              # enable_dual_filter
    order_hint = bool(r.read_bit())
    order_hint_bits = 0
    ref_frame_mvs = False
    if order_hint:
        r.read_bit()          # enable_jnt_comp
        ref_frame_mvs = bool(r.read_bit())
    choose_sct = r.read_bit()
    force_sct = 2 if choose_sct else r.read_bit()
    if force_sct > 0:
        if not r.read_bit():  # seq_choose_integer_mv
            r.read_bit()
    if order_hint:
        order_hint_bits = r.read(3) + 1
    superres = bool(r.read_bit())
    cdef = bool(r.read_bit())
    restoration = bool(r.read_bit())
    high_bd = r.read_bit()
    bit_depth = 10 if high_bd else 8
    if profile != 1:
        mono = r.read_bit()
        assert not mono, "monochrome unsupported"
    cp = tc = mc_ = None
    if r.read_bit():          # color_description_present
        cp, tc, mc_ = r.read(8), r.read(8), r.read(8)
    crange = r.read_bit()     # color_range
    assert profile == 0, "4:2:0 only"
    r.read(2)                 # chroma_sample_position
    sep_uv_dq = r.read_bit()
    assert not sep_uv_dq
    grain = bool(r.read_bit())
    if grain:
        raise NotImplementedError(
            "the stream enables film grain, which this reference does not "
            "decode")
    return SequenceHeader(width=width, height=height, bit_depth=bit_depth,
                          use_128x128_superblock=use128,
                          enable_filter_intra=filter_intra,
                          enable_intra_edge_filter=intra_edge,
                          enable_order_hint=order_hint,
                          order_hint_bits=order_hint_bits,
                          enable_ref_frame_mvs=ref_frame_mvs,
                          enable_cdef=cdef, enable_restoration=restoration,
                          enable_superres=superres,
                          film_grain_params_present=grain,
                          color_primaries=cp,
                          transfer_characteristics=tc,
                          matrix_coefficients=mc_, color_range=crange,
                          seq_profile=profile, still_picture=bool(still))


def parse_frame_obu(payload: bytes, seq: SequenceHeader, slot_gm=None,
                    slot_hints=None):
    """Parse an OBU_FRAME.

    ``slot_gm``: 8-entry list of per-slot saved gm_trans 7-tuples (the
    decoder's SavedGmParams store) — needed to predict gm params when
    primary_ref_frame != PRIMARY_REF_NONE.
    Returns (FrameHeader, [tile bytes])."""
    r = BitReader(payload)
    assert r.read_bit() == 0, "use parse_show_existing for those headers"
    frame_type = r.read(2)
    show_frame = bool(r.read_bit())
    is_key = frame_type == KEY_FRAME
    assert frame_type in (KEY_FRAME, INTER_FRAME)
    if not show_frame:
        assert r.read_bit() == 1  # showable_frame
    error_resilient = True
    if not (is_key and show_frame):
        error_resilient = bool(r.read_bit())
    disable_cdf_update = bool(r.read_bit())
    assert r.read_bit() == 0  # frame_size_override
    order_hint = r.read(seq.order_hint_bits) if seq.enable_order_hint else 0
    primary_ref_frame = PRIMARY_REF_NONE
    if not is_key and not error_resilient:
        primary_ref_frame = r.read(3)
    refresh_frame_flags = 0xFF
    ref_frame_idx = (0,) * 7
    use_ref_frame_mvs = False
    interp_switchable = False
    ref_order_hints = tuple(slot_hints) if slot_hints is not None \
        else (0,) * 8
    if is_key:
        assert r.read_bit() == 0  # render_and_frame_size_different
    else:
        refresh_frame_flags = r.read(8)
        if error_resilient and seq.enable_order_hint:
            ref_order_hints = tuple(r.read(seq.order_hint_bits)
                                    for _ in range(8))
        if seq.enable_order_hint:
            assert r.read_bit() == 0  # frame_refs_short_signaling
        ref_frame_idx = tuple(r.read(3) for _ in range(7))
        # !override || error_resilient -> frame_size() + render_size()
        assert r.read_bit() == 0  # render_and_frame_size_different
        assert r.read_bit() == 0  # allow_high_precision_mv
        interp_switchable = bool(r.read_bit())
        if not interp_switchable:
            assert r.read(2) == 0  # interpolation_filter REGULAR
        assert r.read_bit() == 0  # is_motion_mode_switchable
        if not error_resilient and seq.enable_ref_frame_mvs:
            use_ref_frame_mvs = bool(r.read_bit())
    if disable_cdf_update:
        disable_end_update = True
    else:
        disable_end_update = bool(r.read_bit())
    tile_cols_log2, tile_rows_log2, tile_size_bytes = _parse_tile_info(r, seq)
    base_q_idx = r.read(8)
    assert r.read_bit() == 0  # DeltaQYDc
    assert r.read_bit() == 0  # DeltaQUDc
    assert r.read_bit() == 0  # DeltaQUAc
    assert r.read_bit() == 0  # using_qmatrix
    assert r.read_bit() == 0  # segmentation_enabled
    delta_q_present = False
    delta_q_res = 2
    if base_q_idx > 0:
        delta_q_present = bool(r.read_bit())
        if delta_q_present:
            delta_q_res = r.read(2)
    if delta_q_present:
        assert r.read_bit() == 0  # delta_lf_present
    lf0, lf1 = r.read(6), r.read(6)
    lf2 = lf3 = 0
    if lf0 or lf1:
        lf2, lf3 = r.read(6), r.read(6)
    r.read(3)                 # sharpness
    lf_delta = r.read_bit()
    assert not lf_delta
    cdef_damping, cdef_bits = 3, 0
    cdef_y, cdef_uv = (0,) * 8, (0,) * 8
    if seq.enable_cdef:
        cdef_damping = r.read(2) + 3
        cdef_bits = r.read(2)
        n = 1 << cdef_bits
        ys, uvs = [], []
        for _ in range(n):
            ys.append(r.read(6))
            uvs.append(r.read(6))
        cdef_y, cdef_uv = tuple(ys), tuple(uvs)
    lr_params = None
    if seq.enable_restoration:
        _LR_TYPE = {(0, 0): 0, (1, 0): 1, (1, 1): 2, (0, 1): 3}
        types = tuple(_LR_TYPE[(r.read_bit(), r.read_bit())]
                      for _ in range(3))
        size_y, size_uv = 256, 128
        if any(types):
            size_y = 64
            if r.read_bit():
                size_y = 256 if r.read_bit() else 128
            size_uv = size_y
            if types[1] or types[2]:
                if r.read_bit():
                    size_uv = size_y >> 1
        lr_params = (types, size_y, size_uv)
    tx_mode_select = bool(r.read_bit())
    reference_select = False
    if not is_key:
        reference_select = bool(r.read_bit())
    if not is_key and skip_mode_allowed(seq, order_hint,
                                        [ref_order_hints[i]
                                         for i in ref_frame_idx],
                                        reference_select):
        assert r.read_bit() == 0  # skip_mode_present
    reduced_tx_set = bool(r.read_bit())
    gm_trans = ((0, 0),) * 7
    prev_gm = ((0, 0),) * 7
    if not is_key:
        if primary_ref_frame != PRIMARY_REF_NONE and slot_gm is not None:
            prev_gm = slot_gm[ref_frame_idx[primary_ref_frame]]
        gm_trans = _parse_global_motion(r, prev_gm)
    r.byte_align()
    fh = FrameHeader(frame_type=frame_type, show_frame=show_frame,
                     error_resilient=error_resilient,
                     primary_ref_frame=primary_ref_frame,
                     prev_gm_trans=prev_gm,
                     refresh_frame_flags=refresh_frame_flags,
                     ref_frame_idx=ref_frame_idx,
                     cdef_damping=cdef_damping, cdef_bits=cdef_bits,
                     cdef_y_strengths=cdef_y, cdef_uv_strengths=cdef_uv,
                     lr_params=lr_params,
                     reference_select=reference_select,
                     gm_trans=gm_trans,
                     interp_filter_switchable=interp_switchable,
                     delta_q_present=delta_q_present,
                     delta_q_res=delta_q_res,
                     base_q_idx=base_q_idx,
                     disable_cdf_update=disable_cdf_update,
                     disable_frame_end_update_cdf=disable_end_update,
                     tx_mode_select=tx_mode_select,
                     reduced_tx_set=reduced_tx_set,
                     tile_cols_log2=tile_cols_log2,
                     tile_rows_log2=tile_rows_log2,
                     loop_filter_levels=(lf0, lf1, lf2, lf3),
                     order_hint=order_hint,
                     use_ref_frame_mvs=use_ref_frame_mvs,
                     ref_order_hints=ref_order_hints)
    # tile group
    data = payload[r.bit_pos // 8:]
    num_tiles = (1 << tile_cols_log2) * (1 << tile_rows_log2)
    tiles = []
    pos = 0
    if num_tiles > 1:
        pos += 1  # tile_start_and_end_present byte (flag + alignment)
    for i in range(num_tiles):
        if i != num_tiles - 1:
            size = int.from_bytes(data[pos:pos + tile_size_bytes],
                                  "little") + 1
            pos += tile_size_bytes
            tiles.append(data[pos:pos + size])
            pos += size
        else:
            tiles.append(data[pos:])
    return fh, tiles


def _parse_tile_info(r: BitReader, seq: SequenceHeader):
    sb_cols, sb_rows = seq.sb_cols, seq.sb_rows
    sb_size_log2 = 7 if seq.use_128x128_superblock else 6
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    assert r.read_bit() == 1, "non-uniform tile spacing unsupported"
    cols_log2 = min_log2_cols
    while cols_log2 < max_log2_cols:
        if not r.read_bit():
            break
        cols_log2 += 1
    min_log2_rows = max(min_log2_tiles - cols_log2, 0)
    rows_log2 = min_log2_rows
    while rows_log2 < max_log2_rows:
        if not r.read_bit():
            break
        rows_log2 += 1
    tile_size_bytes = 4
    if cols_log2 or rows_log2:
        r.read(cols_log2 + rows_log2)   # context_update_tile_id
        tile_size_bytes = r.read(2) + 1
    return cols_log2, rows_log2, tile_size_bytes
