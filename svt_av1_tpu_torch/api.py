"""Reference-shaped public API: the ``EbApi.h`` entry points
(reference: Source/API/EbApi.h:505-591 — eb_init_handle,
eb_svt_enc_set_parameter, eb_init_encoder, eb_svt_enc_send_picture,
eb_svt_get_packet, eb_svt_get_recon, eb_deinit_*) re-expressed as a
Python module so integration code written against the reference's
handle/buffer lifecycle ports 1:1. The port's copy of the JAX package's
``api.py``; the parameter struct's ``device`` (default ``"cuda"``; a
machine without a card raises at ``eb_init_encoder``, ``"cpu"`` runs the
plain PyTorch versions) takes the place of the JAX package's backend.

Lifecycle:

    handle, params = eb_init_handle()
    params.width = 854; params.height = 480; params.qp = 40
    eb_svt_enc_set_parameter(handle, params)
    eb_init_encoder(handle)
    hdr = eb_svt_enc_stream_header(handle)        # sequence header TU
    for frame in frames:
        eb_svt_enc_send_picture(handle, EbBufferHeaderType(pic=frame))
    eb_svt_enc_send_picture(handle, None)         # EOS
    while (buf := eb_svt_get_packet(handle, done=True)) is not None:
        write(buf.p_buffer)
        eb_svt_release_out_buffer(buf)
    eb_deinit_encoder(handle); eb_deinit_handle(handle)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from svt_av1_tpu_torch.bitstream import obu

EB_ErrorNone = 0
EB_ErrorBadParameter = 0x80001005

# buffer flags (EbApi.h EB_BUFFERFLAG_*)
EB_BUFFERFLAG_EOS = 1
EB_BUFFERFLAG_SHOW_EXT = 2


@dataclasses.dataclass
class EbSvtAv1EncConfiguration:
    """Mutable parameter struct (reference EbApi.h:129-494 subset; mapped
    onto the frozen EncoderConfig at set_parameter time)."""
    width: int = 854
    height: int = 480
    bit_depth: int = 8
    qp: int = 40
    intra_period: int = -1
    hierarchical_levels: int = 0
    enc_mode: int = 2                  # preset M0..M8
    rate_control_mode: int = 0
    target_bit_rate: int = 0
    look_ahead_distance: int = 0
    film_grain_denoise_strength: int = 0
    tile_columns: int = 0
    frame_rate_numerator: int = 30
    frame_rate_denominator: int = 1
    device: str = "cuda"               # torch device of the pixel path


@dataclasses.dataclass
class EbBufferHeaderType:
    """Picture / packet buffer wrapper (reference EbBufferHeaderType)."""
    pic: Optional[tuple] = None        # (y, u, v) ndarrays on input
    p_buffer: bytes = b""              # packet bytes on output
    n_filled_len: int = 0
    flags: int = 0
    pts: int = 0
    recon: Optional[list] = None


class _Handle:
    def __init__(self):
        self.params = EbSvtAv1EncConfiguration()
        self.cfg = None
        self.enc = None
        self._pts = 0
        self._eos_sent = False


def eb_init_handle():
    """Returns (handle, default parameter struct)."""
    h = _Handle()
    return h, h.params


def eb_svt_enc_set_parameter(handle: _Handle,
                             params: EbSvtAv1EncConfiguration) -> int:
    from svt_av1_tpu_torch.app.cli import preset_config
    try:
        cfg = preset_config(
            width=params.width, height=params.height, qp=params.qp,
            bit_depth=params.bit_depth, intra_period=params.intra_period,
            fps=params.frame_rate_numerator, preset=params.enc_mode,
            film_grain=params.film_grain_denoise_strength,
            hierarchical_levels=params.hierarchical_levels,
            tbr=params.target_bit_rate, lad=params.look_ahead_distance,
            device=params.device)
        if params.tile_columns:
            cfg = dataclasses.replace(cfg,
                                      tile_cols_log2=params.tile_columns)
        handle.cfg = cfg
        handle.params = params
    except ValueError:
        return EB_ErrorBadParameter
    return EB_ErrorNone


def eb_init_encoder(handle: _Handle) -> int:
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    if handle.cfg is None:
        return EB_ErrorBadParameter
    handle.enc = Encoder(handle.cfg)
    return EB_ErrorNone


def eb_svt_enc_stream_header(handle: _Handle):
    """Standalone sequence header TU (eb_svt_enc_stream_header).

    Returns EB_ErrorBadParameter before eb_init_encoder (the reference
    EbApi lifecycle contract: handle checks precede any work)."""
    if getattr(handle, "enc", None) is None:
        return EB_ErrorBadParameter
    data = obu.temporal_delimiter_obu() \
        + obu.write_sequence_header_obu(handle.enc.seq)
    return EbBufferHeaderType(p_buffer=data, n_filled_len=len(data))


def eb_svt_enc_send_picture(handle: _Handle,
                            buf: Optional[EbBufferHeaderType]) -> int:
    """None (or a buffer with pic=None) signals end of stream."""
    if getattr(handle, "enc", None) is None:
        return EB_ErrorBadParameter
    if buf is None or buf.pic is None:
        if not handle._eos_sent:
            handle.enc.flush()
            handle._eos_sent = True
        return EB_ErrorNone
    y, u, v = buf.pic
    handle.enc.send_picture(np.asarray(y), np.asarray(u), np.asarray(v))
    return EB_ErrorNone


def eb_svt_get_packet(handle: _Handle,
                      done: bool = False) -> Optional[EbBufferHeaderType]:
    """Next output packet or None (pic_send_done -> drain to EOS)."""
    pkt = handle.enc.get_packet()
    if pkt is None:
        return None
    tu, recon = pkt
    out = EbBufferHeaderType(p_buffer=tu, n_filled_len=len(tu),
                             pts=handle._pts, recon=recon)
    handle._pts += 1
    if done and handle._eos_sent and not handle.enc._out:
        out.flags |= EB_BUFFERFLAG_EOS
    return out


def eb_svt_release_out_buffer(buf: EbBufferHeaderType) -> None:
    buf.p_buffer = b""
    buf.recon = None


def eb_svt_get_recon(handle: _Handle,
                     buf: EbBufferHeaderType) -> int:
    """Recon travels on the packet buffer (recon attr) in this design."""
    return EB_ErrorNone if buf.recon is not None else EB_ErrorBadParameter


def eb_deinit_encoder(handle: _Handle) -> int:
    handle.enc = None
    return EB_ErrorNone


def eb_deinit_handle(handle: _Handle) -> int:
    handle.cfg = None
    return EB_ErrorNone
