"""The port's inter streams (svt_av1_tpu_torch) against the JAX package.

The same frames go through ``svt_av1_tpu_torch.pipeline.encoder.encode_ivf``
on the CPU (the plain PyTorch versions of every kernel, the port's fused
inter path) and through ``svt_av1_tpu.pipeline.encoder.encode_ivf`` with
the host backend; the IVF bytes must be identical (tolerance 0: the pixel
path is integer). Low-delay P, random access (hierarchical-B pyramids of
2 and 3 levels, with compound prediction, TMVP and the partition DP), a
scene change that makes the intra-flip pass fire, and the main path's
tiling (4 tile columns, the last one narrower).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu.pipeline.common import edge_filter_active
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.pipeline.encoder import Encoder, encode_ivf
from svt_av1_tpu_torch.pipeline.inter import InterFrameEncoder
from svt_av1_tpu_torch.pipeline.wavefront import WavefrontIntraEncoder
from svt_av1_tpu_torch.utils.clip import make_clip
from tests.torch_threads import one_torch_thread  # noqa: F401


def _jax_cfg(w, h, preset, levels, **extra):
    args = SimpleNamespace(width=w, height=h, qp=40, bit_depth=8,
                           intra_period=-1, fps=30, film_grain=0,
                           preset=preset, hierarchical_levels=levels, tbr=0,
                           lad=0, backend="host")
    return dataclasses.replace(jax_preset_config(args), **extra)


def _same_stream(frames, jcfg):
    assert not edge_filter_active(jcfg)
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    want = jax_encode_ivf(frames, jcfg)
    got = encode_ivf(frames, cfg)
    assert len(got) == len(want)
    assert got == want


# name: (w, h, frames, preset, hierarchical levels, extra config)
STREAMS = {
    "low_delay_p": (128, 64, 4, 5, 0, {}),
    "ra_hier2_rect_dp": (128, 64, 5, 4, 2, {}),
    "ra_hier3_dp": (128, 64, 9, 5, 3, {}),
    # 7 SB columns in 4 uniform tile columns (2, 2, 2, 1 SBs) — the
    # 1080p main path's tiling shape (8, 8, 8, 6)
    "ra_hier3_4tiles": (448, 128, 9, 5, 3, dict(tile_cols_log2=2)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_inter_stream_byte_identical(name):
    w, h, n, preset, levels, extra = STREAMS[name]
    jcfg = _jax_cfg(w, h, preset, levels, **extra)
    assert jcfg.fixed_partition_size is None     # the inter partition DP
    _same_stream(make_clip(w=w, h=h, frames=n, seed=3), jcfg)


def _scene_change_pair():
    """A half-frame scene change: the flip pass fires on the new half."""
    rng = np.random.default_rng(21)
    h, w = 128, 192
    y0 = rng.integers(30, 220, (h, w)).astype(np.uint8)
    y1 = y0.copy()
    yy, xx = np.mgrid[0:h, 0:w // 2]
    y1[:, :w // 2] = np.clip(128 + 90 * np.sin(yy / 5.0) * np.cos(xx / 4.0),
                             0, 255).astype(np.uint8)
    u = np.full((h // 2, w // 2), 110, np.uint8)
    v = np.full((h // 2, w // 2), 150, np.uint8)
    return [(y0, u, v), (y1, u, v)]


def test_flip_stream_byte_identical():
    frames = _scene_change_pair()
    jcfg = JaxConfig(width=192, height=128, qp=40, intra_period=16,
                     scene_change_detection=False,
                     intra_modes=(0, 1, 2, 12))
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    # the port's inter frame must actually flip blocks to intra (else this
    # test stops covering the flip pass)
    kf = WavefrontIntraEncoder(cfg)
    kf.encode_compute(*frames[0])
    ie = InterFrameEncoder(cfg, Encoder(cfg).seq)
    ie.encode_compute(*frames[1], kf.recon)
    assert (~ie.block_is_inter).sum() > 0
    _same_stream(frames, jcfg)


def test_stream_api_hides_non_shown_frames():
    """RA: the anchor and the interior B frames are coded hidden (recon
    None) and shown later by show_existing_frame TUs."""
    frames = make_clip(w=128, h=64, frames=5, seed=4)
    cfg = config_from_jax(dataclasses.asdict(_jax_cfg(128, 64, 5, 2)),
                          device="cpu")
    enc = Encoder(cfg)
    for f in frames:
        enc.send_picture(*f)
    enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    shown = [r for _, r in pkts if r is not None]
    assert len(shown) == len(frames)
    assert sum(r is None for _, r in pkts) == 2        # anchor + mid B
    for r in shown:
        assert r[0].shape == (64, 128) and r[0].dtype == np.uint8


@pytest.mark.parametrize("field", ["enable_tx_type_search",
                                   "enable_interp_filter_search"])
def test_non_fused_inter_tools_raise_not_implemented(field):
    """The inter searches (the non-fused inter path) encode like the JAX
    package: each is accepted all-intra and with inter frames, and a
    low-delay stream with it equals the JAX host encoder's. (The name
    dates from when these configs raised NotImplementedError.)"""
    base = dict(width=64, height=64, intra_modes=(0, 1, 2, 12))
    EncoderConfig(**base, intra_period=0, **{field: True})   # intra: fine
    for inter in (dict(intra_period=-1), dict(hierarchical_levels=3)):
        assert getattr(EncoderConfig(**base, **inter, **{field: True}),
                       field)
    jcfg = JaxConfig(**base, intra_period=-1, **{field: True})
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    frames = make_clip(w=64, h=64, frames=2, seed=6)
    assert encode_ivf(frames, cfg) == jax_encode_ivf(frames, jcfg)
