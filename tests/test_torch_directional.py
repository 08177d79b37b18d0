"""The port's directional presets against the JAX package's host path.

The normative intra edge filter and upsample (AV1 spec 7.11.2) run on the
per-wave keyframe loop when a key frame's candidates hold a directional
mode outside V/H at delta 0 (``common.edge_filter_active``): preset 2,
the CLI default, and ``EncoderConfig()``'s defaults. Checked here on the
CPU, tolerance 0 throughout (the pixel path is integer):

- the torch twin ``predict_directional_edge_t`` against the JAX package's
  ``intra_dir.predict_directional_edge`` (numpy), per lane filt_type and
  real sample counts random, at 8 and 10 bits;
- ``decide_block_batch_dev(edge=...)`` against the JAX host decide
  ``md.decide_block_batch`` with the same operands, for a square and a
  rect leaf and every plane (CfL and the forced V plane included);
- whole streams through ``encode_ivf`` against the JAX package's host
  backend on diagonal content (where the filter engages), with the port's
  recon equal to the JAX mirror decoder's decode of its stream.
"""

import collections
import dataclasses
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu.ops import intra_dir as jintra_dir
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu.pipeline import md as jmd
from svt_av1_tpu.pipeline import wavefront as jwf
from svt_av1_tpu.pipeline.common import edge_filter_active
from svt_av1_tpu.pipeline.decode import decode_ivf
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.bitstream.ivf import (patch_ivf_frame_count,
                                             write_ivf_frame,
                                             write_ivf_header)
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.ops import device_md as tmd
from svt_av1_tpu_torch.ops import intra_dir
from svt_av1_tpu_torch.ops import quant as quant_ops
from svt_av1_tpu_torch.pipeline import rd
from svt_av1_tpu_torch.pipeline import wavefront as twf
from svt_av1_tpu_torch.pipeline.encoder import Encoder, encode_ivf
from svt_av1_tpu_torch.utils.blocks import (D45_PRED, D67_PRED, D135_PRED,
                                            D203_PRED, H_PRED, V_PRED)
from tests.torch_threads import one_torch_thread  # noqa: F401

# the modes and deltas of tests/test_intra_edge.py's jnp-twin check: all
# three zones, upsampled and filtered edges, and V/H off their exact angle
MODES = ((D45_PRED, 2), (D135_PRED, -2), (D203_PRED, 1), (V_PRED, 3),
         (H_PRED, -3), (D67_PRED, -1))
NAMES = ("modes", "deltas", "qcoeff", "eob", "recon", "cost", "alphas",
         "tts")


def _edges(rng, b, bw, bh, bd):
    a1 = rng.integers(0, 1 << bd, (b, 1 + bw + bh)).astype(np.int32)
    l1 = rng.integers(0, 1 << bd, (b, 1 + bh + bw)).astype(np.int32)
    ha = rng.integers(0, 2, b).astype(bool)
    hl = rng.integers(0, 2, b).astype(bool)
    ft = rng.integers(0, 2, b).astype(np.int32)
    n_top = rng.integers(0, bw + 1, b).astype(np.int64)
    n_left = rng.integers(0, bh + 1, b).astype(np.int64)
    return a1, l1, ha, hl, (ft, n_top, n_left)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("bw,bh", [(4, 4), (8, 8), (16, 16), (8, 16),
                                   (16, 8), (32, 32)])
def test_edge_predictor_matches_jax(bw, bh, bd):
    rng = np.random.default_rng(bw * 100 + bh + bd)
    T = torch.as_tensor
    for mode, delta in MODES:
        a1, l1, ha, hl, edge = _edges(rng, 16, bw, bh, bd)
        want = jintra_dir.predict_directional_edge(
            mode, delta, a1.astype(np.int64), l1.astype(np.int64), bw, bh,
            ha, hl, *edge, bd=bd, xp=np)
        got = intra_dir.predict_directional_edge_t(
            mode, delta, T(a1).long(), T(l1).long(), bw, bh, T(ha), T(hl),
            *(T(e) for e in edge), bd=bd)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want), (mode, delta)


# the preset-2 candidate set and two off-angle directional candidates
CANDS = [(m, 0) for m in range(13)] + [(D45_PRED, 2), (D135_PRED, -1)]


@pytest.mark.parametrize("plane,size,forced", [
    (0, 16, False), (0, (16, 8), False), (1, 8, False), (2, (8, 4), True),
])
def test_decide_with_edge_matches_jax_host(plane, size, forced):
    rng = np.random.default_rng(plane * 10 + (size if size == 16 else 3))
    bw, bh = (size, size) if isinstance(size, int) else size
    b = 13
    a1, l1, ha, hl, edge = _edges(rng, b, bw, bh, 8)
    # each lane's source: one filtered directional prediction of its own
    # edges plus noise, so that filtered modes win the decision
    srcs = np.zeros((b, bh, bw), np.int64)
    for i in range(b):
        m = (3, 4, 5, 6, 7, 8)[i % 6]
        srcs[i] = jintra_dir.predict_directional_edge(
            m, 0, a1.astype(np.int64), l1.astype(np.int64), bw, bh, ha, hl,
            *edge, xp=np)[i]
    srcs = np.clip(srcs + rng.integers(-3, 4, srcs.shape), 0, 255)
    kw = dict(bd=8, nfl=2, rdoq=True, edge=edge)
    if plane:
        kw["cfl_luma"] = rng.integers(0, 256, (b, 2 * bh, 2 * bw))
    if forced:
        fm = np.array([13, 3, 4, 0, 7, 8, 13, 1, 2, 9, 5, 6, 13])
        fd = np.where(fm == 3, 2, 0)
        kw["forced"] = (fm, fd)
    else:
        kw["tx_search"] = plane == 0
    lam = rd.rd_lambda(120, 8)
    want = jmd.decide_block_batch(plane, srcs, a1, l1, ha, hl, CANDS,
                                  jquant.make_quant_params(120), size, lam,
                                  **kw)
    got = tmd.decide_block_batch_dev(plane, srcs, a1, l1, ha, hl, CANDS,
                                     quant_ops.make_quant_params(120), size,
                                     lam, device="cpu", **kw)
    for n, g, w in zip(NAMES, got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), n
    if not forced:
        assert set(got[0]) & {3, 4, 5, 6, 7, 8}, "no filtered mode won"


def encode_with_recons(frames, cfg):
    """The IVF stream of ``frames`` through the port's Encoder (the bytes
    of ``encode_ivf``) and the recon planes of its shown frames."""
    enc = Encoder(cfg)
    buf = io.BytesIO()
    write_ivf_header(buf, cfg.width, cfg.height, cfg.frame_rate_num,
                     cfg.frame_rate_den, len(frames))
    for f in frames:
        enc.send_picture(*f)
    enc.flush()
    recons = []
    k = 0
    while (pkt := enc.get_packet()) is not None:
        write_ivf_frame(buf, pkt[0], k)
        k += 1
        if pkt[1] is not None:
            recons.append(pkt[1])
    patch_ivf_frame_count(buf, k)
    return buf.getvalue(), recons


def assert_decodes_to(stream: bytes, recons) -> None:
    """The JAX mirror decoder's shown frames of ``stream`` equal
    ``recons``, plane for plane."""
    dec = decode_ivf(io.BytesIO(stream))
    assert len(dec) == len(recons) > 0
    for a, b in zip(recons, dec):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb)


def _diagonal_clip(w, h, frames):
    """Diagonal gratings (tests/test_intra_edge_e2e.py's content), moving
    frame to frame: directional modes and the edge filter engage."""
    from tests.test_intra_edge_e2e import synth
    return [synth(w, h, seed=s) for s in range(frames)]


def _jax_cfg(w, h, preset, intra_period, levels=0, **extra):
    args = SimpleNamespace(width=w, height=h, qp=40, bit_depth=8,
                           intra_period=intra_period, fps=30, film_grain=0,
                           preset=preset, hierarchical_levels=levels, tbr=0,
                           lad=0, backend="host")
    return dataclasses.replace(jax_preset_config(args), **extra)


STREAMS = {
    "preset2_all_intra": (128, 96, 2, lambda w, h: _jax_cfg(w, h, 2, 0)),
    "config_defaults": (128, 96, 1,
                        lambda w, h: JaxConfig(width=w, height=h)),
    "preset2_2tiles": (192, 128, 1,
                       lambda w, h: _jax_cfg(w, h, 2, 0, tile_cols_log2=1)),
    "preset2_ra_hier2": (128, 64, 5, lambda w, h: _jax_cfg(w, h, 2, -1, 2)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_directional_stream_matches_jax_and_decodes(name):
    w, h, n, make = STREAMS[name]
    jcfg = make(w, h)
    assert edge_filter_active(jcfg)
    frames = _diagonal_clip(w, h, n)
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    waves = []
    orig = twf.WavefrontIntraEncoder._code_wave

    def spy(self, *a, **k):
        waves.append(self._edge)
        return orig(self, *a, **k)

    twf.WavefrontIntraEncoder._code_wave = spy
    try:
        got, recons = encode_with_recons(frames, cfg)
    finally:
        twf.WavefrontIntraEncoder._code_wave = orig
    assert waves and all(waves), "the key frames took the per-wave loop"
    assert got == jax_encode_ivf(frames, jcfg)
    assert_decodes_to(got, recons)


@pytest.mark.parametrize("tile_by_tile", [False, True])
def test_filt_type_per_lane_matches_jax(monkeypatch, tile_by_tile):
    """Every lane's filt_type and real sample counts, plane by plane,
    equal the JAX host loop's, and so does the stream: EncoderConfig()'s
    13 modes on fixed 8 px leaves (many SMOOTH decisions) in 2 tile
    columns at 192x128. The port codes wave w of both tiles in one step;
    ``tile_by_tile`` runs its loop over one tile after the other, the JAX
    order, where a tile's left neighbour is already coded (its
    smoothness maps must stay tile-local)."""
    w, h = 192, 128
    jcfg = JaxConfig(width=w, height=h, tile_cols_log2=1,
                     fixed_partition_size=8)
    frames = _diagonal_clip(w, h, 1)
    want, got = collections.Counter(), collections.Counter()
    jorig = jwf.WavefrontIntraEncoder._wave_compute

    def jspy(self, plane, xs, ys, size, *a, ftype=None, **k):
        max_w, max_h = self.max_wh[plane]
        bw, bh = (size, size) if isinstance(size, int) else size
        for x, y, f in zip(xs, ys, ftype):
            want[(plane, bw, bh, int(x), int(y), int(f),
                  min(max(max_w - x, 0), bw), min(max(max_h - y, 0), bh))] += 1
        return jorig(self, plane, xs, ys, size, *a, ftype=ftype, **k)

    torig = tmd.decide_block_batch_dev
    lanes = []

    def tspy(plane, srcs, *a, edge=None, **k):
        size = a[6]
        bw, bh = (size, size) if isinstance(size, int) else size
        for (x, y), f, nt, nl in zip(lanes, *edge):
            got[(plane, bw, bh, x, y, int(f), int(nt), int(nl))] += 1
        return torig(plane, srcs, *a, edge=edge, **k)

    corig = twf.WavefrontIntraEncoder._wave_compute

    def cspy(self, plane, parts, *a, **k):
        lanes[:] = [(int(x), int(y)) for _, xs, ys, _, _ in parts
                    for x, y in zip(xs, ys)]
        return corig(self, plane, parts, *a, **k)

    monkeypatch.setattr(jwf.WavefrontIntraEncoder, "_wave_compute", jspy)
    monkeypatch.setattr(twf.WavefrontIntraEncoder, "_wave_compute", cspy)
    monkeypatch.setattr(twf, "decide_block_batch_dev", tspy)
    if tile_by_tile:
        lorig = twf.WavefrontIntraEncoder._wave_loop
        monkeypatch.setattr(
            twf.WavefrontIntraEncoder, "_wave_loop",
            lambda self, tiles, cands: [lorig(self, [t], cands)
                                        for t in tiles])
    stream = jax_encode_ivf(frames, jcfg)
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    assert encode_ivf(frames, cfg) == stream
    assert got == want
    smooth = sum(v for k, v in got.items() if k[5])
    assert smooth > 100 and {k[0] for k in got if k[5]} == {0, 1, 2}
