"""Film grain and source denoising in the port (svt_av1_tpu_torch) against
the JAX package.

The grain synthesis (LFSR, templates, scaling LUTs, the per-block noise
at 8 and 10 bits), its frame-header syntax, the auto estimation of a full
noise model and the noise-classified denoiser are NumPy in both packages
and must agree exactly. Streams with flat grain, auto-estimated grain and
source denoising go through the port's ``encode_ivf`` on the CPU and
through the JAX package's with the host backend (identical IVF bytes,
tolerance 0); the display recon the port hands out carries the grain,
equal to the JAX encoder's and to the JAX mirror decoder's output, while
its reference slots stay grain-free.
"""

import dataclasses
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.bitstream.bitio import BitWriter as JaxBitWriter
from svt_av1_tpu.ops import grain as jax_grain
from svt_av1_tpu.pipeline import analysis as jax_analysis
from svt_av1_tpu.pipeline.decode import decode_ivf
from svt_av1_tpu.pipeline.encoder import Encoder as JaxEncoder
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.bitstream.bitio import BitReader, BitWriter
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.ops import grain
from svt_av1_tpu_torch.pipeline import analysis
from svt_av1_tpu_torch.pipeline.encoder import Encoder, encode_ivf
from svt_av1_tpu_torch.utils.clip import make_clip
from tests.torch_threads import one_torch_thread  # noqa: F401


def _noisy_clip(n, sigma=8.0, w=128, h=64, seed=7):
    """Flat gray frames under Gaussian noise: noise class 4 (frame-based
    denoising) and a grain estimate that applies."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = np.clip(120 + rng.normal(0, sigma, (h, w)), 0, 255)
        out.append((y.astype(np.uint8),
                    np.full((h // 2, w // 2), 110, np.uint8),
                    np.full((h // 2, w // 2), 140, np.uint8)))
    return out


def _params():
    """Flat strengths, and a full model with chroma points and an AR
    lag."""
    full = dataclasses.replace(
        grain.default_params(24, seed=777), num_y_points=3,
        scaling_points_y=((0, 20), (128, 40), (255, 10)), num_cb_points=2,
        scaling_points_cb=((0, 30), (255, 30)), num_cr_points=1,
        scaling_points_cr=((64, 25),), ar_coeff_lag=1,
        ar_coeffs_y=(4, -8, 20, 30), ar_coeffs_cb=(1, 2, 3, 4, 5),
        ar_coeffs_cr=(0, -1, 2, 0, 9), cb_mult=150, cr_luma_mult=170,
        grain_scale_shift=1)
    return [grain.default_params(10), grain.default_params(64, seed=3),
            full]


def _jax_params(p):
    return jax_grain.FilmGrainParams(**dataclasses.asdict(p))


@pytest.mark.parametrize("bd", [8, 10])
def test_grain_synthesis_equals_jax(bd):
    rng = np.random.default_rng(bd)
    dt = np.uint16 if bd > 8 else np.uint8
    planes = [rng.integers(0, 1 << bd, s).astype(dt)
              for s in ((70, 134), (35, 67), (35, 67))]
    for p in _params():
        for got, want in zip(grain._generate_grain(p, bd),
                             jax_grain._generate_grain(_jax_params(p), bd)):
            assert np.array_equal(got, want)
        got = grain.apply_grain(planes, p, bd)
        want = jax_grain.apply_grain(planes, _jax_params(p), bd)
        for g, w, src in zip(got, want, planes):
            assert g.dtype == w.dtype == src.dtype
            assert np.array_equal(g, w)
        assert not np.array_equal(got[0], planes[0])


def test_grain_params_syntax_equals_jax():
    for p in _params():
        for is_inter in (False, True):
            w, jw = BitWriter(), JaxBitWriter()
            grain.write_params(w, p, is_inter)
            jax_grain.write_params(jw, _jax_params(p), is_inter)
            assert w.bit_count == jw.bit_count > 1
            w.byte_align()
            jw.byte_align()
            assert w.data() == jw.data()
            back = grain.read_params(BitReader(w.data()), is_inter)
            assert dataclasses.asdict(back) == dataclasses.asdict(p)


def test_grain_estimate_and_denoise_equal_jax():
    y = _noisy_clip(1)[0][0]
    got = analysis.estimate_grain_params(y, 8, seed=45231)
    want = jax_analysis.estimate_grain_params(y, 8, seed=45231)
    assert got.apply_grain and dataclasses.asdict(got) == \
        dataclasses.asdict(want)
    for frame in (_noisy_clip(1)[0], make_clip(w=128, h=64, frames=1,
                                               seed=3)[0]):
        nc = analysis.classify_picture_noise(frame[0])
        assert nc == jax_analysis.classify_picture_noise(frame[0])
        for qp in (20, 50):
            got = analysis.denoise_source(*frame, nc, qp)
            want = jax_analysis.denoise_source(*frame, nc, qp)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
    assert analysis.classify_picture_noise(_noisy_clip(1)[0][0]) == 4


def _jax_cfg(film_grain=0, denoise=False, levels=0):
    args = SimpleNamespace(width=128, height=64, qp=40, bit_depth=8,
                           intra_period=-1, fps=30, film_grain=film_grain,
                           enable_denoise=denoise, preset=5,
                           hierarchical_levels=levels, tbr=0, lad=0,
                           backend="host")
    return jax_preset_config(args)


def _display(enc_cls, cfg, frames):
    """(TUs, display recons, the encoder) of one stream."""
    enc = enc_cls(cfg)
    tus, recons = [], []
    for f in frames + [None]:
        if f is None:
            enc.flush()
        else:
            enc.send_picture(*f)
        while (pkt := enc.get_packet()) is not None:
            tus.append(pkt[0])
            if pkt[1] is not None:
                recons.append(pkt[1])
    return tus, recons, enc


# name: (clip, film grain level, denoise, hierarchical levels)
STREAMS = {
    "flat_grain_ra": (lambda: make_clip(w=128, h=64, frames=5, seed=3), 10,
                      False, 2),
    "auto_grain": (lambda: _noisy_clip(3), -1, False, 0),
    "denoise": (lambda: _noisy_clip(3), 0, True, 0),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_grain_denoise_stream_byte_identical(name):
    make, fg, dn, levels = STREAMS[name]
    frames = make()
    jcfg = _jax_cfg(fg, dn, levels)
    want = jax_encode_ivf(frames, jcfg)
    got = encode_ivf(frames, config_from_jax(dataclasses.asdict(jcfg),
                                             device="cpu"))
    assert got == want
    plain = encode_ivf(frames, config_from_jax(dataclasses.asdict(
        _jax_cfg(levels=levels)), device="cpu"))
    assert got != plain                 # the tool changed the stream


def test_grained_display_recon_equals_jax_and_decoder():
    frames = make_clip(w=128, h=64, frames=5, seed=3)
    jcfg = _jax_cfg(film_grain=10, levels=2)
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    tus, recons, enc = _display(Encoder, cfg, frames)
    jtus, jrecons, _ = _display(JaxEncoder, jcfg, frames)
    assert tus == jtus and len(recons) == len(jrecons) == 5
    buf = io.BytesIO(encode_ivf(frames, cfg))
    decoded = decode_ivf(buf)
    for mine, ref, dec in zip(recons, jrecons, decoded):
        for a, b, c in zip(mine, ref, dec):
            assert np.array_equal(a, b) and np.array_equal(a, c)
    # the reference slots stay grain-free: the same encode without grain
    # keeps the same slots, and its display differs
    _, plain, penc = _display(Encoder, dataclasses.replace(
        cfg, film_grain_strength=0), frames)
    for a, b in zip(enc._slots, penc._slots):
        for p, q in zip(a, b):
            assert torch.equal(torch.as_tensor(p), torch.as_tensor(q))
    assert not np.array_equal(plain[0][0], recons[0][0])
