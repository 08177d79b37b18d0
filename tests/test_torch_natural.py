"""Natural content through the port: ``svt_av1_tpu_torch.utils.natural``
(the clips of a real photograph shipped in the installed ``dm_control``
package) against the JAX package's module, the twins of
``tests/test_tpl_aq.py``'s two natural-content TPL AQ tests through the
port's encoder and decoder on the CPU, and one natural-content stream
equal to the JAX host encoder's (exact). Every test skips where the
photograph is absent."""

import dataclasses
import io

import numpy as np
import pytest

from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu.utils import natural as jax_natural
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.pipeline import analysis
from svt_av1_tpu_torch.pipeline.decode import decode_ivf
from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
from svt_av1_tpu_torch.utils import natural
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not natural.available(),
                                reason="natural-content asset not present")


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _bd_point(frames, cfg):
    iv = encode_ivf(frames, cfg)
    decs = decode_ivf(io.BytesIO(iv))
    return len(iv), np.mean([_psnr(f[0], d[0]) for f, d in zip(frames, decs)])


@pytest.mark.parametrize("clip,kw", [
    ("natural_clip", dict(w=96, h=64, frames=3, pan=(2, 4))),
    ("occluder_clip", dict(w=128, h=64, frames=3, patch=(32, 48)))])
def test_clips_equal_the_jax_package(clip, kw):
    assert natural.available() == jax_natural.available()
    mine = getattr(natural, clip)(**kw)
    want = getattr(jax_natural, clip)(**kw)
    assert len(mine) == len(want)
    for f, g in zip(mine, want):
        for a, b in zip(f, g):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_tpl_aq_natural_pan_is_neutral():
    """A uniform natural pan has no reference heterogeneity, so the TPL
    map stays (near-)empty: bits and quality within noise of flat q."""
    frames = natural.natural_clip(448, 256, frames=9, pan=(2, 4))
    cfg0 = EncoderConfig(width=448, height=256, qp=45,
                         hierarchical_levels=3, adaptive_quantization=0,
                         device="cpu")
    cfg2 = dataclasses.replace(cfg0, adaptive_quantization=2)
    b0, p0 = _bd_point(frames, cfg0)
    b2, p2 = _bd_point(frames, cfg2)
    assert b2 <= b0 * 1.01 and p2 >= p0 - 0.05, (b0, p0, b2, p2)


def test_tpl_aq_structured_on_natural_occlusion():
    """Static natural background + moving occluder: the anchor's map
    coarsens the occluder's corridor, display-order leaves get empty maps,
    and the encode stays near the flat-q RD point."""
    frames = natural.occluder_clip(448, 256, frames=9)
    lumas = [f[0] for f in frames]
    maps = analysis.tpl_group_qmaps(lumas[1:], 120, 2, 4, 7,
                                    prev_luma=lumas[0])
    assert all(np.all(maps[i] == 0) for i in (0, 2, 4, 6))
    assert (maps[-1] != 0).sum() > 0
    band = maps[-1][1:3, :].mean()      # corridor rows (patch at h/2)
    outer = maps[-1][[0, 3], :].mean()  # stable background rows
    assert band > outer
    cfg0 = EncoderConfig(width=448, height=256, qp=45,
                         hierarchical_levels=3, adaptive_quantization=0,
                         device="cpu")
    cfg2 = dataclasses.replace(cfg0, adaptive_quantization=2)
    b0, p0 = _bd_point(frames, cfg0)
    b2, p2 = _bd_point(frames, cfg2)
    assert b2 <= b0 * 1.02 and p2 >= p0, (b0, p0, b2, p2)


def test_natural_stream_equals_jax_host():
    """A natural pan (all 13 intra modes with the edge filter, a compound
    B frame, TPL AQ) encodes to the JAX host stream byte for byte."""
    frames = natural.natural_clip(192, 128, frames=3, pan=(2, 3))
    jcfg = JaxConfig(width=192, height=128, qp=40, hierarchical_levels=1,
                     adaptive_quantization=2)
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    assert encode_ivf(frames, cfg) == jax_encode_ivf(frames, jcfg)
