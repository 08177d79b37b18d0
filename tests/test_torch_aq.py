"""Adaptive quantization in the port (svt_av1_tpu_torch) against the JAX
package.

The analysis functions behind it (variance AQ's per-SB qindex map, the
content classes that shape it, TPL AQ's MV-propagated offsets over a
mini-GOP) are NumPy float64 in both packages and must agree exactly; a
last-ulp difference would move an SB by a whole delta-q step. The streams
go through the port's ``encode_ivf`` on the CPU and through the JAX
package's with the host backend, and the IVF bytes must be identical
(tolerance 0): variance AQ (1) on all-intra and random-access streams,
with 2 tile columns, on the non-fused inter path of preset 1, and TPL AQ
(2) on a hier-3 pyramid.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.pipeline import analysis as jax_analysis
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.pipeline import analysis
from svt_av1_tpu_torch.pipeline import inter as tinter
from svt_av1_tpu_torch.pipeline import wavefront as twf
from svt_av1_tpu_torch.pipeline.common import pad_frame_planes
from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
from svt_av1_tpu_torch.utils.clip import make_clip
from tests.torch_threads import one_torch_thread  # noqa: F401


def _jax_cfg(w, h, preset, levels, intra_period=-1, **extra):
    args = SimpleNamespace(width=w, height=h, qp=40, bit_depth=8,
                           intra_period=intra_period, fps=30, film_grain=0,
                           preset=preset, hierarchical_levels=levels, tbr=0,
                           lad=0, backend="host")
    return dataclasses.replace(jax_preset_config(args), **extra)


def _padded(frames):
    return [pad_frame_planes(*f, dtype=np.int32) for f in frames]


@pytest.mark.parametrize("bd", [8, 10])
def test_content_classes_and_variance_qmap_equal_jax(bd):
    frames = make_clip(w=256, h=192, frames=2, seed=5)
    if bd == 10:
        frames = [tuple(p.astype(np.uint16) << 2 for p in f) for f in frames]
    (y, u, v), (y1, _, _) = _padded(frames)
    sb_rows, sb_cols = 3, 4
    mine = analysis.content_classes(y, u, v, sb_rows, sb_cols, bd)
    ref = jax_analysis.content_classes(y, u, v, sb_rows, sb_cols, bd)
    for f in dataclasses.fields(mine):
        assert np.array_equal(getattr(mine, f.name), getattr(ref, f.name))
    for prev in (None, y1):
        got = analysis.variance_qmap(y, sb_rows, sb_cols, 120, 2,
                                     prev_y=prev, classes=mine)
        want = jax_analysis.variance_qmap(y, sb_rows, sb_cols, 120, 2,
                                          prev_y=prev, classes=ref)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert len(np.unique(got)) > 1          # a real map, not flat


def test_tpl_group_qmaps_equal_jax():
    frames = make_clip(w=256, h=128, frames=9, seed=3)
    lumas = [f[0] for f in frames]
    got = analysis.tpl_group_qmaps(lumas[1:], 120, 2, 2, 4,
                                   prev_luma=lumas[0])
    want = jax_analysis.tpl_group_qmaps(lumas[1:], 120, 2, 2, 4,
                                        prev_luma=lumas[0])
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert any(np.any(g) for g in got)           # some frame has deltas


def _qmaps_of(frames, cfg):
    """encode_ivf with the port's key and inter frames' AQ maps
    recorded (None where a frame coded flat)."""
    seen = []

    def spy(cls):
        orig = cls.encode_compute

        def call(self, *a, **k):
            out = orig(self, *a, **k)
            seen.append(self.qmap)
            return out
        return orig, call

    patches = [(cls, *spy(cls)) for cls in (twf.WavefrontIntraEncoder,
                                            tinter.InterFrameEncoder)]
    for cls, _, call in patches:
        cls.encode_compute = call
    try:
        ivf = encode_ivf(frames, cfg)
    finally:
        for cls, orig, _ in patches:
            cls.encode_compute = orig
    return ivf, seen


# name: (w, h, frames, preset, hierarchical levels, intra period, extra)
STREAMS = {
    "aq1_all_intra": (256, 128, 2, 5, 0, 0, dict(adaptive_quantization=1)),
    "aq1_ra_hier2_2tiles": (256, 128, 5, 5, 2, -1,
                            dict(adaptive_quantization=1,
                                 tile_cols_log2=1)),
    "aq2_ra_hier3": (256, 128, 9, 5, 3, -1, dict(adaptive_quantization=2)),
    # the interpolation-filter search on every inter shape group, with
    # per-lane qindex through the filter recode and chroma
    "aq1_preset1": (128, 64, 3, 1, 2, -1, dict(adaptive_quantization=1)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_aq_stream_byte_identical(name):
    w, h, n, preset, levels, period, extra = STREAMS[name]
    jcfg = _jax_cfg(w, h, preset, levels, period, **extra)
    frames = make_clip(w=w, h=h, frames=n, seed=3)
    want = jax_encode_ivf(frames, jcfg)
    got, qmaps = _qmaps_of(frames, config_from_jax(dataclasses.asdict(jcfg),
                                                   device="cpu"))
    assert got == want
    # the streams carry per-SB deltas: TPL AQ on some inter frame (the key
    # frame codes flat under it), variance AQ on every frame
    coded = [q for q in qmaps if q is not None]
    if extra["adaptive_quantization"] == 2:
        assert qmaps[0] is None and coded
    else:
        assert len(coded) == len(qmaps)
    assert any(len(np.unique(q)) > 1 for q in coded)
