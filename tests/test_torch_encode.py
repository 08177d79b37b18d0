"""The port's all-intra encode (svt_av1_tpu_torch) against the JAX package.

The same frames go through ``svt_av1_tpu_torch.pipeline.encoder.encode_ivf``
on the CPU (the plain PyTorch versions of every kernel) and through
``svt_av1_tpu.pipeline.encoder.encode_ivf`` with the host backend; the IVF
bytes must be identical (tolerance 0: the pixel path is integer).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.app.cli import preset_config
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
from svt_av1_tpu_torch.utils.clip import make_clip
from tests.torch_threads import one_torch_thread  # noqa: F401

# all 13 intra modes with angle deltas: zones 1, 2 and 3 of the
# directional predictor without the edge filter (the fused frame program;
# tests/test_torch_directional.py runs it with the filter)
DIRECTIONAL = dict(fixed_partition_size=16, nfl=3,
                   intra_modes=tuple(range(13)), angle_deltas=(-2, 0, 3),
                   enable_intra_edge_filter=False)
CONFIGS = {
    "preset5": {},
    "preset5_2tiles": dict(tile_cols_log2=1),
    "fixed16_directional": DIRECTIONAL,
}


def _jax_cfg(w, h, extra):
    args = SimpleNamespace(width=w, height=h, qp=40, bit_depth=8,
                           intra_period=0, fps=30, film_grain=0, preset=5,
                           hierarchical_levels=0, tbr=0, lad=0,
                           backend="host")
    return dataclasses.replace(jax_preset_config(args), **extra)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("w,h", [(128, 64), (200, 120)])
def test_all_intra_stream_byte_identical(w, h, name):
    frames = make_clip(w=w, h=h, frames=2, seed=3)
    jcfg = _jax_cfg(w, h, CONFIGS[name])
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    assert cfg.tile_cols_log2 == jcfg.tile_cols_log2
    want = jax_encode_ivf(frames, jcfg)
    got = encode_ivf(frames, cfg)
    assert len(got) == len(want)
    assert got == want


def test_preset_config_matches_jax():
    """The port's preset ladder equals the JAX CLI's, field by field."""
    for preset in range(9):
        args = SimpleNamespace(width=1920, height=1080, qp=40, bit_depth=8,
                               intra_period=0, fps=30, film_grain=0,
                               preset=preset, hierarchical_levels=0, tbr=0,
                               lad=0, backend="host")
        jcfg = jax_preset_config(args)
        want = dataclasses.asdict(jcfg)
        want.pop("backend")
        got = dataclasses.asdict(preset_config(
            width=1920, height=1080, preset=preset, intra_period=0,
            device="cpu"))
        got.pop("device")
        assert got == want, preset


def test_make_clip_matches_bench():
    import bench
    for (a, b) in zip(make_clip(w=96, h=64, frames=2),
                      bench.make_clip(w=96, h=64, frames=2)):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb)
