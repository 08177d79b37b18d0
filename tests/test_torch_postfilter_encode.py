"""Streams of the port with the in-loop post-filters (CDEF, loop
restoration) against the JAX package's host encoder.

On the CPU, tolerance 0: each stream equals ``encode_ivf`` of the JAX
package with ``backend="host"`` (NumPy CDEF and LR) byte for byte, and
the port's recon of every shown frame equals the JAX mirror decoder's
output of the port's own stream. The streams: the CLI presets 0 and 1
all-intra (CDEF, and LR at preset 0, on the per-wave key-frame loop), a
random-access hier-2 clip at preset 5 with both filters and 4 tile
columns (the fused frame program's key frame, then inter frames with the
filters on the device recon), and a 10-bit random-access clip with both
filters.
"""

import dataclasses
from types import SimpleNamespace

import pytest

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.utils.clip import make_clip
from svt_av1_tpu_torch.utils.trace import TRACER
from tests.test_torch_directional import (assert_decodes_to,
                                          encode_with_recons)
from tests.torch_threads import one_torch_thread  # noqa: F401

BOTH = dict(enable_cdef=True, enable_restoration=True)


def _jax_cfg(w, h, preset, intra_period, levels=0, bd=8, **extra):
    args = SimpleNamespace(width=w, height=h, qp=40, bit_depth=bd,
                           intra_period=intra_period, fps=30, film_grain=0,
                           preset=preset, hierarchical_levels=levels, tbr=0,
                           lad=0, backend="host")
    return dataclasses.replace(jax_preset_config(args), **extra)


# name: (width, height, frames, bit depth, JAX config)
STREAMS = {
    "preset1_all_intra": (128, 96, 2, 8, _jax_cfg(128, 96, 1, 0)),
    "preset0_all_intra": (128, 96, 1, 8, _jax_cfg(128, 96, 0, 0)),
    "ra_hier2_4tiles": (448, 128, 5, 8,
                        _jax_cfg(448, 128, 5, -1, 2, tile_cols_log2=2,
                                 **BOTH)),
    "ra_hier2_10bit": (128, 64, 3, 10,
                       _jax_cfg(128, 64, 5, -1, 2, bd=10, **BOTH)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_postfilter_stream_matches_host_and_decodes(name):
    w, h, n, bd, jcfg = STREAMS[name]
    frames = make_clip(w=w, h=h, frames=n, seed=3)
    if bd == 10:
        frames = [tuple(p.astype("uint16") << 2 for p in f) for f in frames]
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    assert cfg.enable_cdef and cfg.bit_depth == bd
    TRACER.enabled = True
    TRACER.reset()
    try:
        got, recons = encode_with_recons(frames, cfg)
    finally:
        TRACER.enabled = False
    spans = TRACER.summary()
    # both filters ran once on every frame the config enables them for
    assert spans["cdef"]["count"] == n
    assert spans.get("lr", {"count": 0})["count"] == \
        (n if cfg.enable_restoration else 0)
    assert got == jax_encode_ivf(frames, jcfg)
    assert len(recons) == n
    assert_decodes_to(got, recons)
