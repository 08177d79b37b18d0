"""The port's 10-bit deblocking against the JAX package's host filter.

The filter thresholds scale with the bit depth (``blimit``, ``limit`` and
``thresh`` shifted left by ``bd - 8``, as the host's ``_edge_filter``
does). Checked on the CPU, tolerance 0: the whole-frame level search +
apply ``dlf_search_apply_dev`` at bd 10 against ``dlf.pick_levels`` +
``loop_filter_frame``, and a 10-bit all-intra stream against the JAX host
backend, with the port's recon equal to the mirror decode of its stream.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.ops import dlf as jdlf
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.utils.clip import make_clip
from tests.test_torch_directional import (assert_decodes_to,
                                          encode_with_recons)
from tests.test_torch_dlf import _blocky
from tests.torch_threads import one_torch_thread  # noqa: F401


def _leaf_map(mi_rows, mi_cols):
    """Mixed 16 / 8 / 16x8 leaves (tests/test_torch_dlf.py's map)."""
    leaf = {}
    for r in range(0, mi_rows, 4):
        for c in range(0, mi_cols, 4):
            if (r + c) % 8 == 0:
                leaf[(r, c)] = 16
            elif c % 8 == 4:
                for dr in (0, 2):
                    leaf[(r + dr, c)] = (16, 8)
            else:
                for dr in (0, 2):
                    for dc in (0, 2):
                        leaf[(r + dr, c + dc)] = 8
    return leaf


@pytest.mark.parametrize("qindex", [200, 90])
def test_dlf_search_apply_10bit_matches_host(qindex):
    h, w = 64, 128
    rec8, src8 = _blocky(h, w, seed=qindex)
    rng = np.random.default_rng(qindex)
    # 10-bit planes: the 8-bit content times 4 plus the two low bits
    rec = [((p.astype(np.int32) << 2) + rng.integers(0, 4, p.shape))
           .astype(np.uint16) for p in rec8]
    src = [(p << 2) + rng.integers(0, 4, p.shape).astype(np.int32)
           for p in src8]
    mi_rows, mi_cols = h // 4, w // 4
    leaf = _leaf_map(mi_rows, mi_cols)
    want = [p.copy() for p in rec]
    levels = jdlf.pick_levels(want, src, leaf, mi_rows, mi_cols, qindex, 10)
    jdlf.loop_filter_frame(want, leaf, mi_rows, mi_cols, levels, bd=10)
    got = [p.copy() for p in rec]
    lv = dev.dlf_search_apply_dev(got, src, leaf, mi_rows, mi_cols, qindex,
                                  10, device="cpu")
    assert lv == tuple(levels)
    assert lv[0] > 0, "the filter should fire on blocky content"
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_10bit_stream_matches_host_and_decodes():
    """Preset 5 all-intra at 10 bits (the fused frame program, DLF on the
    device recon): the stream equals the JAX host backend's and decodes
    to the port's recon."""
    w, h, n = 128, 64, 2
    frames = [tuple(p.astype(np.uint16) << 2 for p in f)
              for f in make_clip(w=w, h=h, frames=n, seed=3)]
    args = SimpleNamespace(width=w, height=h, qp=40, bit_depth=10,
                           intra_period=0, fps=30, film_grain=0, preset=5,
                           hierarchical_levels=0, tbr=0, lad=0,
                           backend="host")
    jcfg = jax_preset_config(args)
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    assert cfg.enable_dlf and cfg.bit_depth == 10
    got, recons = encode_with_recons(frames, cfg)
    assert got == jax_encode_ivf(frames, jcfg)
    assert len(recons) == n
    assert_decodes_to(got, recons)
