"""SATD partition scoring in the port (svt_av1_tpu_torch) against the JAX
package.

``ops/device_md.satd_modes`` (the min over modes of the size-matched
Hadamard SATD of the open-loop intra residual, exact float64 products on
the torch device) must equal the JAX package's device twin
``satd_modes_dev`` and its host twin ``rd._satd_modes_host`` at every
square and rectangular size the intra partition DP scores, at 8 and 10
bits, including frame-edge lanes. The DP's leaf map under
``intra_dp_satd`` equals the JAX package's, and so do SATD-DP streams
(all-intra and random access, through ``encode_ivf`` on the CPU against
the JAX host backend; tolerance 0).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.ops import intra as jax_intra
from svt_av1_tpu.ops.device_md import satd_modes_dev
from svt_av1_tpu.pipeline import avail as jax_avail
from svt_av1_tpu.pipeline import rd as jax_rd
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.ops.device_md import satd_modes
from svt_av1_tpu_torch.pipeline import rd
from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
from svt_av1_tpu_torch.utils.clip import make_clip
from tests.torch_threads import one_torch_thread  # noqa: F401

# the DP's candidate modes (rd.choose_partition's trimmed set)
MODES = (0, 1, 2, 3, 7, 9, 12)
# every size the DP scores: the squares, the HORZ/VERT halves, the 4:1
# strips of 32 and 64
SIZES = (8, 16, 32, 64, (16, 8), (8, 16), (32, 16), (16, 32), (64, 32),
         (32, 64), (32, 8), (8, 32), (64, 16), (16, 64))


def _jax_inputs(src, xs, ys, size, bd):
    """The JAX package's depth inputs (rd._analyze_depth_satd's prep)."""
    bw, bh = (size, size) if isinstance(size, int) else size
    h, w = src.shape
    ha, hl = ys > 0, xs > 0
    htr = jax_avail.has_top_right_wh_vec(ys >> 2, xs >> 2, bw >> 2,
                                         bh >> 2, w // 4)
    hbl = jax_avail.has_bottom_left_wh_vec(ys >> 2, xs >> 2, bw >> 2,
                                           bh >> 2, h // 4)
    above1, left1 = jax_intra.prepare_edges_av1(
        src, xs, ys, bw, bh, ha, hl, htr, hbl, bd=bd, max_w=w, max_h=h)
    iy = ys[:, None, None] + np.arange(bh)[None, :, None]
    ix = xs[:, None, None] + np.arange(bw)[None, None, :]
    return src[iy, ix].astype(np.int64), above1, left1, ha, hl


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_satd_modes_equal_jax(size, bd):
    rng = np.random.default_rng(bd * 100 + SIZES.index(size))
    # noise over a smooth ramp: the modes' SATDs differ, and saturated
    # residuals (|r| near 2^bd - 1) test the exactness bound
    yy, xx = np.mgrid[0:128, 0:192]
    src = (((xx + 2 * yy) << (bd - 8)) % (1 << bd)
           + rng.integers(-(1 << bd) // 8, (1 << bd) // 8, (128, 192)))
    src = np.clip(src, 0, (1 << bd) - 1).astype(np.int32)
    src[64:, 96:] = rng.integers(0, 2, (64, 96)) * ((1 << bd) - 1)
    bw, bh = (size, size) if isinstance(size, int) else size
    gy, gx = np.mgrid[0:128 - bh + 1:bh, 0:192 - bw + 1:bw]
    xs, ys = gx.reshape(-1), gy.reshape(-1)
    ins = rd._depth_inputs(src, xs, ys, size, 192, 128, 48, 32, bd)
    ref_ins = _jax_inputs(src, xs, ys, size, bd)
    for a, b in zip(ins, ref_ins):
        assert np.array_equal(a, b)
    got = satd_modes(*ins, MODES, size, bd, device="cpu").numpy()
    assert got.dtype == np.int64 and got.shape == xs.shape
    assert np.array_equal(got, jax_rd._satd_modes_host(*ref_ins, MODES,
                                                       size, bd))
    assert np.array_equal(got, satd_modes_dev(*ref_ins, MODES, size, bd))


def _jax_cfg(w, h, levels, intra_period, preset=5):
    args = SimpleNamespace(width=w, height=h, qp=40, bit_depth=8,
                           intra_period=intra_period, fps=30, film_grain=0,
                           preset=preset, hierarchical_levels=levels, tbr=0,
                           lad=0, backend="host")
    return dataclasses.replace(jax_preset_config(args), intra_dp_satd=True)


@pytest.mark.parametrize("preset", [3, 5])
def test_satd_partition_dp_equals_jax(preset):
    y = make_clip(w=256, h=192, frames=1, seed=3)[0][0]
    jcfg = _jax_cfg(256, 192, 0, 0, preset)
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    got = rd.choose_partition(y, cfg, 64, 48)
    want = jax_rd.choose_partition(y, jcfg, 64, 48)
    assert got == want
    flat = rd.choose_partition(y, dataclasses.replace(
        cfg, intra_dp_satd=False), 64, 48)
    assert got != flat                     # the SATD model chose its own


# name: (w, h, frames, hierarchical levels, intra period)
STREAMS = {"all_intra": (256, 128, 2, 0, 0),
           "ra_hier2": (256, 128, 5, 2, -1)}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_satd_dp_stream_byte_identical(name):
    w, h, n, levels, period = STREAMS[name]
    jcfg = _jax_cfg(w, h, levels, period)
    frames = make_clip(w=w, h=h, frames=n, seed=3)
    want = jax_encode_ivf(frames, jcfg)
    got = encode_ivf(frames, config_from_jax(dataclasses.asdict(jcfg),
                                             device="cpu"))
    assert got == want
