"""The port's multi-device layer (``svt_av1_tpu_torch/parallel/tiles.py``)
on 8 CPU devices (``["cpu"] * 8``), against the JAX package: the twins of
``tests/test_multichip.py``.

- The tile-sharded key frame's TU equals the JAX host encoder's
  (``encode_keyframe_wavefront``), its stats the JAX sharded function's
  on the 8-device CPU mesh, and the serial encoder took the 8 tile
  results (``halo_ok``/stats alone prove nothing: with the intra edge
  filter on they describe discarded work).
- The distributed DLF equals the JAX host ``pick_levels`` +
  ``loop_filter_frame`` at 8 and 10 bits (at 10 bits the host's scaled
  thresholds, which the JAX sharded DLF lacks).
- A low-delay P stream with every shape group fanned out over 8 column
  strips equals the JAX host stream, and the port's decoder decodes it.
- ``make_tile_body`` equals the port's class-step program on a uniform
  tile.

Inputs come from seeds with numpy; every comparison is exact.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu.ops import dlf as jdlf
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu.pipeline.wavefront import \
    encode_keyframe_wavefront as jax_keyframe
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.ops import device_tile as tdt
from svt_av1_tpu_torch.ops import step_graphs
from svt_av1_tpu_torch.parallel import tiles
from svt_av1_tpu_torch.pipeline.common import intra_candidates
from svt_av1_tpu_torch.pipeline.decode import decode_ivf
from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
from svt_av1_tpu_torch.pipeline.wavefront import WavefrontIntraEncoder
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_tile_cases import keyframe_state

DEVICES = ["cpu"] * 8
# the stats of the JAX package's svt_av1_tpu.parallel.tiles.
# encode_keyframe_tiles_sharded on the 8-device CPU mesh for the key frame
# of test_keyframe_tiles_sharded_equals_jax (_clip(512, 128, 1), qp 40,
# tile_cols_log2 3, fixed_partition_size 16, edge filter off): the sum of
# |luma levels| over every row of each tile program's output, its padding
# row included
JAX_SHARDED_STATS = 96545


def _clip(w, h, n, seed=9):
    """tests/test_multichip.py's clip."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h + 64, w + 64)).astype(np.uint8)
    out = []
    for t in range(n):
        y = base[2 * t:2 * t + h, 3 * t:3 * t + w]
        u = np.full(((h + 1) // 2, (w + 1) // 2), 100 + 5 * t, np.uint8)
        v = rng.integers(100, 160, ((h + 1) // 2, (w + 1) // 2)) \
            .astype(np.uint8)
        out.append((y, u, v))
    return out


def test_keyframe_tiles_sharded_equals_jax():
    w, h = 64 * 8, 128
    (y, u, v), = _clip(w, h, 1)
    jcfg = JaxConfig(width=w, height=h, qp=40, tile_cols_log2=3,
                     fixed_partition_size=16, enable_intra_edge_filter=False)
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    report = {}
    tu, halo_ok, stats = tiles.encode_keyframe_tiles_sharded(
        y, u, v, cfg, DEVICES, report=report)
    assert halo_ok
    assert stats == JAX_SHARDED_STATS
    assert report["injected"] == 8
    assert [t["device"] for t in report["tiles"]] == DEVICES
    want, _, _ = jax_keyframe(y, u, v, jcfg)
    assert tu == want


def _blocky(src, step=16):
    """Blockwise-mean version of src (a deblockable reconstruction)."""
    h, w = src.shape
    out = src.astype(np.int64).copy()
    for r in range(0, h, step):
        for c in range(0, w, step):
            out[r:r + step, c:c + step] = \
                int(src[r:r + step, c:c + step].mean())
    return out.astype(src.dtype)


@pytest.mark.parametrize("bd", [8, 10])
def test_dlf_sharded_matches_jax_host(bd):
    w, h = 64 * 8, 64
    mi_cols, mi_rows = w // 4, h // 4
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    srcs = [np.clip(120 + 60 * np.sin(xx / 37) + 40 * np.cos(yy / 23),
                    0, 255).astype(np.uint8),
            np.clip(110 + 40 * np.sin((xx + yy)[: h // 2, : w // 2] / 31),
                    0, 255).astype(np.uint8),
            np.clip(130 + 40 * np.cos((xx - yy)[: h // 2, : w // 2] / 29),
                    0, 255).astype(np.uint8)]
    if bd == 10:
        srcs = [p.astype(np.uint16) << 2 for p in srcs]
    rec = [_blocky(p) for p in srcs]
    src = [p.astype(np.int64) for p in srcs]
    leaf_sizes = {(r, c): 16 for r in range(0, mi_rows, 4)
                  for c in range(0, mi_cols, 4)}
    levels_host = jdlf.pick_levels(rec, src, leaf_sizes, mi_rows, mi_cols,
                                   180, bd)
    host_planes = [p.copy() for p in rec]
    jdlf.loop_filter_frame(host_planes, leaf_sizes, mi_rows, mi_cols,
                           levels_host, bd=bd)
    assert levels_host[0] > 0, "test content must engage the filter"
    planes, levels = tiles.dlf_search_apply_sharded(
        rec, src, leaf_sizes, mi_rows, mi_cols, 180, bd, DEVICES)
    assert levels == levels_host
    for got, want in zip(planes, host_planes):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_inter_shape_group_sharded_equals_jax():
    """Low-delay P with every shape group fanned out over 8 column strips
    equals the JAX host stream."""
    w, h = 64 * 8, 64
    frames = _clip(w, h, 3)
    jcfg = JaxConfig(width=w, height=h, qp=40, hierarchical_levels=0,
                     fixed_partition_size=16)
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    issue = tiles.make_sharded_shape_group_issue(DEVICES, strip_w=w // 8)
    groups = []

    def counted(*a, **k):
        groups.append(len(a[7]))
        return issue(*a, **k)

    sharded = encode_ivf(frames, cfg, shape_group_issue=counted)
    assert groups == [128, 128]          # one 16x16 group per inter frame
    assert sharded == jax_encode_ivf(frames, jcfg)
    assert len(decode_ivf(io.BytesIO(sharded))) == 3


def test_sharded_shape_group_refuses_layouts_jax_gets_wrong():
    """Strips that cut 64-px blocks, and strips that do not tile the
    recon width (the JAX program would return a plane of another
    width), are refused."""
    with pytest.raises(ValueError, match="64-px"):
        tiles.make_sharded_shape_group_issue(DEVICES, strip_w=96)
    (y, u, v), = _clip(512, 64, 1)
    recon = [torch.zeros(p.shape, dtype=torch.uint8) for p in (y, u, v)]
    issue = tiles.make_sharded_shape_group_issue(["cpu"] * 4, strip_w=64)
    with pytest.raises(ValueError, match="do not tile"):
        issue(recon, [], [], [], (), u, v, [0], [0], 16, None, 0.0, (), ())


def test_make_tile_body_equals_the_class_step_program():
    """The uniform program's decisions, levels and recon equal the fused
    class-step program's (analyze_tile_fused) on one tile of 16x16
    leaves; its padding row holds the first leaf's outputs."""
    (y, u, v), = _clip(128, 64, 1, seed=4)
    cfg = config_from_jax(dataclasses.asdict(JaxConfig(
        width=128, height=64, qp=40, intra_modes=(0, 1, 2, 12),
        fixed_partition_size=16, enable_dlf=False)), device="cpu")
    (want,), want_recon = keyframe_state((y, u, v), cfg)

    enc = WavefrontIntraEncoder(cfg)
    frame_src = [p.astype(np.int32) for p in (y, u, v)]
    frame_recon = [np.zeros(p.shape, np.uint8) for p in frame_src]
    enc._enter_tile(frame_src, frame_recon, (0, 0, 16, 32, 1, 2))
    enc.leaf_sizes = enc._fixed_leaf_sizes(16)
    enc.max_wh = [(128, 64), (64, 32), (64, 32)]
    enc.leaf_index = {(r, c): i for i, (r, c, _) in
                      enumerate(enc._leaves())}
    key, args = tdt.tile_body_operands(enc, intra_candidates(cfg))
    ry, ru, rv, out = tdt.make_tile_body(*key)(
        *(torch.as_tensor(a) for a in args),
        runner=step_graphs.ClassGraphs())
    n = key[7]
    names = {"y_tt": "y_tx_type"}
    for k in tdt.TILE_BODY_KEYS[:7]:
        assert np.array_equal(out[k][:n].numpy(), want[names.get(k, k)]), k
    for p, k in enumerate(("eob_y", "eob_u", "eob_v")):
        assert np.array_equal(out[k][:n].numpy(), want["eobs"][p]), k
        assert np.array_equal(
            out[("qc_y", "qc_u", "qc_v")[p]][:n].numpy().ravel(),
            want[f"qc{p}"]), p
    for got, ref in zip((ry, ru, rv), want_recon):
        assert np.array_equal(got.numpy(), ref)
    assert args[5].sum(axis=1).min() < key[6]       # a wave is not full
    for k in tdt.TILE_BODY_KEYS:
        assert torch.equal(out[k][n], out[k][0]), k
