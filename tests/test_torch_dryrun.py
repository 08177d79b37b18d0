"""The port's multi-device dry run (``entry.dryrun_multichip``), the
counterpart of ``__graft_entry__.dryrun_multichip``: its three checks on
8 CPU devices, and its key frame and inter stream against the JAX
package's host encoder on the same inputs (exact). Without a card the
default (``device="cuda"``) raises rather than running on the CPU."""

import numpy as np
import pytest
import torch

from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu.pipeline.wavefront import \
    encode_keyframe_wavefront as jax_keyframe
from svt_av1_tpu_torch import entry
from tests.torch_threads import one_torch_thread  # noqa: F401


def _jax_inputs(n):
    """The dry run's inputs, drawn as ``dryrun_multichip`` draws them."""
    w, h = 64 * n, 128
    rng = np.random.default_rng(0)
    key = tuple(rng.integers(0, 256, s).astype(np.uint8)
                for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    base = rng.integers(0, 255, (h + 32, w + 32)).astype(np.uint8)
    frames = [(base[2 * t:2 * t + h, 3 * t:3 * t + w],
               np.full((h // 2, w // 2), 100 + 5 * t, np.uint8),
               np.full((h // 2, w // 2), 140, np.uint8))
              for t in range(3)]
    return w, h, key, frames


def test_dryrun_multichip_on_8_cpu_devices_equals_jax():
    out = entry.dryrun_multichip(8, device="cpu")
    w, h, key, frames = _jax_inputs(8)
    want, _, _ = jax_keyframe(*key, JaxConfig(
        width=w, height=h, qp=40, tile_cols_log2=3, fixed_partition_size=16,
        enable_intra_edge_filter=False))
    assert out["keyframe"] == want
    assert out["inter"] == jax_encode_ivf(frames, JaxConfig(
        width=w, height=h, qp=40, hierarchical_levels=2,
        fixed_partition_size=None))


def test_dryrun_multichip_takes_the_power_of_two_cut():
    """6 devices run as 4 (64 * 4 px wide), as the JAX dry run cuts."""
    out = entry.dryrun_multichip(6, device="cpu")
    w, h, key, _ = _jax_inputs(4)
    want, _, _ = jax_keyframe(*key, JaxConfig(
        width=w, height=h, qp=40, tile_cols_log2=2, fixed_partition_size=16,
        enable_intra_edge_filter=False))
    assert out["keyframe"] == want


def test_dryrun_multichip_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the dry run runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(8)
