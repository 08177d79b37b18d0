"""Inputs and probes for the tests of the port's fused keyframe tile
programs (tests/test_torch_tile.py on the CPU, tests/test_torch_cuda.py
on the card). Imports nothing of JAX.
"""

import numpy as np
import torch

from svt_av1_tpu_torch.pipeline import common
from svt_av1_tpu_torch.pipeline.wavefront import WavefrontIntraEncoder

DECISIONS = ("y_mode", "y_delta", "uv_mode", "uv_delta", "alpha_u",
             "alpha_v", "y_tx_type", "eobs")


def mixed_content():
    """A 192x128 frame whose partition DP mixes leaf sizes: a ramp, a
    noise patch and a flat corner (the content of the JAX package's mixed
    fused-program test)."""
    rng = np.random.default_rng(7)
    h, w = 128, 192
    y = np.zeros((h, w), dtype=np.uint8)
    y[:] = (np.arange(w)[None, :] // 3 % 256).astype(np.uint8)
    y[40:80, 40:100] = rng.integers(0, 256, (40, 60))
    y[90:, 120:] = 128
    u = rng.integers(100, 160, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(100, 160, (h // 2, w // 2)).astype(np.uint8)
    return y, u, v


def _host(p):
    return p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def keyframe_state(frame, cfg, fused=True, waves=None):
    """One key frame's compute through the port's WavefrontIntraEncoder:
    every tile's decisions, its resolved coefficients (one array per
    plane, flattened in leaf order) and the frame's recon planes, all
    numpy. ``fused=False`` runs
    every tile through the per-wave loop; ``waves``: a replacement for
    the dependency-wave function (same signature)."""
    enc = WavefrontIntraEncoder(cfg)
    enc._fused = fused
    if waves is not None:
        enc._dependency_waves = waves
    enc.encode_compute(*frame)
    tiles = []
    for st in enc._pkg["tile_states"]:
        t = {k: np.array(st[k]) for k in DECISIONS}
        for p in range(3):
            t[f"qc{p}"] = np.concatenate([common.resolve_qc(q).ravel()
                                          for q in st["qcoeff"][p]])
        tiles.append(t)
    return tiles, [_host(p) for p in enc.recon]


def assert_same_state(got, want) -> None:
    (gt, gr), (wt, wr) = got, want
    assert len(gt) == len(wt)
    for a, b in zip(gt, wt):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k
    for a, b in zip(gr, wr):
        assert a.dtype == b.dtype and np.array_equal(a, b)
