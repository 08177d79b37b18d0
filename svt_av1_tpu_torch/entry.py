"""The port's compile-check entry point (the counterpart of the JAX
package's ``__graft_entry__.entry``).

``entry()`` returns the flagship analysis step, the fused intra analysis
(mode decision + transform + quantize + recon distortion, the encoder's
per-block compute core), and a batch of 64 16x16 blocks to call it on, as
torch tensors on the device. On the card the step's quantizer is the
hand-written kernel of ``csrc/quant.cu``.

``dryrun_multichip(n)`` runs the three multi-device paths of
``parallel/tiles.py`` on n shards of one device (``["cuda"] * n`` by
default) and holds each against the single-device encoder, as the JAX
entry's dry run does on its mesh.
"""

from __future__ import annotations

import numpy as np
import torch


def _example_batch(b: int = 64, size: int = 16):
    """The JAX entry's example batch, made from seed 0 with numpy: (src
    [b, size, size], above [b, 2 size], left [b, 2 size], top_left [b],
    have_above [b], have_left [b])."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (b, size, size)).astype(np.int32)
    above = rng.integers(0, 256, (b, 2 * size)).astype(np.int32)
    left = rng.integers(0, 256, (b, 2 * size)).astype(np.int32)
    tl = rng.integers(0, 256, b).astype(np.int32)
    ha = np.ones(b, dtype=bool)
    hl = np.ones(b, dtype=bool)
    return src, above, left, tl, ha, hl


def entry(device: str = "cuda"):
    """(fn, args): ``fn(*args)`` runs ``ops.device.intra_analysis_step``
    at size 16 and qindex 160 on ``device``. A CUDA device without a card
    raises; pass ``device="cpu"`` for the plain PyTorch versions."""
    from svt_av1_tpu_torch.ops.device import intra_analysis_step
    from svt_av1_tpu_torch.pipeline.encoder import check_device
    dev = check_device(device)

    def fn(src, above, left, tl, ha, hl):
        return intra_analysis_step(src, above, left, tl, ha, hl,
                                   size=16, qindex=160)

    args = tuple(torch.as_tensor(a, device=dev) for a in _example_batch())
    return fn, args


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The JAX entry's three multi-device checks at its sizes (64 n x 128,
    n the largest power of two <= ``n_devices``), each on ``[device] * n``
    and each held against the single-device encoder on ``device``:

    1. a key frame with one tile per device (halo ring, summed stats),
       byte-identical to ``encode_keyframe_wavefront``;
    2. a key + 2 inter frames (partition DP, a 2-level pyramid with
       compound prediction) with every shape group fanned out over the
       devices by column strip, byte-identical to ``encode_ivf``, and
       decoding to 3 frames;
    3. the distributed DLF on the decoded recon of frame 1 (seam edges
       from the neighbours' halos, overhang writes merged back, strip
       SSEs summed), equal to the host filter's planes and levels.

    A CUDA device without a card raises; pass ``device="cpu"`` for the
    plain PyTorch versions. Returns the key frame's TU and the inter
    stream (``keyframe``, ``inter``) and the DLF's levels (``dlf``)."""
    import io
    import math
    from svt_av1_tpu_torch.config import EncoderConfig
    from svt_av1_tpu_torch.ops import dlf
    from svt_av1_tpu_torch.parallel.tiles import (
        dlf_search_apply_sharded, encode_keyframe_tiles_sharded,
        make_sharded_shape_group_issue)
    from svt_av1_tpu_torch.pipeline.decode import decode_ivf
    from svt_av1_tpu_torch.pipeline.encoder import check_device, encode_ivf
    from svt_av1_tpu_torch.pipeline.wavefront import encode_keyframe_wavefront
    check_device(device)
    n = max(1, n_devices)
    while n & (n - 1):
        n -= 1                     # power-of-two tile columns
    devices = [device] * n

    w, h = 64 * n, 128
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    # the tile program carries no intra edge filter operands: the tool
    # stays off so that the sharded key frame uses its tile results
    cfg = EncoderConfig(width=w, height=h, qp=40,
                        tile_cols_log2=int(math.log2(n)),
                        fixed_partition_size=16,
                        enable_intra_edge_filter=False, device=device)
    tu_sharded, halo_ok, stats = encode_keyframe_tiles_sharded(
        y, u, v, cfg, devices)
    assert halo_ok, "halo exchange mismatch"
    tu_serial, _, _ = encode_keyframe_wavefront(y, u, v, cfg)
    assert tu_sharded == tu_serial, \
        "tile-sharded bitstream != single-device bitstream"
    assert stats > 0

    # --- 2: key + 2 inter frames, shape groups sharded by column strip
    base = rng.integers(0, 255, (h + 32, w + 32)).astype(np.uint8)
    frames = [(base[2 * t:2 * t + h, 3 * t:3 * t + w],
               np.full((h // 2, w // 2), 100 + 5 * t, np.uint8),
               np.full((h // 2, w // 2), 140, np.uint8))
              for t in range(3)]
    icfg = EncoderConfig(width=w, height=h, qp=40, hierarchical_levels=2,
                         fixed_partition_size=None, device=device)
    serial = encode_ivf(frames, icfg)
    sharded = encode_ivf(frames, icfg,
                         shape_group_issue=make_sharded_shape_group_issue(
                             devices, strip_w=w // n))
    assert sharded == serial, \
        "strip-sharded inter bitstream != single-device bitstream"
    decoded = decode_ivf(io.BytesIO(sharded))
    assert len(decoded) == 3

    # --- 3: distributed DLF on the decoded recon
    mi_cols, mi_rows = w // 4, h // 4
    leaf_sizes = {(r, c): 16 for r in range(0, mi_rows, 4)
                  for c in range(0, mi_cols, 4)}
    rec = [np.asarray(p, dtype=np.uint8) for p in decoded[1]]
    src = [p.astype(np.int64) for p in frames[1]]
    levels_host = dlf.pick_levels(rec, src, leaf_sizes, mi_rows, mi_cols,
                                  180, 8)
    host_planes = [p.copy() for p in rec]
    dlf.loop_filter_frame(host_planes, leaf_sizes, mi_rows, mi_cols,
                          levels_host, bd=8)
    planes, levels = dlf_search_apply_sharded(
        rec, src, leaf_sizes, mi_rows, mi_cols, 180, 8, devices)
    assert levels == levels_host, "sharded DLF levels diverge"
    for a, b in zip(planes, host_planes):
        assert np.array_equal(a, b), "sharded DLF planes diverge"
    return {"keyframe": tu_sharded, "inter": sharded, "dlf": levels}
