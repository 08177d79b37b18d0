"""The port's compile-check entry point (the counterpart of the JAX
package's ``__graft_entry__.entry``).

``entry()`` returns the flagship analysis step, the fused intra analysis
(mode decision + transform + quantize + recon distortion, the encoder's
per-block compute core), and a batch of 64 16x16 blocks to call it on, as
torch tensors on the device. On the card the step's quantizer is the
hand-written kernel of ``csrc/quant.cu``. The multi-device dry run of the
JAX entry (``dryrun_multichip``) comes with the multi-device slice.
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
