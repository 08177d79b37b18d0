"""svt_av1_tpu_torch — the PyTorch/CUDA port of the svt_av1_tpu AV1 encoder.

A second package beside the JAX reference (``svt_av1_tpu``), with the same
module names so that counterparts are easy to find. It imports torch and
numpy only — nothing of JAX and nothing of the JAX package; the host
modules it needs (bitstream, entropy, host oracles, tables, the native
range coder) are its own copies.

- ``ops/device.py``, ``ops/device_md.py``: the pixel path as torch tensor
  code on an explicit device; the quantizer is a hand-written CUDA kernel
  (``csrc/quant.cu``) with its plain PyTorch version beside it.
- ``pipeline/``: partition RD (``rd``), the wavefront keyframe encoder and
  the streaming ``Encoder`` / ``encode_ivf``.
- ``config.EncoderConfig``: the JAX package's fields with ``device`` in
  place of ``backend``.
- ``parallel/tiles.py``: the multi-device layer over a list of torch
  devices (tile-sharded key frames, strip-sharded shape groups, the
  distributed DLF).
- The entry points: ``app/`` (``python -m svt_av1_tpu_torch.app``, the
  decoder CLI, the warmup tool), ``api`` (the ``EbApi.h`` lifecycle),
  ``entry`` (the analysis step); and the port's own verification, the
  mirror decoder ``pipeline/decode`` and the checker ``verify/indep``.
"""

__version__ = "0.1.0"

from svt_av1_tpu_torch.config import EncoderConfig  # noqa: F401
