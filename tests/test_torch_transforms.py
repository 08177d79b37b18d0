"""The port's 2D transforms against the JAX package's device twins.

``svt_av1_tpu_torch.ops.device.fwd_tx2d`` / ``inv_tx2d`` on CPU tensors
must return exactly the integers of ``svt_av1_tpu.ops.device``'s, for the
tx types and sizes the all-intra path codes: DCT at every square luma size
(4..64), rectangular DCT (the rect-partition arms), and the chroma tx
types of the intra modes at 4..16 (identity and flipped ADST included).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import device as jdev
from svt_av1_tpu_torch.ops import device as dev
from tests.torch_threads import one_torch_thread  # noqa: F401

# (w, h, tx types)
CASES = [(4, 4, tuple(range(16))), (8, 8, tuple(range(16))),
         (16, 16, tuple(range(16))), (32, 32, (0, 9)), (64, 64, (0,)),
         (16, 8, (0, 1, 2, 3)), (8, 16, (0, 1)), (32, 16, (0,)),
         (64, 32, (0,))]


def _pairs():
    return [(w, h, tt) for w, h, tts in CASES for tt in tts]


@pytest.mark.parametrize("w,h,tt", _pairs())
def test_fwd_inv_tx2d_match_jax(w, h, tt):
    rng = np.random.default_rng(w * 131 + h * 7 + tt)
    resid = rng.integers(-255, 256, (5, h, w)).astype(np.int32)
    resid[0] = 255                              # extreme flat residual
    got = dev.fwd_tx2d(torch.as_tensor(resid), tt, w, h).numpy()
    want = np.asarray(jdev.fwd_tx2d(jnp.asarray(resid), tt, w, h))
    assert np.array_equal(got, want)
    coeff = rng.integers(-4096, 4097, (5, h, w)).astype(np.int32)
    coeff[0] = 0
    coeff[1, 0, 0] = 32767                      # clamped DC
    got = dev.inv_tx2d(torch.as_tensor(coeff), tt, w, h, bd=8).numpy()
    want = np.asarray(jdev.inv_tx2d(jnp.asarray(coeff), tt, w, h, bd=8))
    assert np.array_equal(got, want)
