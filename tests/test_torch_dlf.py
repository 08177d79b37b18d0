"""The port's deblocking (plain PyTorch on the device) against the JAX
package's device twins.

``dlf_apply_len_batch`` on the cases of tests/test_device_ops.py's DLF
check (8 and 10-bit, every filter length, near-flat lines that take the
wide branches), and the whole-frame level search + apply
``dlf_search_apply_dev`` at 128x64 against its JAX twin: same levels, same
planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import device as jdev
from svt_av1_tpu.ops import dlf as jdlf
from svt_av1_tpu_torch.ops import device as dev
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("length", [4, 6, 8, 14])
def test_dlf_apply_len_batch_matches_jax(bd, length):
    rng = np.random.RandomState(bd * 100 + length)
    peak = (1 << bd) - 1
    sh = bd - 8
    n = 193
    s = rng.randint(0, peak + 1, (n, 14)).astype(np.int32)
    s[:48] = np.clip(s[:48, :1] + rng.randint(-1, 2, (48, 14)), 0, peak)
    bl, lim, th = jdlf.thresholds(24)
    want = np.asarray(jdev.dlf_apply_len_batch(
        jnp.asarray(s), length, bl << sh, lim << sh, th << sh, bd))
    got = dev.dlf_apply_len_batch(torch.as_tensor(s), length, bl << sh,
                                  lim << sh, th << sh, bd).numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got, s), "some line should be filtered"


def _blocky(h, w, seed):
    """Smooth source + per-block-DC recon: edges the DLF must smooth."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    src_y = np.clip(100 + 40 * np.sin(xx / 37.0) + 30 * np.cos(yy / 29.0)
                    + rng.normal(0, 1.5, (h, w)), 0, 255)
    rec_y = src_y.copy()
    for r in range(0, h, 16):
        for c in range(0, w, 16):
            rec_y[r:r + 16, c:c + 16] = round(
                float(src_y[r:r + 16, c:c + 16].mean()))
    src_c = np.clip(128 + 20 * np.sin(xx[:h // 2, :w // 2] / 23.0), 0, 255)
    rec_c = src_c.copy()
    for r in range(0, h // 2, 8):
        for c in range(0, w // 2, 8):
            rec_c[r:r + 8, c:c + 8] = round(
                float(src_c[r:r + 8, c:c + 8].mean()))
    rec = [rec_y.astype(np.uint8), rec_c.astype(np.uint8),
           (255 - rec_c).astype(np.uint8)]
    src = [src_y.astype(np.int32), src_c.astype(np.int32),
           (255 - src_c).astype(np.int32)]
    return rec, src


@pytest.mark.parametrize("qindex", [200, 90])
def test_dlf_search_apply_matches_jax(qindex):
    h, w = 64, 128
    rec, src = _blocky(h, w, seed=qindex)
    mi_rows, mi_cols = h // 4, w // 4
    leaf = {}
    for r in range(0, mi_rows, 4):               # mixed 16 / 8 / rect
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
    rec_j = [p.copy() for p in rec]
    lv_j = jdev.dlf_search_apply_dev(rec_j, src, leaf, mi_rows, mi_cols,
                                     qindex, 8)
    rec_t = [p.copy() for p in rec]
    lv_t = dev.dlf_search_apply_dev(rec_t, src, leaf, mi_rows, mi_cols,
                                    qindex, 8, device="cpu")
    assert lv_t == tuple(lv_j)
    assert lv_t[0] > 0, "filter should fire on blocky content"
    for a, b in zip(rec_t, rec_j):
        assert np.array_equal(a, b)
