"""The port's CDEF (``ops/device_cdef.py``, plain PyTorch on the device)
against the JAX package.

On the CPU, tolerance 0: ``cdef_search_apply_dev`` against the JAX host
pair ``cdef_search`` + ``cdef_frame`` (NumPy) on the shapes and strength
cases of tests/test_device_cdef.py (72x136, an odd 2x3 SB tiling with
partial edges; bd/qindex (8, 40), (8, 120), (8, 200), (10, 120)), each on
that file's content and on a denoising content where the filter engages
and one flat SB ties all four presets; the all-skip no-op; and once
against the JAX device twin. Equal index maps, equal strengths, equal
planes.
"""

import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import cdef as host_cdef
from svt_av1_tpu_torch.ops import cdef as tables
from svt_av1_tpu_torch.ops import device_cdef as tdc
from tests.test_device_cdef import _mk
from tests.torch_threads import one_torch_thread  # noqa: F401

H, W = 72, 136                  # 2x3 SBs, partial edges
MI_ROWS, MI_COLS = -(-H // 4), -(-W // 4)
CASES = [(8, 40, 0), (8, 120, 1), (8, 200, 2), (10, 120, 3)]


def _jax_case(bd, seed):
    """tests/test_device_cdef.py's content: a noisy sine recon, the
    source within +-6 of it."""
    recon = _mk(H, W, bd, seed)
    rng = np.random.default_rng(seed + 100)
    src = [np.clip(p.astype(np.int32) + rng.integers(-6, 7, p.shape), 0,
                   (1 << bd) - 1).astype(np.int32) for p in recon]
    return recon, src


def _denoise_case(bd, seed):
    """A clean edge pattern as the source and the recon with noise on
    it, so the filter helps; SB (0, 0) is flat in both, so all four
    presets leave it alone and tie."""
    rng = np.random.default_rng(seed)
    peak = (1 << bd) - 1
    dt = np.uint8 if bd <= 8 else np.uint16
    Hp, Wp = -(-H // 64) * 64, -(-W // 64) * 64
    recon, src = [], []
    for p in range(3):
        ss = 1 if p else 0
        yy, xx = np.mgrid[0:Hp >> ss, 0:Wp >> ss]
        clean = peak / 2 + (peak / 4) * np.sign(
            np.sin(xx / (5.0 - 2 * ss) + yy / (9.0 - 3 * ss)))
        clean[:64 >> ss, :64 >> ss] = peak // 3
        s = np.clip(clean, 0, peak).astype(np.int32)
        r = np.clip(s + rng.normal(0, peak / 40, s.shape), 0, peak)
        r[:64 >> ss, :64 >> ss] = peak // 3
        src.append(s)
        recon.append(r.astype(dt))
    return recon, src


def _skip8(seed):
    h8, w8 = (MI_ROWS * 4 + 7) // 8, (MI_COLS * 4 + 7) // 8
    return np.random.default_rng(seed + 100).random((h8, w8)) < 0.25


def _host(recon, src, skip8, qindex, bd, mi_rows=MI_ROWS, mi_cols=MI_COLS):
    rec = [p.copy() for p in recon]
    idx, ys, uv, damp = host_cdef.cdef_search(rec, src, skip8, mi_rows,
                                              mi_cols, qindex, bd)
    host_cdef.cdef_frame(rec, skip8, idx, ys, uv, damp, mi_rows, mi_cols,
                         bd)
    return rec, (idx, ys, uv, damp)


def _port(recon, src, skip8, qindex, bd, mi_rows=MI_ROWS, mi_cols=MI_COLS):
    rec = [p.copy() for p in recon]
    out = tdc.cdef_search_apply_dev(rec, src, skip8, mi_rows, mi_cols,
                                    qindex, bd, device="cpu")
    return rec, out


@pytest.mark.parametrize("content", ["jax", "denoise"])
@pytest.mark.parametrize("bd,qindex,seed", CASES)
def test_cdef_matches_host(bd, qindex, seed, content):
    recon, src = (_jax_case if content == "jax" else _denoise_case)(bd,
                                                                  seed)
    skip8 = _skip8(seed)
    want_rec, (idx_h, ys_h, uv_h, damp_h) = _host(recon, src, skip8,
                                                  qindex, bd)
    got_rec, (idx_d, ys_d, uv_d, damp_d) = _port(recon, src, skip8, qindex,
                                                 bd)
    assert (ys_d, uv_d, damp_d) == (ys_h, uv_h, damp_h)
    assert idx_d.dtype == np.int32 and np.array_equal(idx_d, idx_h)
    for a, b in zip(got_rec, want_rec):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if content == "denoise":
        assert idx_h[0, 0] == 0, "the flat SB ties: the first preset wins"
        assert (idx_h > 0).any(), "the filter should engage"
        assert not np.array_equal(want_rec[0], recon[0])


def test_cdef_on_tensors_writes_in_place():
    """Tensor planes (the recon the reference slots keep) are filtered in
    place, equal to the numpy planes; the index map comes back."""
    recon, src = _denoise_case(8, 5)
    skip8 = _skip8(5)
    want_rec, want = _port(recon, src, skip8, 120, 8)
    rec = [torch.as_tensor(p.copy()) for p in recon]
    ptrs = [p.data_ptr() for p in rec]
    got = tdc.cdef_search_apply_dev(rec, [torch.as_tensor(p) for p in src],
                                    skip8, MI_ROWS, MI_COLS, 120, 8,
                                    device="cpu")
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert [p.data_ptr() for p in rec] == ptrs
    for a, b in zip(rec, want_rec):
        assert a.dtype == torch.uint8 and np.array_equal(a.numpy(), b)


def test_cdef_all_skip_is_noop():
    h, w = 64, 64
    recon = _mk(h, w, 8, 7)
    src = [p.astype(np.int32) for p in recon]
    skip8 = np.ones((8, 8), dtype=bool)
    got_rec, (idx, *_) = _port(recon, src, skip8, 120, 8, 16, 16)
    assert (idx == -1).all()
    for a, b in zip(got_rec, recon):
        assert np.array_equal(a, b)


def test_find_dir_matches_host():
    """The dense direction search equals the host find_dir block by
    block, ties (flat blocks) on the first maximum."""
    rng = np.random.default_rng(11)
    blocks = rng.integers(0, 1024, (40, 8, 8)).astype(np.int32)
    blocks[:4] = 512                                  # flat: all costs tie
    blocks[4:8] = np.arange(8)[None, :, None] * 60    # horizontal edges
    got_d, got_v = tdc._find_dir_dense(
        torch.as_tensor(blocks).reshape(5, 8, 8, 8), 2)
    for b, d, v in zip(blocks, got_d.reshape(-1), got_v.reshape(-1)):
        assert (int(d), int(v)) == host_cdef.find_dir(b, 2)
    assert (got_d.reshape(-1)[:4] == 0).all()


def test_tables_equal_the_jax_package():
    assert tables.CDEF_VERY_LARGE == host_cdef.CDEF_VERY_LARGE
    assert tables.PRI_TAPS == host_cdef.PRI_TAPS
    assert tables.SEC_TAPS == host_cdef.SEC_TAPS
    assert tables.DIR_OFFSETS == host_cdef.DIR_OFFSETS
    assert np.array_equal(tables._DIV_TABLE, host_cdef._DIV_TABLE)
    for q in range(256):
        assert tables.strength_presets(q) == host_cdef.strength_presets(q)


def test_cdef_matches_jax_device_twin():
    from svt_av1_tpu.ops import device_cdef as jdc
    bd, qindex, seed = 8, 120, 1
    recon, src = _denoise_case(bd, seed)
    skip8 = _skip8(seed)
    want_rec = [p.copy() for p in recon]
    want = jdc.cdef_search_apply_dev(want_rec, src, skip8, MI_ROWS,
                                     MI_COLS, qindex, bd)
    got_rec, got = _port(recon, src, skip8, qindex, bd)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    for a, b in zip(got_rec, want_rec):
        assert np.array_equal(a, b)
