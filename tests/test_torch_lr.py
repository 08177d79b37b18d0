"""The port's loop restoration (``ops/device_lr.py`` passes and
``pipeline/lr_search.py``) against the JAX package.

On the CPU, tolerance 0: ``search_restoration_dev`` (stats, host solves,
exact SSEs, apply) against the JAX host pair ``search_restoration`` +
``loop_restoration_filter_frame`` (NumPy) on the shapes of
tests/test_device_lr.py (200x120 and 320x192 at bd 8, 136x72 at bd 10),
with that file's noise (Wiener wins) and a low noise (self-guided wins),
and on a 640x256 frame of mixed noise where the switchable type wins;
equal frame types, equal taps and xqd per unit, equal planes. The integer
statistics of the first pass are held once against the JAX device twin,
and the boundary-line gather against the host's saved lines.
"""

import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import restoration as jrst
from svt_av1_tpu.pipeline import lr_search as jlr
from svt_av1_tpu.pipeline import rd
from svt_av1_tpu_torch.ops import device_lr as tdl
from svt_av1_tpu_torch.pipeline import lr_search as tlr
from tests.test_device_lr import _setup
from tests.torch_threads import one_torch_thread  # noqa: F401


def _mixed_setup(w, h, bd, seed):
    """Low noise on the left half (self-guided wins there), strong noise
    on the right (Wiener wins): the switchable type wins the frame."""
    rng = np.random.default_rng(seed)
    peak = (1 << bd) - 1
    dt = np.uint8 if bd <= 8 else np.uint16
    Hp, Wp = -(-h // 64) * 64, -(-w // 64) * 64
    yy, xx = np.mgrid[0:Hp, 0:Wp]
    base = peak / 2 + (peak / 4) * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    src, recon, bounds = [], [], []
    for p in range(3):
        ss = 1 if p else 0
        b = base[:Hp >> ss, :Wp >> ss]
        s = np.clip(b + rng.normal(0, peak / 48, b.shape), 0,
                    peak).astype(np.int32)
        lvl = np.where(xx[:Hp >> ss, :Wp >> ss] < (Wp >> ss) // 2, 1.5, 24.0)
        r = np.clip(s + rng.normal(0, 1, b.shape) * lvl * (peak + 1) / 256,
                    0, peak).astype(dt)
        src.append(s)
        recon.append(r)
        Hc, Wc = (h + ss) >> ss, (w + ss) >> ss
        bounds.append(jrst.save_deblock_boundary_lines(r[:Hc, :Wc], Hc, ss))
    return recon, src, bounds


def _assert_same(ri_d, ri_h):
    for p in range(3):
        assert ri_d[p].frame_restoration_type == \
            ri_h[p].frame_restoration_type, f"plane {p}"
        assert (ri_d[p].unit_size, ri_d[p].hunits, ri_d[p].vunits) == \
            (ri_h[p].unit_size, ri_h[p].hunits, ri_h[p].vunits)
        assert len(ri_d[p].units) == len(ri_h[p].units)
        for ud, uh in zip(ri_d[p].units, ri_h[p].units):
            assert ud.restoration_type == uh.restoration_type
            if ud.restoration_type == jrst.RESTORE_WIENER:
                assert (ud.wiener_v, ud.wiener_h) == \
                    (uh.wiener_v, uh.wiener_h)
            if ud.restoration_type == jrst.RESTORE_SGRPROJ:
                assert (ud.sgr_ep, ud.sgr_xqd) == (uh.sgr_ep, uh.sgr_xqd)


def _run_both(recon, src, bounds, w, h, bd, qindex=120):
    lam = rd.rd_lambda(qindex, bd)
    want = [p.copy() for p in recon]
    ri_h = jlr.search_restoration(want, src, bounds, w, h, bd, qindex, lam)
    jrst.loop_restoration_filter_frame(want, ri_h, bounds, w, h, bd)
    got = [p.copy() for p in recon]
    ri_d = tlr.search_restoration_dev(got, src, bounds, w, h, bd, qindex,
                                      lam, device="cpu")
    _assert_same(ri_d, ri_h)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return ri_h


@pytest.mark.parametrize("noise,ftype", [(8.0, jrst.RESTORE_WIENER),
                                         (2.0, jrst.RESTORE_SGRPROJ)])
@pytest.mark.parametrize("w,h,bd,seed", [(200, 120, 8, 0),
                                         (320, 192, 8, 1),
                                         (136, 72, 10, 2)])
def test_lr_matches_host(w, h, bd, seed, noise, ftype):
    recon, src, bounds = _setup(w, h, bd, seed, noise=noise)
    ri = _run_both(recon, src, bounds, w, h, bd)
    assert ri[0].frame_restoration_type == ftype


def test_lr_switchable_matches_host():
    w, h, bd = 640, 256, 8
    recon, src, bounds = _mixed_setup(w, h, bd, 5)
    ri = _run_both(recon, src, bounds, w, h, bd)
    assert ri[0].frame_restoration_type == jrst.RESTORE_SWITCHABLE
    assert {u.restoration_type for u in ri[0].units} == \
        {jrst.RESTORE_WIENER, jrst.RESTORE_SGRPROJ}


def test_lr_on_tensors_writes_in_place():
    """Tensor planes are searched and filtered in place, equal to the
    numpy planes."""
    w, h, bd = 200, 120, 8
    recon, src, bounds = _setup(w, h, bd, 0)
    lam = rd.rd_lambda(120, bd)
    want = [p.copy() for p in recon]
    ri_n = tlr.search_restoration_dev(want, src, bounds, w, h, bd, 120,
                                      lam, device="cpu")
    rec = [torch.as_tensor(p.copy()) for p in recon]
    ptrs = [p.data_ptr() for p in rec]
    ri_t = tlr.search_restoration_dev(rec, [torch.as_tensor(p) for p in src],
                                      bounds, w, h, bd, 120, lam,
                                      device="cpu")
    _assert_same(ri_t, ri_n)
    assert [p.data_ptr() for p in rec] == ptrs
    for a, b in zip(rec, want):
        assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("on_tensor", [False, True])
@pytest.mark.parametrize("w,h", [(200, 120), (136, 72), (320, 192)])
def test_deblock_bounds_match_host(w, h, on_tensor):
    recon, _, _ = _setup(w, h, 8, 3)
    for p in range(3):
        ss = 1 if p else 0
        Hp, Wp = (h + ss) >> ss, (w + ss) >> ss
        want = jrst.save_deblock_boundary_lines(recon[p][:Hp, :Wp], Hp, ss)
        plane = torch.as_tensor(recon[p]) if on_tensor else recon[p]
        got = tdl.deblock_bounds_dev(plane, Hp, Wp, ss)
        assert sorted(got) == sorted(want)
        for s in want:
            for a, b in zip(got[s], want[s]):
                assert (a is None) == (b is None)
                if a is not None:
                    assert np.array_equal(a, b)


def test_lr_stats_match_jax_device_twin():
    """Pass A's integers (Wiener H and M, sse_none, SGR ata / atb per
    swept ep) equal the JAX device program's, plane by plane."""
    from svt_av1_tpu.ops import device_lr as jdl
    w, h, bd = 136, 72, 10
    recon, src, bounds = _setup(w, h, bd, 2)
    want = jdl.lr_stats_dev(recon, src, bounds, w, h, bd)
    got = tdl.lr_stats_dev(tdl.lr_planes(recon, src, bounds, w, h, bd,
                                         device="cpu"))
    assert len(got) == 3
    for gp, wp in zip(got, want):
        assert len(gp) == len(wp) == 5
        for a, b in zip(gp, wp):
            assert a.shape == b.shape and np.array_equal(a, b)
