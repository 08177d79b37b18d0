"""The port's inter-frame ops (svt_av1_tpu_torch.ops.device_inter, the MC
of ops.device) against their JAX twins on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port; every output must be equal (tolerance 0: all of it is integer).
Flat planes make every search candidate tie, so the first-minimum
tie-breaks are exercised; blocks at the frame edges and MVs at the
REF_PAD extremes exercise the JAX gather rule (negative indices count
from the end, out-of-range indices clamp), which the port reproduces.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from svt_av1_tpu.ops import device as jdev
from svt_av1_tpu.ops import device_inter as jdi
from svt_av1_tpu.ops import mc as jmc
from svt_av1_tpu.ops import me as jme
from svt_av1_tpu.pipeline import inter as jinter
from svt_av1_tpu_torch.ops import device as tdev
from svt_av1_tpu_torch.ops import device_inter as tdi
from svt_av1_tpu_torch.pipeline import common as tcommon
from svt_av1_tpu_torch.pipeline import inter as tinter
from tests.torch_threads import one_torch_thread  # noqa: F401

PAD = jmc.REF_PAD
H, W = 64, 96


def _t(a):
    return torch.as_tensor(np.array(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))


def _planes(seed, flat=False):
    """(ref padded, src) luma planes: the source is the reference moved
    by (2, -3) plus noise, so the searches find real motion."""
    rng = np.random.default_rng(seed)
    if flat:
        ref = np.full((H, W), 117, np.uint8)
        return jmc.pad_reference(ref), ref.copy()
    ref = rng.integers(0, 256, (H, W)).astype(np.uint8)
    ref = ((ref.astype(np.int32) + np.roll(ref, 1, 0)
            + np.roll(ref, 1, 1) + 1) // 3).astype(np.uint8)
    src = np.clip(np.roll(ref, (2, -3), (0, 1)).astype(np.int32)
                  + rng.integers(-4, 5, (H, W)), 0, 255).astype(np.uint8)
    return jmc.pad_reference(ref), src


def _grid(size):
    gx, gy = np.meshgrid(np.arange(0, W, size), np.arange(0, H, size))
    return gx.reshape(-1).astype(np.int64), gy.reshape(-1).astype(np.int64)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("radius", [0, 3])
def test_exhaustive_matches_jax(flat, radius):
    refp, src = _planes(1, flat)
    xs, ys = _grid(16)
    rng = np.random.default_rng(2)
    # centers up to the REF_PAD limit: offsets beyond it are masked
    centers = rng.integers(-PAD + 1, PAD, (len(xs), 2)).astype(np.int64)
    centers[:3] = [[PAD - 1, PAD - 1], [-PAD + 1, 0], [0, 0]]
    jc, jiy, jix = jdi._gather_curs(jnp.asarray(src.astype(np.int32)),
                                    jnp.asarray(xs), jnp.asarray(ys), 16, 16)
    tc, tiy, tix = tdi._gather_curs(_t(src), _t(xs), _t(ys), 16, 16)
    _eq(tc, jc)
    want = jdi._exhaustive_j(jnp.asarray(refp), jc, jiy, jix,
                             jnp.asarray(centers), radius)
    got = tdi._exhaustive_j(_t(refp), tc, tiy, tix, _t(centers), radius)
    for g, w in zip(got, want):
        _eq(g, w)
    if flat and radius:
        # every in-frame candidate ties: the row-major first one wins
        _eq(got[0][2], [-radius, -radius])


@pytest.mark.parametrize("size", [16, 8])
@pytest.mark.parametrize("flat", [False, True])
def test_fullpel_search_matches_jax(size, flat):
    refp, src = _planes(3, flat)
    pyr = jme.build_pyramid(refp)
    spyr = jme.src_pyramid(src)
    xs, ys = _grid(size)
    want = jdi.fullpel_search_j(tuple(jnp.asarray(p) for p in pyr),
                                tuple(jnp.asarray(p) for p in spyr),
                                jnp.asarray(xs), jnp.asarray(ys), size)
    got = tdi.fullpel_search_j(tuple(_t(p) for p in pyr),
                               tuple(_t(p) for p in spyr), _t(xs), _t(ys),
                               size)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("bank", [False, True])
def test_subpel_refine_matches_jax(bank):
    refp, src = _planes(4)
    refp2, _ = _planes(5)
    xs, ys = _grid(16)
    rng = np.random.default_rng(6)
    mvs = rng.integers(-6, 7, (len(xs), 2)).astype(np.int64)
    # whole-pel MVs at the clamp limit: windows reach the padded edge
    mvs[0] = [-(PAD - 5), -(PAD - 5)]
    mvs[-1] = [PAD - 5, PAD - 5]
    kw = {}
    ref_j, ref_t = jnp.asarray(refp), _t(refp)
    if bank:
        sel = rng.integers(0, 2, len(xs)).astype(np.int64)
        ref_j = jnp.stack([jnp.asarray(refp), jnp.asarray(refp2)])
        ref_t = torch.stack([_t(refp), _t(refp2)])
        kw = dict(ref_idx=sel)
    want = jdi.subpel_refine_j(ref_j, jnp.asarray(src), jnp.asarray(xs),
                               jnp.asarray(ys), 16, jnp.asarray(mvs),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tdi.subpel_refine_j(ref_t, _t(src), _t(xs), _t(ys), 16, _t(mvs),
                              **{k: _t(v) for k, v in kw.items()})
    _eq(got, want)


def _mc_case(ss, seed):
    refp, _ = _planes(seed)
    if ss:
        refp = jmc.pad_reference(refp[PAD:-PAD, PAD:-PAD][::2, ::2].copy())
    hh, ww = refp.shape[0] - 2 * PAD, refp.shape[1] - 2 * PAD
    bw = 8 if ss else 16
    gx, gy = np.meshgrid(np.arange(0, ww, bw), np.arange(0, hh, bw))
    xs, ys = gx.reshape(-1), gy.reshape(-1)
    rng = np.random.default_rng(seed + 10)
    lim = (PAD - 5) << (2 + ss)
    mvs = rng.integers(-lim, lim + 1, (len(xs), 2)).astype(np.int64)
    mvs = jinter.clamp_mvs_batch(mvs, xs, ys, bw, bw, ww, hh, ss)
    return refp, xs.astype(np.int64), ys.astype(np.int64), mvs, bw


@pytest.mark.parametrize("ss", [0, 1])
@pytest.mark.parametrize("conv", [False, True])
@pytest.mark.parametrize("bank", [False, True])
def test_mc_block_batch_matches_jax(ss, conv, bank):
    refp, xs, ys, mvs, bw = _mc_case(ss, 7)
    refp2 = np.flipud(refp).copy()
    ref_j, ref_t, kw_j, kw_t = jnp.asarray(refp), _t(refp), {}, {}
    if bank:
        sel = np.arange(len(xs)) % 2
        ref_j = jnp.stack([ref_j, jnp.asarray(refp2)])
        ref_t = torch.stack([ref_t, _t(refp2)])
        kw_j, kw_t = dict(ref_idx=jnp.asarray(sel)), dict(ref_idx=_t(sel))
    jfn = jdi.mc_block_batch_conv_j if conv else jdev.mc_block_batch_j
    tfn = tdi.mc_block_batch_conv_j if conv else tdev.mc_block_batch_j
    want = jfn(ref_j, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(mvs),
               bw, bw, ss=ss, **kw_j)
    got = tfn(ref_t, _t(xs), _t(ys), _t(mvs), bw, bw, ss=ss, **kw_t)
    _eq(got, want)


def test_compound_average_matches_jax():
    refp, xs, ys, mvs, bw = _mc_case(0, 8)
    c0 = jdi.mc_block_batch_conv_j(jnp.asarray(refp), jnp.asarray(xs),
                                   jnp.asarray(ys), jnp.asarray(mvs), bw, bw)
    c1 = jdi.mc_block_batch_conv_j(jnp.asarray(refp), jnp.asarray(xs),
                                   jnp.asarray(ys),
                                   jnp.asarray(mvs[::-1].copy()), bw, bw)
    want = jdi.compound_average_j(c0, c1)
    got = tdi.compound_average_j(_t(np.asarray(c0)), _t(np.asarray(c1)))
    _eq(got, want)


@pytest.mark.parametrize("ss", [0, 1])
def test_clamp_mvs_matches_jax(ss):
    rng = np.random.default_rng(9)
    xs, ys = _grid(16)
    mvs = rng.integers(-2000, 2000, (len(xs), 2)).astype(np.int64)
    want = jinter.clamp_mvs_batch(mvs, xs, ys, 16, 16, W, H, ss)
    _eq(tinter.clamp_mvs_batch(mvs, xs, ys, 16, 16, W, H, ss), want)
    _eq(tdi._clamp_mvs_j(_t(mvs), _t(xs), _t(ys), 16, 16, W, H, ss), want)


@pytest.mark.parametrize("valid", [None, (48, 80)])
def test_ref_prep_matches_jax(valid):
    rng = np.random.default_rng(12)
    planes = [rng.integers(0, 256, (H, W)).astype(np.uint8),
              rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8),
              rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)]
    jp, jpyr = jdi.ref_prep_dev([jnp.asarray(p) for p in planes],
                                valid_hw=valid)
    tp, tpyr = tdi.ref_prep_dev([_t(p) for p in planes], valid_hw=valid)
    for g, w in zip(list(tp) + list(tpyr), list(jp) + list(jpyr)):
        _eq(g, w)
    # the host pipeline's own pad + pyramid
    vc = None if valid is None else (valid[0] // 2, valid[1] // 2)
    host = [jmc.pad_reference(p, valid_hw=(valid if i == 0 else vc))
            for i, p in enumerate(planes)]
    for g, w in zip(list(tp) + list(tpyr),
                    host + list(jme.build_pyramid(host[0]))):
        _eq(g, w)
    for g, w in zip(tdi.src_pyramid_dev(_t(planes[0])),
                    jme.src_pyramid(planes[0])):
        _eq(g, w)


@pytest.mark.parametrize("rect", [False, True])
def test_dp_all_matches_jax(rect):
    """The DP's searches on a source padded to whole superblocks, as the
    encoder's always is (there the JAX package's host DP and its device
    twin clamp the root MVs alike)."""
    refp, src = _planes(13)
    pyr = jme.build_pyramid(refp)
    spyr = jme.src_pyramid(np.pad(src, ((0, -H % 64), (0, -W % 64)),
                                  mode="edge"))
    sizes = (64, 32, 16, 8)
    arms = []
    if rect:
        for size in (64, 32, 16):
            half, quarter = size // 2, size // 4
            arms += [(size, (size, half), ((0, 0), (0, half))),
                     (size, (half, size), ((0, 0), (half, 0)))]
            if size >= 32:
                arms += [(size, (size, quarter),
                          tuple((0, i * quarter) for i in range(4)))]
    want = jdi.dp_all_dev(pyr, spyr, W, H, sizes, arms)
    got = tdi.dp_all_dev(tuple(_t(p) for p in pyr),
                         tuple(_t(p) for p in spyr), W, H, sizes, arms)
    assert sorted(got, key=str) == sorted(want, key=str)
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert g.dtype == np.int64
            _eq(g, w)


def test_dp_root_clamp_follows_the_jax_host_dp():
    """A 960x544 frame, whose planes are bucket-padded to 1280x768: the
    DP's root search clamps its MVs to the 64-padded frame (960x576), as
    the JAX package's host DP does (it searches the 64-padded luma; its
    device twin clamps to the bucket), and the leaf map equals the host
    DP's. The clip pans 24 px right over the 8 frames between the two, so
    right-edge blocks reach the clamp."""
    import dataclasses
    from types import SimpleNamespace

    from svt_av1_tpu.app.cli import preset_config
    from svt_av1_tpu.pipeline import common as jcommon
    from svt_av1_tpu.pipeline import rd as jrd
    from svt_av1_tpu_torch.convert import config_from_jax
    from svt_av1_tpu_torch.pipeline import rd as trd
    from svt_av1_tpu_torch.utils.clip import make_clip
    w, h = 960, 544
    f0, f8 = (f[0] for f in make_clip(w=w, h=h, frames=9, seed=3)[::8])
    ref_b = jcommon.pad_frame_planes(f0, f0[::2, ::2], f0[::2, ::2])[0]
    src_b = jcommon.pad_frame_planes(f8, f8[::2, ::2], f8[::2, ::2])[0]
    assert src_b.shape == (768, 1280)
    refp = jmc.pad_reference(ref_b.astype(np.uint8), valid_hw=(576, 960))
    pyr = jme.build_pyramid(refp)
    spyr = jme.src_pyramid(src_b.astype(np.uint8))
    jcfg = preset_config(SimpleNamespace(
        width=w, height=h, qp=40, bit_depth=8, intra_period=-1, fps=30,
        film_grain=0, preset=5, hierarchical_levels=3, tbr=0, lad=0,
        backend="host"))
    want = jrd.choose_partition_inter(f8, refp, jcfg, w // 4, h // 4,
                                      ref_pyr=pyr, src_pyr=spyr)
    tpyr = tuple(_t(p) for p in pyr)
    tspyr = tuple(_t(p) for p in spyr)
    got = trd.choose_partition_inter(
        config_from_jax(dataclasses.asdict(jcfg), device="cpu"), w // 4,
        h // 4, tpyr, tspyr)
    assert got == want
    xs, ys = (torch.as_tensor(a.reshape(-1)) for a in
              np.meshgrid(np.arange(0, w, 64), np.arange(0, h, 64)))
    frame, _ = tdi.fullpel_search_j(tpyr, tspyr, xs, ys, 64,
                                    plane_hw=(576, 960))
    bucket, _ = tdi.fullpel_search_j(tpyr, tspyr, xs, ys, 64)
    assert not torch.equal(frame, bucket)     # the clamp binds here


def test_sse_at_reads_the_jax_gather_rule():
    """Blocks at the frame's last row and column with MVs past the
    padded border: JAX clamps (and wraps negative) indices, the port's
    take2 reproduces it instead of raising."""
    refp, src = _planes(14)
    xs = np.array([0, W - 16, W - 16, 0], np.int64)
    ys = np.array([H - 16, 0, H - 16, 0], np.int64)
    mvs = np.array([[PAD + 9, -PAD - 7], [-PAD - 20, PAD + 3],
                    [PAD, PAD], [-PAD, -PAD]], np.int64)
    want = jdi._sse_at_j(jnp.asarray(refp), jnp.asarray(src),
                         jnp.asarray(xs), jnp.asarray(ys),
                         jnp.asarray(mvs), 16, 16)
    got = tdi._sse_at_j(_t(refp), _t(src), _t(xs), _t(ys), _t(mvs), 16, 16)
    _eq(got, want)
    # and the index rule itself, on both signs and both ends
    idx = torch.tensor([-200, -5, -1, 0, 7, 95, 96, 300])
    _eq(tdev.jax_index(idx, 96),
        np.asarray(jnp.arange(96)[jnp.asarray(idx.numpy())]))


def test_pending_qc_resolves_a_torch_tensor():
    qc = torch.arange(2 * 4 * 4, dtype=torch.int16).reshape(2, 4, 4) - 9
    pend = tcommon.PendingQC(qc)
    got = tcommon.resolve_qc((pend, 1))
    assert got.dtype == np.int32
    _eq(got, qc[1].numpy())
    _eq(tcommon.resolve_qc((pend, 0)), qc[0].numpy())
    plain = np.ones((4, 4), np.int32)
    assert tcommon.resolve_qc(plain) is plain
