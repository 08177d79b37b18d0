"""The port's fused inter programs against their JAX twins on the CPU:
the shape group (multi-ref ME, the single-ref pair, the compound fold,
both chroma planes and the recon scatter), the intra-flip decision and
the intra-flip apply (the dependency-wave loop).

The same numpy inputs, made from a seed, go through the JAX program and
the port; every output, every recon plane and every dtype must be equal
(tolerance 0). Flat content makes ME candidates and references tie, so
the first-minimum argmins and the strict ``<`` folds are exercised.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu.ops import device_inter as jdi
from svt_av1_tpu.ops import device_tile as jdt
from svt_av1_tpu.ops import mc as jmc
from svt_av1_tpu.ops import me as jme
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu.pipeline import common as jcommon
from svt_av1_tpu.pipeline import encoder as jencoder
from svt_av1_tpu.pipeline import inter as jinter
from svt_av1_tpu.pipeline import rd as jrd
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.ops import device_inter as tdi
from svt_av1_tpu_torch.ops import device_tile as tdt
from svt_av1_tpu_torch.pipeline import common as tcommon
from svt_av1_tpu_torch.pipeline import encoder as tencoder
from svt_av1_tpu_torch.pipeline import inter as tinter
from svt_av1_tpu_torch.utils.clip import make_clip
from tests.torch_threads import one_torch_thread  # noqa: F401

W, H = 128, 64
QIDX = 100


def _t(a):
    return torch.as_tensor(np.array(a))


def _eq(got, want, dtype=True):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if dtype:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def frame_set():
    """Source planes of frame 1 and three padded references: frames 0
    and 2 of a clip and a flat plane (the searches tie against it)."""
    frames = make_clip(w=W, h=H, frames=3, seed=5)
    src = jcommon.pad_frame_planes(*frames[1], dtype=np.int32)
    flat = [np.full(p.shape, 128, np.uint8) for p in frames[0]]
    refs = []
    for planes in (frames[0], flat, frames[2]):
        padded = [jmc.pad_reference(np.asarray(p)) for p in planes]
        refs.append((padded, jme.build_pyramid(padded[0])))
    return src, refs


def _group(size):
    bw, bh = jcommon.leaf_wh(size)
    gx, gy = np.meshgrid(np.arange(0, W, bw), np.arange(0, H, bh))
    return gx.reshape(-1).astype(np.int64), gy.reshape(-1).astype(np.int64)


@pytest.mark.parametrize("size,ref_sel,per_lane", [
    (16, True, False), (16, False, False), ((32, 16), True, True),
    (8, True, True)])
def test_shape_group_matches_jax(frame_set, size, ref_sel, per_lane):
    src, refs = frame_set
    xs, ys = _group(size)
    b = len(xs)
    qp = jquant.make_quant_params(QIDX)
    lam = jrd.rd_lambda(QIDX, 8)
    qv = lamv = None
    if per_lane:
        qv = np.random.default_rng(3).choice([60, 100, 160], b) \
            .astype(np.int32)
        lamv = np.array([jrd.rd_lambda(int(q), 8) for q in qv])
    # bank order LAST, GOLDEN (forward), ALTREF (backward)
    fwd, bwd = ((0, 1), (2,)) if ref_sel else ((), ())
    src_pyr = jme.src_pyramid(src[0])
    jrec = [jnp.zeros(p.shape, jnp.uint8) for p in src]
    jrec, jouts, jb = jdi.shape_group_issue(
        jrec, [r[1] for r in refs], [r[0][1] for r in refs],
        [r[0][2] for r in refs], src_pyr, src[1], src[2], xs, ys, size, qp,
        lam, fwd, bwd, bd=8, rdoq=True, qv=qv, lamv=lamv)
    trec = [torch.zeros(p.shape, dtype=torch.uint8) for p in src]
    u8 = (lambda a: _t(a).to(torch.uint8))
    trec, touts, tb = tdi.shape_group_issue(
        trec, [tuple(u8(p) for p in r[1]) for r in refs],
        [u8(r[0][1]) for r in refs], [u8(r[0][2]) for r in refs],
        tuple(u8(p) for p in src_pyr), u8(src[1]), u8(src[2]), xs, ys, size,
        qp, lam, fwd, bwd, bd=8, rdoq=True, qv=qv, lamv=lamv)
    assert tb == jb == b
    # the JAX program's 13 outputs, then the searches' filter and luma tx
    # type: REGULAR and DCT_DCT with both searches off
    assert len(jouts) == 13 and len(touts) == 15
    for i, (g, w) in enumerate(zip(touts, jouts)):
        _eq(g, np.asarray(w)[:b])
    assert not touts[13].any() and not touts[14].any()
    for g, w in zip(trec, jrec):
        _eq(g, w)


def test_shape_group_ties_pick_the_first_reference(frame_set):
    """Three identical flat references: every SAD and cost ties, so the
    first reference wins the argmins and the zero MV never strictly beats
    the refined one."""
    src, refs = frame_set
    flat_refs = [refs[1]] * 3
    xs, ys = _group(16)
    qp = jquant.make_quant_params(QIDX)
    lam = jrd.rd_lambda(QIDX, 8)
    flat_src = [np.full(p.shape, 128, np.int32) for p in src]
    src_pyr = jme.src_pyramid(flat_src[0])
    trec = [torch.zeros(p.shape, dtype=torch.uint8) for p in src]
    _, touts, b = tdi.shape_group_issue(
        trec, [tuple(_t(p) for p in r[1]) for r in flat_refs],
        [_t(r[0][1]) for r in flat_refs], [_t(r[0][2]) for r in flat_refs],
        tuple(_t(p) for p in src_pyr), _t(flat_src[1]), _t(flat_src[2]),
        xs, ys, 16, qp, lam, (0, 1), (2,), bd=8, rdoq=True)
    jrec = [jnp.zeros(p.shape, jnp.uint8) for p in src]
    _, jouts, _ = jdi.shape_group_issue(
        jrec, [r[1] for r in flat_refs], [r[0][1] for r in flat_refs],
        [r[0][2] for r in flat_refs], src_pyr, flat_src[1], flat_src[2], xs,
        ys, 16, qp, lam, (0, 1), (2,), bd=8, rdoq=True)
    for g, w in zip(touts, jouts):
        _eq(g, np.asarray(w)[:b])
    assert touts[3].tolist() == [0] * b           # reference position
    assert touts[5].tolist() == [0] * b           # forward winner


def _flip_lanes(seed, size, b):
    rng = np.random.default_rng(seed)
    bw, bh = jcommon.leaf_wh(size)
    xs = rng.integers(0, (W - bw) // 4 + 1, b) * 4
    ys = rng.integers(0, (H - bh) // 4 + 1, b) * 4
    xs[:2], ys[:2] = (0, W - bw), (0, H - bh)      # the frame's corners
    ha, hl = ys > 0, xs > 0
    htr, hbl = rng.integers(0, 2, b) > 0, rng.integers(0, 2, b) > 0
    mwv = np.where(xs < W // 2, W // 2, W)         # two tile columns
    mhv = np.full(b, H)
    return xs, ys, ha, hl, htr, hbl, mwv, mhv


@pytest.mark.parametrize("size", [16, (16, 8), 32])
def test_flip_decision_matches_jax(size):
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, (H, W)).astype(np.uint8)
    recon = rng.integers(0, 256, (H, W)).astype(np.uint8)
    lanes = _flip_lanes(8, size, 11)
    modes = (0, 1, 2, 12)
    qv = rng.choice([40, 100, 200], 11).astype(np.int32)
    lamv = [jrd.rd_lambda(int(q), 8) for q in qv]
    qp = jquant.make_quant_params(QIDX)
    lam = jrd.rd_lambda(QIDX, 8)
    xs, ys, ha, hl, htr, hbl, mwv, mhv = lanes
    jouts, jb = jdi.flip_decision_issue(
        src, jnp.asarray(recon), xs, ys, ha, hl, htr, hbl, modes, size, qp,
        lam, mwv, mhv, bd=8, rdoq=True, qv=qv, lamv=lamv)
    touts, tb = tdi.flip_decision_issue(
        _t(src), _t(recon), xs, ys, ha, hl, htr, hbl, modes, size, qp, lam,
        mwv, mhv, bd=8, rdoq=True, qv=qv, lamv=lamv)
    assert tb == jb == 11 and len(touts) == len(jouts) == 2 * len(modes)
    for g, w in zip(touts, jouts):
        _eq(g, np.asarray(w)[:tb])


def _leaf_map():
    """SB 0 as four 32x32 leaves, SB 1 as 16x16 ones, with a 16x8 pair
    (mi units): three shape classes in one wave loop."""
    leaves = {(r, c): 32 for r in (0, 8) for c in (0, 8)}
    for r in (0, 4, 8, 12):
        for c in (16, 20, 24, 28):
            leaves[(r, c)] = 16
    del leaves[(12, 28)]
    leaves[(12, 28)] = (16, 8)
    leaves[(14, 28)] = (16, 8)
    return leaves


def _flip_encoders(leaves=None, pick=None):
    """JAX and port inter encoders on one leaf map (``_leaf_map`` by
    default) and the flips: the leaves in coding order for which
    ``pick(i, r, c)`` holds (by default every one but each third)."""
    jcfg = JaxConfig(width=W, height=H, qp=40, intra_modes=(0, 1, 2, 12),
                     tile_cols_log2=1, intra_period=-1, backend="device")
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    jenc = jinter.InterFrameEncoder(jcfg, jencoder.Encoder(jcfg).seq)
    tenc = tinter.InterFrameEncoder(cfg, tencoder.Encoder(cfg).seq)
    frames = make_clip(w=W, h=H, frames=2, seed=9)
    src = jcommon.pad_frame_planes(*frames[1], dtype=np.int32)
    recon = [p.astype(np.uint8) for p in
             jcommon.pad_frame_planes(*frames[0], dtype=np.int32)]
    leaves = leaves or _leaf_map()
    pick = pick or (lambda i, r, c: i % 3 != 1)
    order = jcommon.leaves_in_coding_order(leaves, jenc.mi_rows,
                                           jenc.mi_cols, 1, 2)
    n = len(order)
    for enc, to in ((jenc, np.asarray), (tenc, _t)):
        enc.leaf_sizes = leaves
        enc.leaf_index = {(r, c): i for i, (r, c, _) in enumerate(order)}
        enc.qmap = None
        enc.src = [to(p.astype(np.uint8)) if to is _t else p for p in src]
        enc.recon = [to(p) for p in recon]
        enc.qcoeff = [[None] * n for _ in range(3)]
        enc.eobs = np.zeros((3, n), np.int32)
        enc.block_is_inter = np.ones(n, bool)
        enc.intra_mode = np.zeros(n, np.int32)
        enc.intra_uv_cfl = np.zeros(n, bool)
        enc.intra_alpha_u = np.zeros(n, np.int64)
        enc.intra_alpha_v = np.zeros(n, np.int64)
    modes = (0, 1, 2, 12)
    flips = [(r, c, s, i, modes[i % 4]) for i, (r, c, s) in enumerate(order)
             if pick(i, r, c)]
    return jenc, tenc, flips


def _assert_flip_apply_equal(jenc, tenc, flips, waves, host=False,
                             fused_declines=True):
    """The port's flip apply against the JAX package's fused programs, or
    with ``host`` against its host recode (``_flip_apply_wave``; with
    ``fused_declines`` the fused programs must refuse these waves)."""
    if host:
        if fused_declines:
            assert not jdt.flip_apply_fused(jenc, waves)   # asks for host
        for wave in waves:
            jenc._flip_apply_wave(wave)
    else:
        assert jdt.flip_apply_fused(jenc, waves)
    tdt.flip_apply_fused(tenc, waves)
    for g, w in zip(tenc.recon, jenc.recon):
        _eq(g, w)
    for name in ("eobs", "block_is_inter", "intra_mode", "intra_uv_cfl",
                 "intra_alpha_u", "intra_alpha_v"):
        _eq(getattr(tenc, name), getattr(jenc, name))
    for p in range(3):
        for li in range(len(jenc.block_is_inter)):
            a, b = tenc.qcoeff[p][li], jenc.qcoeff[p][li]
            assert (a is None) == (b is None)
            if a is not None:
                _eq(tcommon.resolve_qc(a), jcommon.resolve_qc(b))
    assert (~tenc.block_is_inter).sum() == len(flips)


def test_flip_apply_matches_jax():
    jenc, tenc, flips = _flip_encoders()
    waves = jenc._flip_waves(flips)
    assert tenc._flip_waves(flips) == waves and len(waves) > 2
    _assert_flip_apply_equal(jenc, tenc, flips, waves)


def test_flip_apply_wide_wave_matches_jax():
    """One wave of 32 8x8 lanes (every other 8x8 block in both
    directions, so no flip's edges touch another's pixels): the JAX
    package re-chunks it into steps of at most 8 lanes, the port runs it
    in one step; the integers are the same."""
    leaves = {(r, c): 8 for r in range(0, H // 4, 2)
              for c in range(0, W // 4, 2)}
    jenc, tenc, flips = _flip_encoders(
        leaves, lambda i, r, c: r % 4 == 0 and c % 4 == 0)
    waves = jenc._flip_waves(flips)
    assert tenc._flip_waves(flips) == waves
    assert [len(w) for w in waves] == [32]
    _assert_flip_apply_equal(jenc, tenc, flips, waves)


@pytest.mark.parametrize("qindex,every", [(8, False), (20, True)])
def test_flip_apply_matches_the_jax_host_recode(qindex, every):
    """Where the JAX package's two flip recodes part, the port follows the
    host one (``_flip_apply_wave``, whose streams are the reference): it
    prices the chroma loops with the luma (plane type 0) trim and rate
    tables, its fused device programs with the chroma ones, and at these
    qindexes that changes a CfL or coefficient choice."""
    jenc, tenc, flips = _flip_encoders(
        pick=(lambda i, r, c: True) if every else None)
    fused, _, _ = _flip_encoders(
        pick=(lambda i, r, c: True) if every else None)
    for enc in (jenc, tenc, fused):
        enc.qp = jquant.make_quant_params(qindex)
        enc.lam = jrd.rd_lambda(qindex, 8)
    waves = jenc._flip_waves(flips)
    assert jdt.flip_apply_fused(fused, waves)
    _assert_flip_apply_equal(jenc, tenc, flips, waves, host=True,
                             fused_declines=False)
    same = [np.array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(fused.recon, jenc.recon)]
    same += [np.array_equal(getattr(fused, k), getattr(jenc, k))
             for k in ("eobs", "intra_uv_cfl")]
    assert not all(same)                 # the two JAX recodes part here


def test_flip_apply_at_qindex_0_with_rdoq_raises():
    """The flip apply at qindex 0 with RDOQ matches the JAX host recode
    (``_flip_apply_wave``, which gates the trim off there): the port's
    fused programs give the same integers, since the trim leaves qindex-0
    lanes untouched. (The name dates from when this case raised.)"""
    jenc, tenc, flips = _flip_encoders()
    assert jenc.cfg.enable_rdoq
    for enc in (jenc, tenc):
        enc.qp = jquant.make_quant_params(0)
        enc.lam = jrd.rd_lambda(0, 8)
    waves = jenc._flip_waves(flips)
    _assert_flip_apply_equal(jenc, tenc, flips, waves, host=True)
