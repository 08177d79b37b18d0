"""The port's last device twins against the JAX package (exact):

- the CDEF and loop-restoration block twins of ``ops/device.py``
  (``cdef_find_dir_batch``, ``cdef_filter_blocks``,
  ``wiener_filter_batch``, ``sgr_filter_batch``) against the JAX
  package's host oracles, the twins of ``tests/test_device_ops.py``'s
  device-twin tests with their inputs;
- the three ``ops/device_inter.py`` programs that no encoder path
  reaches (``ref_candidates_dev``, ``chroma_multi_dev``, ``flip_rd_dev``)
  against the JAX package's functions at one small size (B = 8).
"""

import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import cdef as jcdef
from svt_av1_tpu.ops import device_inter as jdi
from svt_av1_tpu.ops import mc as jmc
from svt_av1_tpu.ops import me as jme
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu.ops import restoration as jrst
from svt_av1_tpu.pipeline import rd as jrd
from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.ops import device_inter as tdi
from svt_av1_tpu_torch.ops import quant as tquant
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_cdef_twins_equal_the_host():
    """Direction search + filter vs the host oracles, with flat extremes
    and a hard edge among the blocks."""
    rng = np.random.RandomState(0)
    b = 41
    blocks = rng.randint(0, 256, (b, 8, 8)).astype(np.int32)
    blocks[0] = 255
    blocks[1] = 0
    blocks[2, :, :4] = 255
    gd, gv = dev.cdef_find_dir_batch(torch.from_numpy(blocks), 0)
    assert gd.dtype == torch.int32 and gv.dtype == torch.int64
    for i in range(b):
        assert jcdef.find_dir(blocks[i], 0) == (int(gd[i]), int(gv[i])), i
    wins = np.full((b, 14, 14), jcdef.CDEF_VERY_LARGE, dtype=np.int32)
    wins[:, 3:11, 3:11] = blocks
    wins[:, :3, :] = rng.randint(0, 256, (b, 3, 14))
    pri = rng.choice([0, 4, 8, 15], b).astype(np.int32)
    sec = rng.choice([0, 1, 2, 4], b).astype(np.int32)
    dirs = rng.randint(0, 8, b).astype(np.int32)
    got = dev.cdef_filter_blocks(
        *(torch.from_numpy(a) for a in (wins, pri, sec, dirs)), 3, 3,
        0).numpy()
    for i in range(b):
        want = jcdef.filter_block(wins[i].astype(np.int64), 3, 3, 8, 8,
                                  int(pri[i]), int(sec[i]), int(dirs[i]),
                                  3, 3, 0)
        assert np.array_equal(got[i], want), i


def test_lr_twins_equal_the_host():
    """Wiener + self-guided restoration vs the host oracles over batched
    stripe windows."""
    rng = np.random.RandomState(1)
    b, h, w = 7, 24, 40
    x = rng.randint(0, 256, (b, h + 6, w + 6)).astype(np.int64)
    x[0] = 255
    xt = torch.from_numpy(x)
    tv, th = (2, -5, 18), (-3, 6, 11)
    want = np.stack([jrst.wiener_filter(x[i], tv, th, 8) for i in range(b)])
    assert np.array_equal(dev.wiener_filter_batch(xt, tv, th, 8).numpy(),
                          want)
    for ep, xqd in ((4, (-20, 40)), (11, (0, 33)), (14, (-50, 0))):
        want = np.stack([jrst.sgr_filter(x[i], ep, xqd, 8)
                         for i in range(b)])
        got = dev.sgr_filter_batch(xt, ep, xqd, 8).numpy()
        assert np.array_equal(got, want), ep


@pytest.fixture(scope="module")
def inter_case():
    """A 96x64 source, a reference that is the source shifted on the
    left half (with replaced rows) and static on the right, 8 block
    positions, and both packages' quantizers at qindex 120."""
    rng = np.random.default_rng(4)
    src = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    ref = src.copy()
    ref[:, :48] = np.roll(src, (2, -3), axis=(0, 1))[:, :48]
    ref[::7, :48] = rng.integers(0, 256, (len(ref[::7]), 48))
    xs = np.array([0, 16, 32, 48, 64, 80, 0, 16])
    ys = np.array([0, 0, 16, 16, 32, 32, 48, 48])
    return dict(rng=rng, src=src, ref=ref, xs=xs, ys=ys,
                jqp=jquant.make_quant_params(120),
                tqp=tquant.make_quant_params(120),
                lam=jrd.rd_lambda(120, 8))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("rdoq", [False, True])
def test_ref_candidates_dev_equals_jax(inter_case, rdoq):
    c = inter_case
    rp = jme.build_pyramid(jmc.pad_reference(c["ref"]))
    sp = jme.src_pyramid(c["src"])
    want = jdi.ref_candidates_dev(rp, sp, c["xs"], c["ys"], 16, c["jqp"],
                                  c["lam"], rdoq=rdoq)
    got = tdi.ref_candidates_dev(rp, sp, c["xs"], c["ys"], 16, c["tqp"],
                                 c["lam"], rdoq=rdoq, device="cpu")
    _same(got, want)
    assert (want[1] == 0).all(axis=1).any() \
        and (want[1] != 0).any(axis=1).any(), "moving and static blocks"


def test_chroma_multi_dev_equals_jax(inter_case):
    c = inter_case
    su, sv = c["src"][::2, ::2].copy(), c["src"][1::2, 1::2].copy()
    ru = [jmc.pad_reference(np.roll(su, k, 1)) for k in range(3)]
    rv = [jmc.pad_reference(np.roll(sv, -k, 0)) for k in range(3)]
    mvs = c["rng"].integers(-20, 20, (8, 2))
    ridx = np.array([0, 1, 2, 0, 1, 2, 2, 1])
    args = (ru, rv, su, sv, c["xs"] // 2, c["ys"] // 2, mvs, ridx, 8)
    _same(tdi.chroma_multi_dev(*args, c["tqp"], lam=c["lam"], rdoq=True,
                               device="cpu"),
          jdi.chroma_multi_dev(*args, c["jqp"], lam=c["lam"], rdoq=True))


def test_flip_rd_dev_equals_jax(inter_case):
    c = inter_case
    srcs = np.stack([c["src"][y:y + 16, x:x + 16]
                     for x, y in zip(c["xs"], c["ys"])])
    preds = c["rng"].integers(0, 256, (3, 8, 16, 16))
    _same(tdi.flip_rd_dev(srcs, preds, 16, c["tqp"], lam=c["lam"],
                          rdoq=True, device="cpu"),
          jdi.flip_rd_dev(srcs, preds, 16, c["jqp"], lam=c["lam"],
                          rdoq=True))


def test_inter_programs_need_the_card_by_default(inter_case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the programs run there")
    c = inter_case
    srcs = np.zeros((1, 16, 16), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdi.flip_rd_dev(srcs, srcs[None], 16, c["tqp"])
