"""The port's mode-decision program against the JAX package's.

Mirrors tests/test_device_md.py's decide cases (with and without tx
search, a rect size, CfL, forced chroma) with the port's
``decide_block_batch_dev(device="cpu")`` against the JAX
``decide_block_batch_dev``, plus ``rdoq_trim_j``, ``_rate_cdf_j`` and
``_full_loop_j`` at one shape and a fast-cost tie that only a stable
argsort breaks the JAX way. Every output must be equal (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import device_md as jmd
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu.pipeline import md as jhost_md
from svt_av1_tpu_torch.ops import device_md as tmd
from svt_av1_tpu_torch.ops import quant as quant_ops
from svt_av1_tpu_torch.pipeline import common, md, rd
from svt_av1_tpu_torch.utils.blocks import TX_16X16, get_scan
from tests.torch_threads import one_torch_thread  # noqa: F401

CANDS = [(0, 0), (1, 0), (2, 0), (9, 0), (12, 0), (1, -2), (4, 1)]
NAMES = ["modes", "deltas", "qcoeff", "eob", "recon", "cost", "alphas",
         "tts"]


def _batch(rng, b, bw, bh):
    srcs = rng.integers(0, 256, (b, bh, bw)).astype(np.int64)
    above1 = rng.integers(0, 256, (b, 1 + bw + bh)).astype(np.int32)
    left1 = rng.integers(0, 256, (b, 1 + bh + bw)).astype(np.int32)
    ha = rng.random(b) > 0.2
    hl = rng.random(b) > 0.2
    return srcs, above1, left1, ha, hl


def _assert_same(got, want):
    for n, g, w in zip(NAMES, got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), n


@pytest.mark.parametrize("plane,size,qidx,txs,rdoq", [
    (0, 8, 160, True, False),
    (0, (16, 8), 120, False, True),
    (1, 8, 160, False, True),
])
def test_decide_matches_jax(plane, size, qidx, txs, rdoq):
    rng = np.random.default_rng(0)
    bw, bh = common.leaf_wh(size)
    srcs, above1, left1, ha, hl = _batch(rng, 11, bw, bh)
    qp = quant_ops.make_quant_params(qidx)
    lam = rd.rd_lambda(qidx, 8)
    cfl = None
    if plane == 1:
        cfl = rng.integers(0, 256, (11, 2 * bh, 2 * bw)).astype(np.int64)
    kw = dict(bd=8, nfl=3, cfl_luma=cfl, tx_search=txs, rdoq=rdoq)
    want = jmd.decide_block_batch_dev(plane, srcs, above1, left1, ha, hl,
                                      CANDS, jquant.make_quant_params(qidx),
                                      size, lam, **kw)
    got = tmd.decide_block_batch_dev(plane, srcs, above1, left1, ha, hl,
                                     CANDS, qp, size, lam, device="cpu",
                                     **kw)
    _assert_same(got, want)


def test_decide_forced_matches_jax():
    rng = np.random.default_rng(1)
    srcs, above1, left1, ha, hl = _batch(rng, 6, 8, 8)
    fmodes = np.array([0, 13, 1, 13, 9, 2])
    fdeltas = np.zeros(6, np.int64)
    cfl = rng.integers(0, 256, (6, 16, 16)).astype(np.int64)
    lam = rd.rd_lambda(160, 8)
    kw = dict(forced=(fmodes, fdeltas), cfl_luma=cfl, rdoq=True)
    want = jmd.decide_block_batch_dev(2, srcs, above1, left1, ha, hl,
                                      CANDS[:4],
                                      jquant.make_quant_params(160), 8, lam,
                                      **kw)
    got = tmd.decide_block_batch_dev(2, srcs, above1, left1, ha, hl,
                                     CANDS[:4],
                                     quant_ops.make_quant_params(160), 8,
                                     lam, device="cpu", **kw)
    _assert_same(got, want)


def test_fast_cost_tie_keeps_candidate_order():
    """Flat edges make every mode predict the same block, and at lambda
    q 1 V and H cost the same in the fast loop ((2664 >> 8) ==
    (2562 >> 8)): the stable argsort keeps the first-listed one, as the
    JAX program and the host oracle do."""
    b = 5
    srcs = np.full((b, 16, 16), 90, np.int64)
    srcs[:, 8:] = 140
    above1 = np.full((b, 33), 120, np.int32)
    left1 = np.full((b, 33), 120, np.int32)
    ha = hl = np.ones(b, bool)
    qp = quant_ops.make_quant_params(100)
    for cands, want_mode in (([(2, 0), (1, 0)], 2), ([(1, 0), (2, 0)], 1)):
        got = tmd.decide_block_batch_dev(0, srcs, above1, left1, ha, hl,
                                         cands, qp, 16, 0.001, nfl=1,
                                         device="cpu")
        want = jmd.decide_block_batch_dev(0, srcs, above1, left1, ha, hl,
                                          cands,
                                          jquant.make_quant_params(100), 16,
                                          0.001, nfl=1)
        host = jhost_md.decide_block_batch(0, srcs, above1, left1, ha, hl,
                                           cands,
                                           jquant.make_quant_params(100),
                                           16, 0.001, nfl=1)
        assert got[0].tolist() == [want_mode] * b
        _assert_same(got, want)
        _assert_same(got, host)


def test_full_loop_rdoq_rate_match_jax():
    """_full_loop_j (with RDOQ-lite), rdoq_trim_j and _rate_cdf_j at one
    16x16 shape with per-lane qindex and lambda."""
    rng = np.random.default_rng(5)
    b = 13
    srcs = rng.integers(0, 256, (b, 16, 16)).astype(np.int64)
    preds = np.clip(srcs + rng.integers(-40, 41, (b, 16, 16)), 0, 255)
    qv = rng.integers(0, 256, b).astype(np.int32)
    qv[0] = 0
    lamqv = np.array([md.lam_to_q(rd.rd_lambda(int(q), 8)) for q in qv],
                     np.int64)
    tts = np.zeros(b, np.int32)
    T = torch.as_tensor
    got = tmd._full_loop_j(T(srcs), T(preds), T(tts), (0,), TX_16X16, 16,
                           T(qv), 8, 0, rdoq_lam_qv=T(lamqv))
    want = jmd._full_loop_j(jnp.asarray(srcs), jnp.asarray(preds),
                            jnp.asarray(tts), (0,), TX_16X16, 16,
                            jnp.asarray(qv), 8, 0,
                            rdoq_lam_qv=jnp.asarray(lamqv))
    for n, g, w in zip(("qcoeff", "eob", "recon", "dist", "rate"), got,
                       want):
        assert np.array_equal(g.numpy(), np.asarray(w)), n

    scan = get_scan(TX_16X16, 0)
    # large low-frequency coefficients and a few isolated small ones deep
    # in the scan: the tail the RDOQ-lite trim exists to drop
    in_scan = np.zeros((b, 256), np.int32)
    in_scan[:, :12] = rng.integers(-3000, 3001, (b, 12))
    in_scan[:, [90, 170, 240]] = rng.choice([-400, 400], (b, 3))
    in_scan[1] = 0
    coeff = np.zeros_like(in_scan)
    coeff[:, scan] = in_scan
    q, dq, eob = (t.numpy() for t in tmd.dev.quantize_qv(
        T(coeff), scan, T(qv), 0, 8))
    got = tmd.rdoq_trim_j(T(q), T(dq), T(eob), scan, TX_16X16, T(qv), 1,
                          T(lamqv))
    want = jmd.rdoq_trim_j(jnp.asarray(q), jnp.asarray(dq),
                           jnp.asarray(eob), scan, TX_16X16,
                           jnp.asarray(qv), 1, jnp.asarray(lamqv))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not np.array_equal(got[2].numpy(), eob), "trim should fire"
    got = tmd._rate_cdf_j(T(q), T(eob), T(qv), 1, TX_16X16)
    want = jmd._rate_cdf_j(jnp.asarray(q), jnp.asarray(eob),
                           jnp.asarray(qv), 1, TX_16X16)
    assert np.array_equal(got.numpy(), np.asarray(want))
