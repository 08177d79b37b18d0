"""The port's fused quantization stage against the JAX package's chain.

``svt_av1_tpu_torch.ops.device_md.quant_stage_j`` on CPU tensors runs its
plain version (quantize, RDOQ-lite trim, CDF level rate); it must equal
the JAX production chain ``quantize_qv`` -> ``rdoq_trim_j`` ->
``_rate_cdf_j`` exactly (tolerance 0) over every row length, log_scale,
RDOQ on and off and both plane types, on batches with lossless and
qindex-255 rows, all-zero rows, +-2^20 rows, INT32_MIN, zero-lambda rows
whose trim costs tie and a lambda whose products wrap
(tests/torch_quant_cases.py). The CUDA kernel is held against the same
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import device as jdev
from svt_av1_tpu.ops import device_md as jmd
from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.ops import device_md as tmd
from tests.torch_quant_cases import (ROW_LENGTHS, TIE_ROWS, stage_case,
                                     tx_size_for)
from tests.torch_threads import one_torch_thread  # noqa: F401

OUT = ("q", "dq", "eob", "rate")


def _port(coeff, qv, lam, scan, ls, tx, plane_type, rdoq):
    T = torch.as_tensor
    return [t.numpy() for t in tmd.quant_stage_j(
        T(coeff), scan, T(qv), ls, 8, tx, plane_type,
        T(lam) if rdoq else None)]


def _jax(coeff, qv, lam, scan, ls, tx, plane_type, rdoq):
    qv_j = jnp.asarray(qv)
    q, dq, eob = jdev.quantize_qv(jnp.asarray(coeff), scan, qv_j, ls, 8)
    if rdoq:
        q, dq, eob = jmd.rdoq_trim_j(q, dq, eob, scan, tx, qv_j, plane_type,
                                     jnp.asarray(lam))
    rate = jmd._rate_cdf_j(q, eob, qv_j, plane_type, tx)
    return [np.asarray(a) for a in (q, dq, eob, rate)]


@pytest.mark.parametrize("plane_type", [0, 1])
@pytest.mark.parametrize("rdoq", [False, True])
@pytest.mark.parametrize("ls", [0, 1, 2])
@pytest.mark.parametrize("n", ROW_LENGTHS)
def test_quant_stage_matches_jax_chain(n, ls, rdoq, plane_type):
    coeff, qv, lam, scan, tx = stage_case(n, ls, b=22,
                                          seed=100 * n + 10 * ls + plane_type)
    got = _port(coeff, qv, lam, scan, ls, tx, plane_type, rdoq)
    want = _jax(coeff, qv, lam, scan, ls, tx, plane_type, rdoq)
    for name, g, w in zip(OUT, got, want):
        assert np.array_equal(g, w), name
    assert got[0].dtype == got[1].dtype == got[2].dtype == np.int32
    assert got[3].dtype == np.int64


@pytest.mark.parametrize("n,ls", [(16, 1), (64, 2), (256, 1)])
def test_quant_stage_zero_lambda_ties_keep_first_minimum(n, ls):
    """Level-1 coefficients at qindex 1 whose dq*dq*gq12 < 4096 add no
    distortion, so with lambda 0 every candidate eob costs 0: the first
    minimum is eob 0, in both frameworks."""
    coeff, qv, lam, scan, tx = stage_case(n, ls, b=12, seed=n + ls)
    rows = list(TIE_ROWS)
    before = _port(coeff, qv, lam, scan, ls, tx, 0, False)[2]
    got = _port(coeff, qv, lam, scan, ls, tx, 0, True)
    want = _jax(coeff, qv, lam, scan, ls, tx, 0, True)
    assert (before[rows] > 0).all()
    assert got[2][rows].tolist() == [0] * len(rows)
    assert not got[0][rows].any() and not got[1][rows].any()
    for name, g, w in zip(OUT, got, want):
        assert np.array_equal(g, w), name


def test_quant_stage_trim_fires_and_lossless_rows_keep_their_eob():
    """Over a 256-coefficient batch the trim shortens some rows; rows at
    qindex 0 keep the quantizer's eob and levels."""
    coeff, qv, lam, scan, tx = stage_case(256, 0, b=40, seed=9)
    plain = _port(coeff, qv, lam, scan, 0, tx, 0, False)
    trimmed = _port(coeff, qv, lam, scan, 0, tx, 0, True)
    assert (trimmed[2] < plain[2]).sum() >= 3
    lossless = qv == 0
    assert lossless.sum() >= 2
    for g, w in zip(trimmed[:3], plain[:3]):
        assert np.array_equal(g[lossless], w[lossless])


def test_quant_stage_on_cpu_runs_plain_and_refuses_other_devices():
    """A CPU tensor takes the plain version (no launch counted); a device
    with no kernel is refused before anything runs."""
    coeff, qv, lam, scan, tx = stage_case(64, 0, b=13, seed=4)
    T = torch.as_tensor
    before = dict(dev.LAUNCHES)
    got = tmd.quant_stage_j(T(coeff), scan, T(qv), 0, 8, tx, 1, T(lam))
    want = tmd.quant_stage_plain(T(coeff), scan, T(qv), 0, 8, tx, 1, T(lam))
    assert dict(dev.LAUNCHES) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        tmd.quant_stage_j(T(coeff).to("meta"), scan, T(qv).to("meta"), 0, 8,
                          tx, 1, T(lam).to("meta"))


def test_tx_size_for_covers_every_gq12():
    from svt_av1_tpu_torch.ops.quant import tx_scale
    scales = {tx_scale(tx_size_for(n, ls)) for n in ROW_LENGTHS
              for ls in (0, 1, 2)}
    assert scales == {0, 1, 2}
