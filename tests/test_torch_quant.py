"""The port's quantizer against the JAX package's.

``svt_av1_tpu_torch.ops.device.quantize_qv`` on CPU tensors runs its plain
PyTorch version; it must equal the JAX production quantizer ``quantize_qv``
(per-row qindex) and the Pallas kernel ``quantize_pallas`` (run in
interpret mode on the CPU, as tests/test_device_ops.py runs it) exactly.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import device as jdev
# production runs the JAX quantizer with x64 on (device_md turns it on)
from svt_av1_tpu.ops import device_md as _jdmd  # noqa: F401
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.utils.blocks import TX_4X4, TX_8X8, get_scan
from tests.torch_quant_cases import ROW_LENGTHS, tx_size_for
from tests.torch_threads import one_torch_thread  # noqa: F401
EXTREME = (0, 32767, -32767, 1 << 20, -(1 << 20), 1, -1)


def _case(n, seed, b=23):
    """Random coefficients in +-2^17, the extreme rows, per-row qindex
    with 0 and 255 present."""
    rng = np.random.default_rng(seed)
    coeff = rng.integers(-(1 << 17), (1 << 17) + 1, (b, n)).astype(np.int32)
    for i, v in enumerate(EXTREME):
        coeff[i] = v
    coeff[len(EXTREME), 1:] = 0            # only the DC coefficient set
    qv = rng.integers(0, 256, b).astype(np.int32)
    qv[:3] = (0, 255, 0)
    qv[-1] = 255
    return coeff, qv


def _port(coeff, scan, qv, ls):
    return [t.numpy() for t in dev.quantize_qv(
        torch.as_tensor(coeff), scan, torch.as_tensor(qv), ls, 8)]


@pytest.mark.parametrize("ls", [0, 1, 2])
@pytest.mark.parametrize("n", ROW_LENGTHS)
def test_quantize_qv_matches_jax(n, ls):
    coeff, qv = _case(n, seed=n + ls)
    scan = get_scan(tx_size_for(n, ls), 0)
    got = _port(coeff, scan, qv, ls)
    want = jdev.quantize_qv(jnp.asarray(coeff), scan, jnp.asarray(qv), ls, 8)
    for name, g, w in zip(("q", "dq", "eob"), got, want):
        assert np.array_equal(g, np.asarray(w)), name


@pytest.mark.parametrize("n,ls,qidx", [(16, 0, 20), (64, 0, 255),
                                       (256, 1, 120), (1024, 2, 0),
                                       (1024, 1, 220)])
def test_quantize_qv_matches_pallas(n, ls, qidx):
    coeff, _ = _case(n, seed=7 * n + ls, b=9)
    qv = np.full(len(coeff), qidx, np.int32)
    scan = get_scan(tx_size_for(n, ls), 0)
    got = _port(coeff, scan, qv, ls)
    want = jdev.quantize_pallas(jnp.asarray(coeff), scan,
                                jquant.make_quant_params(qidx), ls)
    for name, g, w in zip(("q", "dq", "eob"), got, want):
        assert np.array_equal(g, np.asarray(w)), name


def test_quantize_qv_eob_ties():
    """All-zero rows give eob 0; rows whose nonzeros sit at one scan
    position give that position; a dead-zone row quantizes to zero."""
    n = 64
    scan = get_scan(TX_8X8, 0)
    coeff = np.zeros((4, n), np.int32)
    coeff[1, 0] = 5000                       # DC only -> eob 1
    coeff[2, scan[10]] = -7000               # one coefficient -> eob 11
    coeff[3, :] = 3                          # inside the dead zone
    qv = np.array([0, 100, 200, 255], np.int32)
    q, dq, eob = _port(coeff, scan, qv, 0)
    want = jdev.quantize_qv(jnp.asarray(coeff), scan, jnp.asarray(qv), 0, 8)
    assert eob.tolist() == [0, 1, 11, 0]
    for g, w in zip((q, dq, eob), want):
        assert np.array_equal(g, np.asarray(w))


def test_quantize_qv_rejects_what_the_kernel_does_not_take():
    """The wrapper checks before it launches: a non-CPU, non-CUDA device
    and (on CUDA) dtype/shape are refused; a CPU tensor takes the plain
    version."""
    scan = get_scan(TX_4X4, 0)
    coeff = torch.zeros((2, 16), dtype=torch.int32)
    qv = torch.zeros(2, dtype=torch.int32)
    before = dev.LAUNCHES["quantize_qv"]
    q, _, eob = dev.quantize_qv(coeff, scan, qv, 0, 8)
    assert dev.LAUNCHES["quantize_qv"] == before   # plain: no launch
    assert q.dtype == torch.int32 and eob.tolist() == [0, 0]
    with pytest.raises(ValueError):
        dev.quantize_qv(coeff.to("meta"), scan, qv.to("meta"), 0, 8)
