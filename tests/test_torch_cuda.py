"""On-card checks of the PyTorch port: the quantization kernel in both
modes (quantize-only and the fused quantize + RDOQ-lite trim + rate)
against its plain versions, launch counts, tie-breaks on CUDA, and the
encoder on ``cuda`` against the same encoder on the CPU.

Every test needs a CUDA device and skips without one (marker ``cuda``).
The file imports nothing of JAX, so it also runs on a GPU machine without
JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.ops import device_md as tmd
from svt_av1_tpu_torch.ops import quant as quant_ops
from svt_av1_tpu_torch.utils.blocks import (TX_4X4, TX_8X8, TX_16X16,
                                            TX_32X32, get_scan)
from tests.torch_quant_cases import TIE_ROWS, stage_case, stage_rows

pytestmark = pytest.mark.cuda
TX_OF_N = {16: TX_4X4, 64: TX_8X8, 256: TX_16X16, 1024: TX_32X32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(n, seed, b):
    rng = np.random.default_rng(seed)
    coeff = rng.integers(-(1 << 17), (1 << 17) + 1, (b, n)).astype(np.int32)
    for i, v in enumerate((0, 32767, -32767, 1 << 20, -(1 << 20))):
        coeff[i] = v
    qv = rng.integers(0, 256, b).astype(np.int32)
    qv[:2] = (0, 255)
    return coeff, qv


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
def test_quantize_qv_kernel_matches_plain(cuda, n):
    scan = get_scan(TX_OF_N[n], 0)
    for ls in (0, 1, 2):
        coeff, qv = _case(n, seed=3 * n + ls, b=1001)
        c = torch.as_tensor(coeff, device=cuda)
        q = torch.as_tensor(qv, device=cuda)
        before = dev.LAUNCHES["quantize_qv"]
        got = dev.quantize_qv(c, scan, q, ls, 8)
        assert dev.LAUNCHES["quantize_qv"] == before + 1
        want = dev.quantize_qv_plain(c, scan, q, ls, 8)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        cpu = dev.quantize_qv(torch.as_tensor(coeff), scan,
                              torch.as_tensor(qv), ls, 8)
        for g, w in zip(got, cpu):
            assert torch.equal(g.cpu(), w)


def test_quantize_qv_kernel_refuses_bad_operands(cuda):
    scan = get_scan(TX_4X4, 0)
    c = torch.zeros((3, 16), dtype=torch.int32, device=cuda)
    q = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dev.quantize_qv(c.to(torch.int64), scan, q, 0, 8)
    with pytest.raises(ValueError):
        dev.quantize_qv(c, scan, q.to(torch.int64), 0, 8)
    with pytest.raises(ValueError):
        dev.quantize_qv(c[:, :8], scan[:8], q, 0, 8)
    with pytest.raises(ValueError):
        dev.quantize_qv(torch.zeros((16, 3), dtype=torch.int32,
                                    device=cuda).t(), scan, q, 0, 8)
    q_, _, eob = dev.quantize_qv(c[:0], scan, q[:0], 0, 8)
    assert q_.shape == (0, 16) and eob.shape == (0,)


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
def test_quant_stage_kernel_matches_plain(cuda, n):
    """Both modes of the kernel against their plain versions on the card
    and on the CPU, exact, over log_scale, plane type, RDOQ on/off and
    B in {0, 1, 8, 37, 1001}; each call with rows is one launch."""
    for ls in (0, 1, 2):
        for b in (0, 1, 8, 37, 1001):
            coeff, qv, lam, scan, tx = stage_rows(n, ls, b, 7 * n + ls + b)
            c, q, lm = (torch.as_tensor(a, device=cuda)
                        for a in (coeff, qv, lam))
            before = dev.LAUNCHES["quantize_qv"]
            got = dev.quantize_qv(c, scan, q, ls, 8)
            assert dev.LAUNCHES["quantize_qv"] == before + (b > 0)
            want = dev.quantize_qv_plain(c, scan, q, ls, 8)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            for plane_type in (0, 1):
                for rl, mode in ((None, "quant_stage"),
                                 (lm, "quant_stage_rdoq")):
                    before = dev.LAUNCHES[mode]
                    got = tmd.quant_stage_j(c, scan, q, ls, 8, tx,
                                            plane_type, rl)
                    assert dev.LAUNCHES[mode] == before + (b > 0)
                    want = tmd.quant_stage_plain(c, scan, q, ls, 8, tx,
                                                 plane_type, rl)
                    cpu = tmd.quant_stage_j(
                        torch.as_tensor(coeff), scan, torch.as_tensor(qv),
                        ls, 8, tx, plane_type,
                        None if rl is None else torch.as_tensor(lam))
                    for g, w, h in zip(got, want, cpu):
                        assert g.dtype == w.dtype and g.shape == w.shape
                        assert torch.equal(g, w)
                        assert torch.equal(g.cpu(), h)


def test_full_loop_pass_is_one_launch_on_card(cuda):
    """One full-loop pass (luma, one tx type, one candidate) launches the
    fused kernel once and nothing else of the quantizer."""
    rng = np.random.default_rng(1)
    b = 9
    srcs = rng.integers(0, 256, (b, 16, 16))
    edges = rng.integers(0, 256, (b, 33)).astype(np.int32)
    ha = np.ones(b, bool)
    qp = quant_ops.make_quant_params(70)
    before = dict(dev.LAUNCHES)
    tmd.decide_block_batch_dev(0, srcs, edges, edges, ha, ha, [(0, 0)], qp,
                               16, 30.0, nfl=1, rdoq=True, device="cuda")
    assert dev.LAUNCHES["quant_stage_rdoq"] == \
        before.get("quant_stage_rdoq", 0) + 1
    for mode in ("quant_stage", "quantize_qv"):
        assert dev.LAUNCHES[mode] == before.get(mode, 0)


def test_quant_stage_refuses_bad_operands(cuda):
    coeff, qv, lam, scan, tx = stage_case(64, 0, 12, 3)
    c, q, lm = (torch.as_tensor(a, device=cuda) for a in (coeff, qv, lam))
    with pytest.raises(ValueError):
        tmd.quant_stage_j(c, scan, q, 0, 8, tx, 0, lm.to(torch.int32))
    with pytest.raises(ValueError):
        tmd.quant_stage_j(c, scan, q, 0, 8, tx, 0, lm[:5])
    buf = torch.zeros(c.numel() + 4, dtype=torch.int32, device=cuda)
    misaligned = buf[1:1 + c.numel()].view(c.shape)     # 4 B past 16 B
    misaligned.copy_(c)
    with pytest.raises(ValueError):
        tmd.quant_stage_j(misaligned, scan, q, 0, 8, tx, 0, lm)


def test_fast_cost_tie_keeps_candidate_order_on_card(cuda):
    """V and H tie in the fast loop (flat edges, lambda q 1): the stable
    argsort keeps the first-listed mode on the card as on the CPU."""
    b = 300
    srcs = np.full((b, 16, 16), 90, np.int64)
    srcs[:, 8:] = 140
    edges = np.full((b, 33), 120, np.int32)
    ha = np.ones(b, bool)
    qp = quant_ops.make_quant_params(100)
    for cands, want_mode in (([(2, 0), (1, 0)], 2), ([(1, 0), (2, 0)], 1)):
        outs = [tmd.decide_block_batch_dev(0, srcs, edges, edges, ha, ha,
                                           cands, qp, 16, 0.001, nfl=1,
                                           device=d)
                for d in ("cuda", "cpu")]
        assert outs[0][0].tolist() == [want_mode] * b
        for g, w in zip(*outs):
            assert np.array_equal(g, w)


def test_rdoq_first_minimum_on_card(cuda):
    """rdoq_trim_j's argmin keeps the first of equal trim costs on CUDA:
    zero-lambda rows make every candidate eob past the last nonzero
    coefficient cost the same."""
    scan = get_scan(TX_16X16, 0)
    rng = np.random.default_rng(2)
    b = 64
    qc = np.zeros((b, 256), np.int32)
    qc[:, scan[:5]] = rng.integers(1, 4, (b, 5))
    dq = qc * 40
    eob = np.full(b, 9, np.int32)             # 4 trailing zeros in scan
    qv = np.full(b, 120, np.int32)
    lam = np.zeros(b, np.int64)
    outs = []
    for d in ("cuda", "cpu"):
        T = (lambda a, d=d: torch.as_tensor(a, device=d))
        outs.append([t.cpu() for t in tmd.rdoq_trim_j(
            T(qc), T(dq), T(eob), scan, TX_16X16, T(qv), 0, T(lam))])
    assert outs[0][2].tolist() == [5] * b
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    # the fused kernel: level-1 rows at qindex 1 and lambda 0 cost the
    # same at every candidate eob, so the first minimum is eob 0
    for n, ls in ((16, 1), (64, 2), (256, 1)):
        coeff, qv, lam, scan, tx = stage_case(n, ls, 12, n + ls)
        outs = []
        for d in ("cuda", "cpu"):
            T = (lambda a, d=d: torch.as_tensor(a, device=d))
            outs.append([t.cpu() for t in tmd.quant_stage_j(
                T(coeff), scan, T(qv), ls, 8, tx, 0, T(lam))])
        rows = list(TIE_ROWS)
        assert outs[0][2][rows].tolist() == [0] * len(rows)
        for g, w in zip(*outs):
            assert torch.equal(g, w)


def test_encode_on_card_equals_cpu(cuda):
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=200, h=120, frames=2, seed=3)
    ivf = {d: encode_ivf(frames, preset_config(width=200, height=120,
                                               preset=5, intra_period=0,
                                               device=d))
           for d in ("cuda", "cpu")}
    assert ivf["cuda"] == ivf["cpu"]
