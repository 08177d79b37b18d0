"""The port's analysis entry steps and entry point against the JAX package.

``svt_av1_tpu_torch.ops.device``'s static-qindex ``quantize``,
``mode_decision_sse``, ``intra_analysis_step``, ``inter_core_step`` and
``inter_core_subpel_step`` run on CPU tensors (the plain quantizer; on
the card they launch csrc/quant.cu, held by tests/test_torch_cuda.py and
chip_smoke.py) and must equal the JAX package's functions on the same
numpy-seeded inputs exactly (tolerance 0: the pixel path is integer),
with the inputs of tests/test_device_ops.py. ``entry(device="cpu")``
gives the JAX ``__graft_entry__.entry()``'s outputs. Last, the kernel
build's lock: two threads that reach a cold build directory build once.
"""

import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from svt_av1_tpu.ops import device as jdev
from svt_av1_tpu.ops import mc as jmc
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu_torch import cuda_build, native
from svt_av1_tpu_torch.entry import entry
from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.utils.blocks import (DC_PRED, H_PRED, PAETH_PRED,
                                            SMOOTH_H_PRED, SMOOTH_PRED,
                                            SMOOTH_V_PRED, V_PRED,
                                            MAX_TX_SIZE_OF_BLOCK, get_scan)
from tests.torch_threads import one_torch_thread  # noqa: F401

MODES = (DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, SMOOTH_V_PRED,
         SMOOTH_H_PRED, PAETH_PRED)
STEP_MODES = (DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED)


def _equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _intra_inputs(size, bd, b, seed):
    """test_device_ops.py's intra inputs at ``bd`` bits; both edges
    present on every block, or drawn at random."""
    rng = np.random.default_rng(seed)
    hi = 1 << bd
    src = rng.integers(0, hi, (b, size, size)).astype(np.int32)
    above = rng.integers(0, hi, (b, 2 * size)).astype(np.int32)
    left = rng.integers(0, hi, (b, 2 * size)).astype(np.int32)
    tl = rng.integers(0, hi, b).astype(np.int32)
    ha = rng.integers(0, 2, b).astype(bool)
    hl = rng.integers(0, 2, b).astype(bool)
    ha[:2] = hl[:2] = True
    return src, above, left, tl, ha, hl


# log_scale 0, 1 and 2: the coded 16x16, 32x32, and 32x32 corner of 64x64
@pytest.mark.parametrize("qindex", [0, 160, 255])
@pytest.mark.parametrize("size", [16, 32, 64])
@pytest.mark.parametrize("bd", [8, 10])
def test_static_quantize_equals_jax(size, qindex, bd):
    rng = np.random.default_rng(qindex + size + bd)
    tx_size = MAX_TX_SIZE_OF_BLOCK[size]
    n = min(size, 32) ** 2
    coeff = rng.integers(-(1 << (bd + 9)), 1 << (bd + 9),
                         (16, n)).astype(np.int32)
    coeff[0] = 0
    scan = get_scan(tx_size, 0)
    ls = jquant.tx_scale(tx_size)
    assert ls == {16: 0, 32: 1, 64: 2}[size]
    qp = jquant.make_quant_params(qindex, bit_depth=bd)
    want = jdev.quantize(jnp.asarray(coeff), scan, qp, ls)
    from svt_av1_tpu_torch.ops import quant as tquant
    got = dev.quantize(torch.as_tensor(coeff), scan,
                       tquant.make_quant_params(qindex, bit_depth=bd), ls,
                       bd)
    _equal(want, got)


def test_static_quantize_refuses_a_delta_row():
    from svt_av1_tpu_torch.ops import quant as tquant
    scan = get_scan(MAX_TX_SIZE_OF_BLOCK[16], 0)
    coeff = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="table's row"):
        dev.quantize(coeff, scan, tquant.make_quant_params(100, dc_delta=3),
                     0)
    with pytest.raises(ValueError, match="table's row"):
        dev.quantize(coeff, scan, tquant.make_quant_params(100), 0, bd=10)


@pytest.mark.parametrize("size", [4, 16, 32])
def test_mode_decision_sse_equals_jax(size):
    ins = _intra_inputs(size, 8, 12, size)
    want = jdev.mode_decision_sse(MODES, *(jnp.asarray(a) for a in ins),
                                  size, size)
    got = dev.mode_decision_sse(MODES, *(torch.as_tensor(a) for a in ins),
                                size, size)
    _equal(want, got)
    assert got[0].dtype == got[2].dtype == torch.int32
    np.testing.assert_array_equal(jdev.intra_sm_weights(size),
                                  dev.intra_sm_weights(size))


@pytest.mark.parametrize("size,qindex,bd", [
    (16, 160, 8), (16, 255, 10), (32, 0, 8), (32, 160, 10), (64, 255, 8),
    (64, 0, 10)])
def test_intra_analysis_step_equals_jax(size, qindex, bd):
    ins = _intra_inputs(size, bd, 24 if size < 64 else 8, size + bd)
    want = jdev.intra_analysis_step(*(jnp.asarray(a) for a in ins),
                                    modes=STEP_MODES, size=size,
                                    qindex=qindex, bd=bd)
    got = dev.intra_analysis_step(*(torch.as_tensor(a) for a in ins),
                                  modes=STEP_MODES, size=size,
                                  qindex=qindex, bd=bd)
    _equal(want, got)
    assert all(g.dtype == torch.int32 for g in got)


def _pan(noise: bool):
    """test_device_ops.py's pan: cur is the reference moved by (6, -4)
    pels, with +-2 noise when ``noise``."""
    rng = np.random.default_rng(3)
    h, w = 128, 192
    big = rng.integers(0, 256, (h + 64, w + 64)).astype(np.int32)
    ref = big[32:32 + h, 32:32 + w]
    cur = big[32 + 6:32 + 6 + h, 32 - 4:32 - 4 + w]
    if noise:
        cur = np.clip(cur + rng.integers(-2, 3, cur.shape), 0, 255)
    return cur.astype(np.int32), ref


@pytest.mark.parametrize("noise", [False, True])
def test_inter_core_step_equals_jax(noise):
    cur, ref = _pan(noise)
    refp = np.pad(ref, 16, mode="edge")[8:-8, 8:-8]   # pad = search range
    want = jdev.inter_core_step(jnp.asarray(cur), jnp.asarray(refp),
                                size=16, search_range=8, qindex=160)
    got = dev.inter_core_step(torch.as_tensor(cur), torch.as_tensor(refp),
                              size=16, search_range=8, qindex=160)
    _equal(want, got)
    assert (got[0][:, 0] == 6).float().mean() > 0.8
    with pytest.raises(ValueError, match="cannot slice"):
        dev.inter_core_step(torch.as_tensor(cur),
                            torch.as_tensor(refp[:-1]), size=16,
                            search_range=8)


def test_inter_core_subpel_step_equals_jax():
    """test_device_ops.py's 2.5-px pan through the 8-tap MC on the left
    half, a (-1.25, 3.75)-px one on the right: the half- and quarter-pel
    sweep must move most blocks of both halves off the full-pel grid."""
    rs = np.random.RandomState(0)
    h, w = 128, 192
    ref = rs.randint(0, 256, (h, w)).astype(np.uint8)
    padded = jmc.pad_reference(ref).astype(np.int32)
    cur = np.zeros((h, w), np.int32)
    for y in range(0, h, 16):
        for x in range(0, w, 16):
            mv = [[0, 20]] if x < w // 2 else [[-10, 30]]
            cur[y:y + 16, x:x + 16] = jmc.mc_block_batch(
                padded, np.array([x]), np.array([y]), np.array(mv),
                16, 16)[0]
    fn = jax.jit(jdev.inter_core_subpel_step,
                 static_argnames=("size", "search_range", "search_step",
                                  "qindex", "bd"))
    want = fn(jnp.asarray(cur), jnp.asarray(padded))
    got = dev.inter_core_subpel_step(torch.as_tensor(cur),
                                     torch.as_tensor(padded))
    _equal(want, got)
    inner = got[0].numpy().reshape(8, 12, 2)[1:-1, 1:-1]
    assert (inner[:, :5] == [0, 20]).all(-1).mean() > 0.8
    assert (inner[:, 5:] == [-10, 30]).all(-1).mean() > 0.8


def test_entry_equals_jax_entry():
    jfn, jargs = jax_entry.entry()
    fn, args = entry(device="cpu")
    for a, b in zip(jargs, args):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _equal(jfn(*jargs), fn(*args))


def test_entry_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def _race(build, n_threads=2, timeout=120):
    """Run ``build`` on ``n_threads`` threads at once; return their
    results (every thread must finish without an error)."""
    results, errors = [None] * n_threads, []
    start = threading.Barrier(n_threads)

    def run(i):
        start.wait()
        try:
            results[i] = build()
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive()
    assert not errors, errors
    return results


def test_kernel_build_race_builds_once(tmp_path, monkeypatch):
    """Two threads reach the kernel's first use on an empty build
    directory: one compile (a fake nvcc that sleeps and writes its -o
    file, so the two would overlap without the lock), both succeed."""
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo x >> {log}\n"
        "sleep 1\n"
        'while [ "$1" != -o ]; do shift; done\n'
        'echo lib > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path / "build" / "cuda")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(fake))
    _race(lambda: cuda_build.build_all(["quant"]))
    assert log.read_text().count("x") == 1
    lib = cuda_build.library_path("quant")
    assert lib.read_text() == "lib\n"
    assert sorted(p.name for p in lib.parent.iterdir()) \
        == sorted([lib.name, ".lock"])


def test_native_build_race_builds_once(tmp_path, monkeypatch):
    """The same for the native range coder (gcc): two threads on an
    empty build directory, one compile, the same library."""
    calls = []
    real = subprocess.check_call

    def counted(cmd, *a, **k):
        calls.append(cmd)
        return real(cmd, *a, **k)

    monkeypatch.setattr(native, "_BUILD", tmp_path / "native")
    monkeypatch.setattr(native.subprocess, "check_call", counted)
    so = _race(native._build)
    assert len(calls) == 1
    assert so[0] == so[1] and so[0].exists()
