"""The port's own mirror decoder and independent checker.

``svt_av1_tpu_torch.pipeline.decode`` and ``svt_av1_tpu_torch.verify.indep``
are NumPy copies of the JAX package's; they judge the port's streams where
no JAX is installed (the card machine). Here, on port streams of the
configurations the port runs (the intra edge filter, compound and TMVP,
CDEF + LR + both inter searches, 10 bits, delta-q, film grain, tile rows):
the port's ``decode_ivf`` must reproduce the port encoder's display recon
and equal the JAX package's ``decode_ivf`` exactly, the port's
``check_ivf`` must check as many blocks as the JAX one, and it must raise
``MismatchError`` when the port decoder's intra predictor or motion
compensation is perturbed (as tests/test_indep_verify.py does for the JAX
package). The decoder CLI writes the JAX tool's yuv.
"""

import dataclasses
import importlib
import io

import numpy as np
import pytest

from svt_av1_tpu.app import decode_cli as jdecode_cli
from svt_av1_tpu.pipeline.decode import decode_ivf as jax_decode_ivf
from svt_av1_tpu.verify.indep import check_ivf as jax_check_ivf
from svt_av1_tpu_torch.app import decode_cli
from svt_av1_tpu_torch.app.cli import preset_config
from svt_av1_tpu_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from svt_av1_tpu_torch.pipeline import decode as decode_mod
from svt_av1_tpu_torch.pipeline.encoder import Encoder
from svt_av1_tpu_torch.utils.clip import make_clip
from svt_av1_tpu_torch.verify.indep import MismatchError, check_ivf
from tests.torch_threads import one_torch_thread  # noqa: F401

# name: (w, h, frames, preset_config options, EncoderConfig fields, a
#        function of the port's (module, name) that its decoder must run on
#        the stream: the tool is in it)
STREAMS = {
    "preset2_all_intra": (64, 64, 1, dict(preset=2, intra_period=0), {},
                          ("ops.intra", "prepare_edges_av1")),
    "ra_hier2": (128, 64, 5, dict(preset=5, hierarchical_levels=2), {},
                 ("pipeline.mvp", "find_mv_stack_comp")),
    "preset0_ra": (128, 64, 3, dict(preset=0, hierarchical_levels=1), {},
                   ("ops.cdef", "cdef_frame")),
    "ld_p_10bit": (64, 64, 3, dict(preset=5, bit_depth=10), {},
                   ("entropy.mv", "read_mv")),
    "aq1": (128, 64, 3, dict(preset=5, hierarchical_levels=1),
            dict(adaptive_quantization=1),
            ("entropy.delta", "read_delta_qindex")),
    "grain10": (64, 64, 2, dict(preset=5, film_grain=10), {},
                ("ops.grain", "apply_grain")),
    "two_tile_rows": (64, 128, 2, dict(preset=5, tile_rows=1), {},
                      ("pipeline.common", "tile_rects")),
}


def _encode(name):
    """The port's stream of ``name`` on the CPU: (IVF bytes, display
    recons)."""
    w, h, n, opts, fields, _ = STREAMS[name]
    frames = make_clip(w=w, h=h, frames=n, seed=3)
    if opts.get("bit_depth") == 10:
        frames = [tuple(p.astype(np.uint16) << 2 for p in f)
                  for f in frames]
    cfg = dataclasses.replace(
        preset_config(width=w, height=h, device="cpu", **opts), **fields)
    enc = Encoder(cfg)
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, cfg.frame_rate_num, cfg.frame_rate_den, n)
    recons, pts = [], 0

    def drain():
        nonlocal pts
        while (pkt := enc.get_packet()) is not None:
            write_ivf_frame(buf, pkt[0], pts)
            pts += 1
            if pkt[1] is not None:
                recons.append(pkt[1])

    for f in frames:
        enc.send_picture(*f)
        drain()
    enc.flush()
    drain()
    return buf.getvalue(), recons


@pytest.fixture(scope="module")
def streams():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _encode(name)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decoder_reproduces_the_recon_and_the_jax_decoder(name, streams,
                                                          monkeypatch):
    ivf, recons = streams(name)
    mod, fn = STREAMS[name][5]
    module = importlib.import_module("svt_av1_tpu_torch." + mod)
    real, calls = getattr(module, fn), []

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, fn, spy)
    got = decode_mod.decode_ivf(io.BytesIO(ivf))
    monkeypatch.undo()
    assert calls, f"{mod}.{fn} never ran on the {name} stream"
    want = jax_decode_ivf(io.BytesIO(ivf))
    assert len(got) == len(recons) == len(want) == STREAMS[name][2]
    for g, r, w in zip(got, recons, want):
        for pg, pr, pw in zip(g, r, w):
            assert pg.dtype == pw.dtype
            np.testing.assert_array_equal(pg, pr)
            np.testing.assert_array_equal(pg, pw)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_checker_counts_the_jax_checkers_blocks(name, streams):
    ivf, _ = streams(name)
    n = check_ivf(io.BytesIO(ivf))
    assert n > 0
    assert n == jax_check_ivf(io.BytesIO(ivf))


def test_checker_catches_a_perturbed_intra_predictor(streams, monkeypatch):
    """One pixel of every DC and SMOOTH prediction off by 4 in the port
    decoder's ``ops.intra``: the checker's scalar predictors flag it."""
    from svt_av1_tpu_torch.ops import intra as intra_ops
    real = intra_ops.predict_any

    def buggy(mode, angle_delta, above1, left1, bw, bh, ha, hl, bd=8,
              **kw):
        out = real(mode, angle_delta, above1, left1, bw, bh, ha, hl,
                   bd=bd, **kw)
        if mode in (0, 9):               # DC, SMOOTH: one interior pixel
            out = out.copy()
            out[..., bh // 2, bw // 2] = np.clip(
                out[..., bh // 2, bw // 2] + 4, 0, (1 << bd) - 1)
        return out

    ivf, _ = streams("preset2_all_intra")
    monkeypatch.setattr(intra_ops, "predict_any", buggy)
    assert decode_mod.intra_ops.predict_any is buggy
    with pytest.raises(MismatchError):
        check_ivf(io.BytesIO(ivf))


def test_checker_catches_a_perturbed_motion_compensation(streams,
                                                          monkeypatch):
    """One pixel of every single-reference prediction off by 3 in the
    port decoder's ``ops.mc``: the checker's scalar convolve flags it."""
    from svt_av1_tpu_torch.ops import mc as mc_ops
    real = mc_ops.mc_block_batch

    def buggy(ref_padded, xs, ys, mvs, w, h, ss=0, bd=8, ftype=0):
        out = real(ref_padded, xs, ys, mvs, w, h, ss=ss, bd=bd,
                   ftype=ftype).copy()
        out[..., h // 2, w // 2] = np.clip(
            out[..., h // 2, w // 2].astype(np.int64) + 3, 0,
            (1 << bd) - 1).astype(out.dtype)
        return out

    ivf, _ = streams("ld_p_10bit")
    monkeypatch.setattr(mc_ops, "mc_block_batch", buggy)
    with pytest.raises(MismatchError):
        check_ivf(io.BytesIO(ivf))


def test_decode_cli_writes_the_jax_tools_yuv(streams, tmp_path):
    ivf, recons = streams("ra_hier2")
    src = tmp_path / "in.ivf"
    src.write_bytes(ivf)
    assert decode_cli.main([str(src), str(tmp_path / "port.yuv")]) == 0
    assert jdecode_cli.main([str(src), str(tmp_path / "jax.yuv")]) == 0
    got = (tmp_path / "port.yuv").read_bytes()
    assert got == (tmp_path / "jax.yuv").read_bytes()
    assert got == b"".join(p.tobytes() for r in recons for p in r)
