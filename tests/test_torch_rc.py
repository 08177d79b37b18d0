"""Rate control and checkpoints in the port (svt_av1_tpu_torch) against the
JAX package.

VBR streams, with and without lookahead, go through the port's
``encode_ivf`` on the CPU and through the JAX package's with the host
backend; the IVF bytes must be identical (tolerance 0): the controller's
model is NumPy float64 in both, and each frame's bits reach it before the
next frame's qindex is chosen. A scene cut inside the lookahead window
truncates the complexity window. Checkpoints: a stream saved mid-GOP
(lookahead and pyramid buffers full) and resumed in a new encoder equals
the uninterrupted stream, and so does a JAX encoder's checkpoint resumed
in the port through ``convert.state_from_jax``. Under AQ, whose history
no checkpoint holds, the port's resumed stream equals the JAX package's.
"""

import copy
import dataclasses
from types import SimpleNamespace

import pytest

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.pipeline.encoder import Encoder as JaxEncoder
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.convert import config_from_jax, state_from_jax
from svt_av1_tpu_torch.pipeline import analysis
from svt_av1_tpu_torch.pipeline.encoder import Encoder, encode_ivf
from svt_av1_tpu_torch.utils.clip import make_clip
from tests.torch_threads import one_torch_thread  # noqa: F401


def _jax_cfg(w, h, levels, tbr, lad, preset=5):
    args = SimpleNamespace(width=w, height=h, qp=40, bit_depth=8,
                           intra_period=-1, fps=30, film_grain=0,
                           preset=preset, hierarchical_levels=levels,
                           tbr=tbr, lad=lad, backend="host")
    return jax_preset_config(args)


def _cut_clip():
    """Nine frames with a scene cut after the fifth (the second scene is
    the first one's luma negative)."""
    frames = make_clip(w=128, h=64, frames=9, seed=3)
    return frames[:5] + [(255 - y, u, v) for y, u, v in frames[5:]]


# name: (frames, hierarchical levels, target bits/s, lookahead)
STREAMS = {
    "vbr_low_delay": (lambda: make_clip(w=128, h=64, frames=6, seed=3), 0,
                      200_000, 0),
    "vbr_lookahead_hier3": (lambda: make_clip(w=128, h=64, frames=9,
                                              seed=3), 3, 200_000, 4),
    "vbr_lookahead_cut": (_cut_clip, 2, 300_000, 6),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_vbr_stream_byte_identical(name, monkeypatch):
    make, levels, tbr, lad = STREAMS[name]
    frames = make()
    jcfg = _jax_cfg(128, 64, levels, tbr, lad)
    cuts = []
    orig = analysis.histogram_cut_index

    def spy(hists, *a, **k):
        cuts.append(orig(hists, *a, **k))
        return cuts[-1]

    monkeypatch.setattr(analysis, "histogram_cut_index", spy)
    qindex = []
    from svt_av1_tpu_torch.pipeline import encoder as tenc
    cfg_for = tenc.Encoder._cfg_for

    def cfg_spy(self, *a, **k):
        cfg = cfg_for(self, *a, **k)
        qindex.append(cfg.base_q_idx)
        return cfg

    monkeypatch.setattr(tenc.Encoder, "_cfg_for", cfg_spy)
    want = jax_encode_ivf(frames, jcfg)
    got = encode_ivf(frames, config_from_jax(dataclasses.asdict(jcfg),
                                             device="cpu"))
    assert got == want
    assert len(set(qindex)) > 2               # the controller moved q
    assert (len(cuts) > 0) == (lad > 0)
    if name == "vbr_lookahead_cut":
        assert any(c is not None for c in cuts)


def _packets(enc):
    out = []
    while (pkt := enc.get_packet()) is not None:
        out.append(pkt[0])
    return out


def _run(enc, frames):
    """Send ``frames``, returning every packet they released."""
    out = []
    for f in frames:
        enc.send_picture(*f)
        out += _packets(enc)
    return out


def _finish(enc):
    enc.flush()
    return _packets(enc)


CKPT_JCFG = dict(w=128, h=64, levels=2, tbr=200_000, lad=3)
CKPT_CUT = 6        # 6 of 11 frames: lookahead and pyramid both hold frames


def _ckpt_clip():
    return make_clip(w=128, h=64, frames=11, seed=4)


def test_checkpoint_resume_equals_uninterrupted_stream():
    frames = _ckpt_clip()
    cfg = config_from_jax(dataclasses.asdict(_jax_cfg(**CKPT_JCFG)),
                          device="cpu")
    whole = Encoder(cfg)
    want = _run(whole, frames) + _finish(whole)
    first = Encoder(cfg)
    got = _run(first, frames[:CKPT_CUT])
    state = first.save_state()
    assert state["la"] and state["rc"] is not None
    got += _packets(first)
    first.flush()          # the saved encoder runs on; its state is apart
    resumed = Encoder.load_state(state, device="cpu")
    got += _run(resumed, frames[CKPT_CUT:]) + _finish(resumed)
    assert got == want


def test_state_from_jax_resumes_to_the_jax_bytes():
    """A JAX encoder stopped mid-stream resumes in the port and emits the
    JAX package's remaining bytes."""
    frames = _ckpt_clip()
    jcfg = _jax_cfg(**CKPT_JCFG)
    whole = JaxEncoder(jcfg)
    want = _run(whole, frames) + _finish(whole)
    jenc = JaxEncoder(jcfg)
    got = _run(jenc, frames[:CKPT_CUT])
    state = jenc.save_state()
    got += _packets(jenc)
    resumed = Encoder.load_state(state_from_jax(state, device="cpu"))
    assert resumed.cfg.device == "cpu"
    got += _run(resumed, frames[CKPT_CUT:]) + _finish(resumed)
    assert len(got) == len(want)
    assert got == want



def _resumed(cls, cfg, frames, load):
    """``frames`` through an encoder of ``cls`` stopped at CKPT_CUT and
    resumed from its checkpoint with ``load``. The checkpoint is a deep
    copy, as one written to disk is: the JAX package's holds the rate
    controller's dict by reference (ROADMAP Queue 3)."""
    first = cls(cfg)
    out = _run(first, frames[:CKPT_CUT])
    state = copy.deepcopy(first.save_state())
    out += _packets(first)
    first.flush()
    resumed = load(state)
    return out + _run(resumed, frames[CKPT_CUT:]) + _finish(resumed)


@pytest.mark.parametrize("aq", [1, 2])
def test_aq_checkpoint_resume_equals_the_jax_resumed_stream(aq):
    """A checkpoint holds no AQ history in either package
    (``Encoder.save_state``), so an AQ stream resumed in the port equals
    the JAX package's resumed stream. At 256x128 under a fixed qp the
    missing history moves TUs after the cut in both."""
    frames = make_clip(w=256, h=128, frames=11, seed=4)
    jcfg = dataclasses.replace(_jax_cfg(256, 128, 2, 0, 0),
                               adaptive_quantization=aq)
    want = _resumed(JaxEncoder, jcfg, frames, JaxEncoder.load_state)
    got = _resumed(Encoder,
                   config_from_jax(dataclasses.asdict(jcfg), device="cpu"),
                   frames, lambda st: Encoder.load_state(st, device="cpu"))
    assert len(got) == len(want)
    assert got == want
