"""The benchmark's video source at the stated bit depth: 8-bit frames as
they were before the stream took a depth, and 10-bit frames that carry
content in their two low bits, on which the program's scene-change
detector still fires at every cut and nowhere else."""

import hashlib

import numpy as np
import pytest

from benchmark.traffic import Stream
from svt_av1_tpu_torch.pipeline.scd import SceneChangeDetector

ONE_SHOT = {"cut_every": 0, "first_cut": 0, "pan_px": [3, 2],
            "noise_sigma": 6.0, "shot_luma_step": 60.0}
# shots start at frames 3, 8 and 13: both luma means in 14 frames
CUTS = dict(ONE_SHOT, cut_every=5, first_cut=3)
# a cut every 24 frames from frame 9, as in test_bench_traffic
CUTS_24 = dict(ONE_SHOT, cut_every=24, first_cut=9)

# sha256 over the planes of frames 0-13 at 128x64 (and of frame 0 at
# 1920x1080), taken from the stream before it had a bit depth
DIGESTS_128x64 = {
    (7, "one_shot"):
        "7f8edee82a4e42fee53baeac94088234fd173da12bf231adfc364123c17f2eff",
    (7, "cuts"):
        "4546a9c1e415b90d7a7de6edc67ce9bf49ae9f60507565e89d6f49e3eeaa9085",
    (2**31 + 5, "one_shot"):
        "37e593a52e5ad0243e5c422145326985d9256035f4533319e5e31a823bf71b99",
    (2**31 + 5, "cuts"):
        "8ad0f9a9f4429d5c2690e958b78f5d527cc4360ba1c177a59dfd273d361eb5ca",
    (2**33 + 1, "one_shot"):
        "7f02459af97997f42b0c6b14554663be35e0137d58bfdbeb488d3442ec9a4341",
    (2**33 + 1, "cuts"):
        "e311a9bc8de9d22d6e2cfd43c68ea6f4f3aef277b507b897176958a792852826",
}
DIGESTS_1080P = {
    (3, "one_shot"):
        "faf502e0ea65d62e5e185de4f068a4ba11f2cf2b491806c09502abf665812881",
    (2**31 + 5, "cuts"):
        "028753ef1b4befa0f71091921b1429517b900f70f5abbac09d2cbebc2132e4a1",
}
MIXES = {"one_shot": ONE_SHOT, "cuts": CUTS}


def _digest(stream, frames) -> str:
    h = hashlib.sha256()
    for t in frames:
        for p in stream.frame(t):
            assert p.dtype == np.uint8
            h.update(p.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed,mix", sorted(DIGESTS_128x64))
def test_8bit_frames_as_before(seed, mix):
    s = Stream(128, 64, seed, **MIXES[mix])
    assert _digest(s, range(14)) == DIGESTS_128x64[(seed, mix)]
    # the default depth is 8
    assert _digest(Stream(128, 64, seed, bit_depth=8, **MIXES[mix]),
                   range(14)) == DIGESTS_128x64[(seed, mix)]


@pytest.mark.parametrize("seed,mix", sorted(DIGESTS_1080P))
def test_8bit_first_1080p_frame_as_before(seed, mix):
    s = Stream(1920, 1080, seed, **MIXES[mix])
    assert _digest(s, [0]) == DIGESTS_1080P[(seed, mix)]


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_10bit_frames_carry_low_bits(mix):
    s10 = Stream(128, 64, 2**31 + 5, bit_depth=10, **MIXES[mix])
    s8 = Stream(128, 64, 2**31 + 5, **MIXES[mix])
    for t in range(14):
        for a, b in zip(s10.frame(t), s8.frame(t)):
            assert a.dtype == np.uint16 and a.shape == b.shape
            assert int(a.max()) <= 1023
            # the field scaled before the cast: the top 8 bits are the
            # 8-bit sample, the two low bits carry content
            assert np.array_equal(a >> 2, b)
        y, u, v = s10.frame(t)
        assert len(np.unique(y & 3)) == 4
        assert np.any(u & 3) and np.any(v & 3)


def test_depth_is_8_or_10():
    with pytest.raises(ValueError):
        Stream(64, 64, 1, bit_depth=12)


@pytest.mark.parametrize("size,mix", [((1920, 1080), "cuts_24"),
                                      ((1920, 1080), "one_shot"),
                                      ((848, 480), "cuts_24")])
def test_10bit_scene_change_fires_at_cuts_only(size, mix):
    kw = CUTS_24 if mix == "cuts_24" else ONE_SHOT
    s = Stream(*size, 987654321, bit_depth=10, **kw)
    det = SceneChangeDetector()
    fired = [t for t in range(200) if det.is_scene_change(s.frame(t)[0])]
    cuts = [t for t in range(200) if s.is_cut(t)]
    assert fired == cuts
    assert cuts == (list(range(9, 200, 24)) if mix == "cuts_24" else [])
