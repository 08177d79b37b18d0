"""The benchmark's video source against the program's clip and the
program's scene-change detector."""

import numpy as np
import pytest

from benchmark.tests.conftest import load
from benchmark.traffic import Stream
from svt_av1_tpu_torch.pipeline.scd import SceneChangeDetector
from svt_av1_tpu_torch.utils.clip import make_clip


# a cut every 24 frames from frame 9: the stream of a cell that puts the
# key-frame program on the main path beside the inter path
CUTS = {"cut_every": 24, "first_cut": 9, "pan_px": [3, 2],
        "noise_sigma": 6.0, "shot_luma_step": 60.0}


def _traffic(name):
    return load("ra1080p", name)[1]


def test_first_frames_equal_make_clip():
    ref = make_clip(1920, 1080, 9, seed=3)
    s = Stream(1920, 1080, 3, **_traffic("longgop")["stream"])
    for t, planes in enumerate(ref):
        for a, b in zip(planes, s.frame(t)):
            assert a.dtype == b.dtype and np.array_equal(a, b), t


def test_two_hundred_frames_one_shape():
    s = Stream(848, 480, 2**31 + 5, **CUTS)
    shapes = {tuple(p.shape for p in s.frame(t)) for t in range(200)}
    assert shapes == {((480, 848), (240, 424), (240, 424))}


@pytest.mark.parametrize("workload", ["ra1080p.cuts", "ra1080p.longgop",
                                      "ai480.intra"])
def test_scene_change_fires_at_cuts_only(workload):
    config, traffic = load(*workload.split(".")) \
        if workload != "ra1080p.cuts" else (load("ra1080p", "longgop")[0],
                                            {"stream": CUTS})
    enc = config["encoder"]
    s = Stream(enc["width"], enc["height"], 987654321, **traffic["stream"])
    det = SceneChangeDetector()
    fired = [t for t in range(200) if det.is_scene_change(s.frame(t)[0])]
    cuts = [t for t in range(200) if s.is_cut(t)]
    assert fired == cuts
    if workload == "ra1080p.cuts":
        assert cuts == list(range(9, 200, 24))
    else:
        assert cuts == []


def test_one_seed_one_stream():
    kw = CUTS
    a, b = Stream(320, 192, 2**33 + 1, **kw), Stream(320, 192, 2**33 + 1,
                                                       **kw)
    c = Stream(320, 192, 2**33 + 2, **kw)
    for t in (0, 8, 9, 40, 33, 120):
        for x, y in zip(a.frame(t), b.frame(t)):
            assert np.array_equal(x, y)
    assert not np.array_equal(a.frame(40)[0], c.frame(40)[0])


def test_pan_wraps_without_changing_shot():
    s = Stream(64, 48, 1)
    # 3 px a frame over a 64 + 64 px base: frame 50 wraps
    y50 = s.frame(50)[0]
    base = np.clip(s._base(0), 0, 255)
    cols = (150 + np.arange(64)) % 128
    rows = (100 + np.arange(48)) % 112
    assert np.array_equal(y50, base[np.ix_(rows, cols)])
    assert s.shot_of(50) == 0 and not s.is_cut(50)
