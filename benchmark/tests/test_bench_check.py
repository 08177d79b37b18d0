"""The reference's comparison and the metric arithmetic: on the port's own
CPU stream, on streams changed by a byte or a sample, and on synthetic
timelines."""

import math
import time

import numpy as np
import pytest
import torch

from benchmark import devtrace, harness, probe, reference, roofline
from benchmark.tests.conftest import tiny_cell
from benchmark.traffic import Stream


@pytest.fixture(scope="module")
def cpu_stream():
    """Packets [(tu, recon)] and sources of a 10-frame random-access
    stream encoded by the port on the CPU."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    config, traffic = tiny_cell("ra1080p", "longgop", 128, 64)
    cfg = preset_config(**config["encoder"], device="cpu")
    s = Stream(128, 64, 77, **traffic["stream"])
    enc = Encoder(cfg)
    packets, sources = [], {}
    for t in range(10):
        y, u, v = s.frame(t)
        sources[t] = y
        enc.send_picture(y, u, v)
        while (p := enc.get_packet()) is not None:
            packets.append(p)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        packets.append(p)
    return packets, sources


def test_the_port_stream_passes(cpu_stream):
    packets, sources = cpu_stream
    res = reference.check(packets, sources, 1)
    assert res["error"] is None and res["mismatch"] == 0
    assert [f[0] for f in res["frames"]] == list(range(1, 10))
    assert all(25 < f[2] < 60 for f in res["frames"])


def test_a_sample_changed_fails(cpu_stream):
    packets, sources = cpu_stream
    k = max(i for i, p in enumerate(packets) if p[1] is not None)
    recon = [p.copy() for p in packets[k][1]]
    recon[2][3, 5] ^= 1
    bad = packets[:k] + [(packets[k][0], recon)] + packets[k + 1:]
    assert reference.check(bad, sources, 1)["mismatch"] == 1


@pytest.mark.parametrize("which", ["key", "inter"])
def test_a_byte_changed_fails(cpu_stream, which):
    packets, sources = cpu_stream
    big = [i for i, p in enumerate(packets) if len(p[0]) > 16]
    k = big[0] if which == "key" else big[1]
    tu = bytearray(packets[k][0])
    tu[len(tu) // 2] ^= 0x10
    bad = packets[:k] + [(bytes(tu), packets[k][1])] + packets[k + 1:]
    res = reference.check(bad, sources, 1)
    assert res["error"] is not None or res["mismatch"] > 0


def test_a_packet_lost_fails(cpu_stream):
    packets, sources = cpu_stream
    k = max(i for i, p in enumerate(packets) if p[1] is not None)
    bad = packets[:k] + [(b"", packets[k][1])] + packets[k + 1:]
    res = reference.check(bad, sources, 1)
    assert res["mismatch"] == sum(p.size for p in packets[k][1]) \
        or res["error"] is not None


def test_psnr():
    a = np.full((4, 4), 100, np.uint8)
    b = a.copy()
    assert reference.psnr_db(a, b) == reference.PSNR_CAP_DB
    b[0, 0] = 116           # mse 256 / 16 = 16
    assert reference.psnr_db(a, b) == pytest.approx(
        10 * math.log10(255 ** 2 / 16))


def test_fps_counts_to_the_last_packet():
    # three bursts out at 12, 24 and 37 s; a hidden anchor in each
    times = [12, 12, 12, 24, 24, 37, 37]
    shown = [False, True, True, False, True, True, True]
    assert harness.fps(times, shown, 0.0) == (5, 37)
    assert harness.fps([], [], 0.0) == (0, None)


def test_quant_stage_bytes():
    # 4 B in + 8 B out a coefficient, per row 8 B (+8 rate, +8 lambda),
    # the 16 KiB table and the inverse scan; the rate's tables
    assert roofline.quant_stage_bytes(10, 16, False, False) == \
        10 * 16 * 12 + 10 * 8 + 16384 + 64
    assert roofline.quant_stage_bytes(10, 16, True, False) == \
        10 * 16 * 12 + 10 * 16 + 16384 + 64 + 4096 + 68
    assert roofline.quant_stage_bytes(10, 16, True, True) == \
        10 * 16 * 12 + 10 * 24 + 16384 + 64 + 4096 + 68


def _tl():
    # kernels (name, start, end, activity, corr, linked); launch calls
    # by correlation; host operations by correlation
    device = [("quant", 100, 110, "kernel", 1, 11),
              ("gemm", 105, 130, "kernel", 2, 12),
              ("copy", 200, 210, "gpu_memcpy", 3, 13),
              ("quant", 300, 320, "kernel", 4, 14),
              ("other", 400, 450, "kernel", 5, 99)]
    runtime = {1: 50, 2: 60, 3: 150, 4: 250}
    ops = {11: 40, 12: 55, 13: 140, 14: 240, 99: 95}
    return {"device": device, "runtime": runtime, "ops": ops, "host": []}


def test_busy_and_idle():
    tl = _tl()
    # union in [0, 500): 100-130, 200-210, 300-320, 400-450
    assert devtrace.busy_ns(tl, 0, 500) == 30 + 10 + 20 + 50
    assert devtrace.busy_ns(tl, 120, 305) == 10 + 10 + 5
    gaps = devtrace.idle_gaps(tl, 0, 500, [("outer", 0, 500),
                                           ("inner", 130, 200)])
    assert gaps == [["outer", (100 + 90 + 80 + 50) / 1e9],
                    ["inner", 70 / 1e9]]


def test_kernels_launched_within():
    tl = _tl()
    # launches at 50 and 250 fall in the entries; 60 does not; the last
    # kernel has no runtime call and its op starts at 95
    assert devtrace.launched_within(tl, [(45, 55), (245, 260)]) == (30, 2)
    assert devtrace.launched_within(tl, [(90, 100)]) == (50, 1)
    assert devtrace.launched_within(tl, []) == (0, 0)


def test_top_device_ops():
    assert devtrace.top_device_ops(_tl(), 0, 500, n=2) == [
        ["other", 50 / 1e9], ["quant", 30 / 1e9]]


def _run(**kw):
    run = harness.Run()
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_metric_readers():
    spans = [{"stage": "keyframe", "start": 0.0, "dur": 4.0},
             {"stage": "inter_frame", "start": 5.0, "dur": 2.0},
             {"stage": "inter_frame", "start": 8.0, "dur": 1.0},
             {"stage": "dlf", "start": 1.0, "dur": 0.3},
             {"stage": "entropy", "start": 4.5, "dur": 0.5}]
    run = _run(frames=6, window_s=12.0, bytes=6000, psnr=[30.0, 34.0],
               peak_bytes=3 << 29, setup_s=20.0, spans=spans,
               profile={"busy_s": 0.25, "wall_s": 1.0,
                        "quant_bytes": 3.35e6, "quant_device_s": 4e-6})
    r = lambda m: harness.read_metric(m, run)  # noqa: E731
    assert r("fps") == 0.5
    assert r("bytes_per_frame") == 1000
    assert r("psnr_y_db") == 32.0
    assert r("peak_mem_gib") == 1.5
    assert r("setup_s") == 20.0
    assert r("driver_self_s_per_frame") == pytest.approx((12 - 7) / 3)
    assert r("keyframe_s_per_key") == 4.0
    assert r("inter_s_per_frame") == 1.5
    assert r("dlf_s_per_frame") == pytest.approx(0.3)
    assert r("entropy_s_per_frame") == 0.5
    assert r("quant_roofline_pct") == pytest.approx(25.0)
    assert r("device_idle_pct") == pytest.approx(75.0)
    empty = _run(spans=[], profile={})
    for m in ("keyframe_s_per_key", "inter_s_per_frame", "dlf_s_per_frame",
              "entropy_s_per_frame", "quant_roofline_pct",
              "device_idle_pct", "driver_self_s_per_frame", "fps",
              "bytes_per_frame", "psnr_y_db", "peak_mem_gib"):
        assert harness.read_metric(m, empty) is None, m


def test_every_metric_has_a_reader():
    manifest = harness.load_manifest()
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_slices_spread_over_a_long_frame():
    assert probe.slice_starts(None) == ([0.0], float("inf"))
    assert probe.slice_starts(probe.SLICES * probe.SLICE_S) == \
        ([0.0], float("inf"))
    starts, length = probe.slice_starts(10.0)
    assert length == probe.SLICE_S == 1.0 and probe.SLICES == 4
    assert starts == [0.75, 3.25, 5.75, 8.25]


def test_probe_profiles_slices_and_counts_calls_inside(monkeypatch):
    class Session:                 # records nothing; its start takes 0.1 s
        def __init__(self, activities):
            pass

        def start(self):
            time.sleep(0.1)

        def stop(self):
            pass

    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(devtrace, "timeline", lambda prof: {
        "device": [], "runtime": {}, "ops": {}, "host": []})
    monkeypatch.setattr(probe, "SLICES", 2)
    monkeypatch.setattr(probe, "SLICE_S", 0.05)
    p = probe.Probe("key", torch.device("cpu"), frame_s=0.4)
    assert p.starts == pytest.approx([0.075, 0.275])
    calls = []

    def stage(coeff, *a, **k):
        calls.append(time.time_ns())
        return coeff

    quant = p._quant(stage, rate=False)

    def frame(enc):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.6:
            quant(torch.zeros(4, 16, dtype=torch.int32))
            time.sleep(0.005)

    p._frame(frame)(None)          # not armed: nothing is profiled
    assert not p.done and not p.slices
    p.armed = True
    p._frame(frame)(None)
    assert p.done and len(p.slices) == 2
    # slices start on the frame's own clock, which leaves out the pauses
    f0 = p.frame[0]
    (_, lo0, hi0), (_, lo1, hi1) = p.slices
    assert 0.075e9 <= lo0 - f0 - 0.1e9 < 0.125e9
    assert 0.275e9 <= lo1 - f0 - 0.2e9 < 0.325e9
    assert hi0 - lo0 >= 0.05e9 and hi1 - lo1 >= 0.05e9
    assert p.paused >= 0.2e9
    inside = [t for t in calls if any(lo <= t < hi
                                      for _, lo, hi in p.slices)]
    assert len(p.quant) == len(inside) and 0 < len(inside) < len(calls) / 2
    assert p.quant_bytes == len(inside) * roofline.quant_stage_bytes(
        4, 16, False, False)
    out = p.reduce([], time.perf_counter())
    assert out["wall_s"] == pytest.approx(
        sum(hi - lo for _, lo, hi in p.slices) / 1e9)
    assert len(out["slices"]) == 2 and out["frame_s"] >= 0.6
