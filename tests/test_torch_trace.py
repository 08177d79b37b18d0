"""The port's tracer (``utils/trace.py``): each span's thread, the
synchronisation counter (torch's sync debug mode, its warnings counted on
the innermost open span and not shown, everything restored when the
tracer is turned off, CUDA never initialised by the tracer), the set-up
record, and the spans a small CPU encode records."""

import threading
import types
import warnings

import pytest
import torch

from svt_av1_tpu_torch.ops import device_tile
from svt_av1_tpu_torch.utils import trace
from svt_av1_tpu_torch.utils.trace import SYNC_TEXT, Tracer

# torch's text for a synchronising call, as its warning handler words it
TORCH_SYNC = SYNC_TEXT + " (Triggered internally at c10/cuda/" \
    "CUDAFunctions.cpp:154.)"


def _sync_warning():
    warnings.warn(TORCH_SYNC, UserWarning)


@pytest.fixture
def fake_cuda(monkeypatch):
    """A process that has initialised CUDA, as far as the tracer can
    tell: ``is_initialized`` true and the sync debug mode in a dict."""
    state = {"mode": 0, "sets": []}
    names = {"default": 0, "warn": 1, "error": 2}

    def set_mode(m):
        state["mode"] = names.get(m, m)
        state["sets"].append(state["mode"])

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: state["mode"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    return state


def test_spans_carry_their_thread_and_nest_per_thread(fake_cuda):
    """Two threads inside nested spans at once: each span names its
    thread, and a thread's synchronisations land on its own innermost
    span, not on the other thread's."""
    tr = Tracer()
    tr.enabled = True
    both_open = threading.Barrier(2, timeout=10)

    def work(tag):
        with tr.span(f"outer_{tag}"):
            with tr.span(f"inner_{tag}"):
                both_open.wait()
                for _ in range(2 if tag == "a" else 5):
                    _sync_warning()
                both_open.wait()

    threads = [threading.Thread(target=work, args=(t,), name=f"worker_{t}")
               for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    tr.enabled = False
    got = {s["stage"]: s for s in tr.spans}
    assert {k: (s["thread"], s["syncs"]) for k, s in got.items()} == {
        "outer_a": ("worker_a", 0), "inner_a": ("worker_a", 2),
        "outer_b": ("worker_b", 0), "inner_b": ("worker_b", 5)}
    for t in "ab":
        outer, inner = got[f"outer_{t}"], got[f"inner_{t}"]
        assert outer["start"] <= inner["start"]
        assert inner["start"] + inner["dur"] <= outer["start"] + outer["dur"]


def test_sync_warnings_are_counted_and_not_shown(fake_cuda):
    """Every synchronisation (repeats at one line included) counts on the
    innermost open span; none is shown, and none outside a span counts;
    other warnings are still shown; turning the tracer off restores the
    debug mode, the filters and ``showwarning``."""
    tr = Tracer()
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        filters, show = list(warnings.filters), warnings.showwarning
        tr.enabled = True
        assert fake_cuda["mode"] == 1
        with tr.span("outer"):
            _sync_warning()
            with tr.span("inner", n=3):
                for _ in range(3):
                    _sync_warning()
            warnings.warn("another warning", UserWarning)
        _sync_warning()
        tr.enabled = False
        assert fake_cuda["sets"] == [1, 0]
        assert warnings.filters == filters
        assert warnings.showwarning is show
        _sync_warning()
    got = {s["stage"]: s for s in tr.spans}
    assert got["inner"]["syncs"] == 3 and got["inner"]["n"] == 3
    assert got["outer"]["syncs"] == 1
    assert [str(w.message) for w in shown] == ["another warning",
                                              TORCH_SYNC]


def test_the_counter_starts_once_cuda_is_initialised(fake_cuda,
                                                     monkeypatch):
    """Enabled before CUDA is initialised, the tracer starts counting at
    the first span after it is; a span recorded before counts nothing."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    tr = Tracer()
    tr.enabled = True
    with tr.span("before"):
        pass
    assert fake_cuda["sets"] == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with tr.span("after"):
        _sync_warning()
    tr.enabled = False
    assert "syncs" not in tr.spans[0] and tr.spans[1]["syncs"] == 1
    assert fake_cuda["sets"] == [1, 0]


def test_no_card_no_counter_and_no_cuda_initialisation(monkeypatch):
    """Without a card the tracer installs nothing, counts nothing and
    never initialises CUDA."""
    def refuse(*a):
        raise AssertionError("the sync debug mode was touched")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    assert not torch.cuda.is_initialized()
    filters, show = list(warnings.filters), warnings.showwarning
    tr = Tracer()
    tr.enabled = True
    with tr.span("a"):
        assert warnings.filters == filters
        assert warnings.showwarning is show
    tr.enabled = False
    assert not torch.cuda.is_initialized()
    assert "syncs" not in tr.spans[0]
    assert set(tr.clock) == {"time_ns", "perf_counter_ns"}


def test_setup_steps_sum_per_stage_and_leave_nested_time_out(monkeypatch):
    monkeypatch.setattr(trace, "SETUP", [])
    clock = iter([0.0, 1.0, 3.0, 10.0, 20.0, 20.5])
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock)))
    with trace.setup_step("outer"):                # 0 .. 10
        with trace.setup_step("build_native") as rec:  # 1 .. 3
            rec["built"] = False
    with trace.setup_step("build_native") as rec:  # 20 .. 20.5
        rec["built"] = True
    assert trace.SETUP == [
        {"stage": "build_native", "built": True, "dur": 2.5},
        {"stage": "outer", "dur": 8.0}]


def test_a_small_cpu_encode_records_the_new_spans(monkeypatch):
    """Low-delay 64x64, a key frame and two inter frames on the CPU: the
    encoder's entropy waits, scene-change detection and recon download,
    the key-frame program's three phases (``tile_program`` with the
    program's own class-step count and its graph counts), the set-up
    record, and the old
    spans under their names; only ``entropy`` runs on the worker."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    from svt_av1_tpu_torch.utils.clip import make_clip
    steps = []
    real = device_tile._run_program

    def spy(enc, *a):
        out = real(enc, *a)
        steps.append(enc.fused_stats["class_steps"])
        return out

    monkeypatch.setattr(device_tile, "_run_program", spy)
    cfg = preset_config(width=64, height=64, qp=40, preset=5,
                        intra_period=-1, hierarchical_levels=0,
                        device="cpu")
    assert cfg.scene_change_detection
    tr = trace.TRACER
    tr.enabled = True
    tr.reset()
    try:
        enc = Encoder(cfg)
        for y, u, v in make_clip(64, 64, frames=3):
            enc.send_picture(y, u, v)
            while enc.get_packet() is not None:
                pass
        enc.flush()
        while enc.get_packet() is not None:
            pass
    finally:
        tr.enabled = False
    stages = {s["stage"] for s in tr.spans}
    assert {"keyframe", "inter_frame", "dlf", "entropy", "entropy_wait",
            "scd", "recon_fetch", "tile_lanes", "tile_program",
            "tile_inject"} <= stages
    main = threading.current_thread().name
    assert {s["stage"] for s in tr.spans
            if s["thread"] != main} == {"entropy"}
    assert [s["class_steps"] for s in tr.spans
            if s["stage"] == "tile_program"] == steps
    assert steps and all(steps)
    # the class-step graphs' counts: none on the CPU, where steps are eager
    assert [(s["graph_replays"], s["graph_captures"], s["pad_lanes"])
            for s in tr.spans if s["stage"] == "tile_program"] == \
        [(0, 0, 0)] * len(steps)
    assert {"encoder_init", "tables"} <= {e["stage"] for e in trace.SETUP}
    assert all(e["dur"] >= 0 for e in trace.SETUP)
