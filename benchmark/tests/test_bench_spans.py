"""The readers of the program's spans inside a frame and of its set-up
record, on synthetic runs: the encoder's entropy waits, the main thread's
synchronisations, the key-frame program's time per class step and the
program's own set-up; each reads nothing from a program whose spans and
module lack what it reads."""

import sys
import types

from benchmark import harness


def _run(spans):
    run = harness.Run()
    run.spans = spans
    return run


def _span(stage, start, dur, thread="MainThread", **meta):
    return {"stage": stage, "start": start, "dur": dur, "thread": thread,
            **meta}


SPANS = [
    _span("keyframe", 0.0, 4.0, syncs=2),
    _span("tile_lanes", 0.1, 0.2, syncs=1),
    _span("tile_program", 0.3, 3.0, syncs=0, lanes=40, class_steps=100),
    _span("tile_inject", 3.3, 0.5, syncs=5),
    _span("entropy_wait", 4.1, 0.3, syncs=0),
    _span("entropy", 4.0, 0.5, thread="entropy_0", syncs=7),
    _span("inter_frame", 5.0, 2.0, syncs=1),
    _span("entropy_wait", 7.1, 0.1, syncs=0),
    _span("recon_fetch", 7.3, 0.05, syncs=1),
]


def test_new_span_readers():
    run = _run(SPANS)
    assert harness.read_metric("entropy_wait_s_per_frame", run) == \
        (0.3 + 0.1) / 2
    # the worker's 7 are left out
    assert harness.read_metric("syncs_per_frame", run) == (2 + 1 + 5 + 1
                                                           + 1) / 2
    assert harness.read_metric("class_step_ms", run) == 1e3 * 3.0 / 100


def test_no_wait_reads_zero_on_a_program_with_threads():
    run = _run([s for s in SPANS if s["stage"] != "entropy_wait"])
    assert harness.read_metric("entropy_wait_s_per_frame", run) == 0.0


def test_a_program_without_the_spans_reads_nothing():
    """Spans of a program without them: no thread, no syncs, no
    tile_program."""
    old = [{"stage": s["stage"], "start": s["start"], "dur": s["dur"]}
           for s in SPANS if s["stage"] in ("keyframe", "inter_frame",
                                            "entropy")]
    for runs in (_run(old), _run([]), _run(None)):
        for m in ("entropy_wait_s_per_frame", "syncs_per_frame",
                  "class_step_ms"):
            assert harness.read_metric(m, runs) is None, m


def test_setup_program_reads_the_program_module(monkeypatch):
    name = "svt_av1_tpu_torch.utils.trace"
    mod = types.ModuleType(name)
    mod.SETUP = [{"stage": "build_native", "dur": 1.5, "built": True},
                 {"stage": "tables", "dur": 0.25, "files": ["a.npz"]}]
    monkeypatch.setitem(sys.modules, name, mod)
    assert harness.read_metric("setup_program_s", _run([])) == 1.75
    del mod.SETUP                       # a program without the record
    assert harness.read_metric("setup_program_s", _run([])) is None
    monkeypatch.delitem(sys.modules, name)
    assert harness.read_metric("setup_program_s", _run([])) is None
