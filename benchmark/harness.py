"""One run of one cell of ``BENCHMARK.json``, in one process.

A cell names a configuration (``benchmark/configs/<name>.json``: the
encoder's options, optionally ``encoder_fields`` that no preset sets,
the limits of the check) and a traffic mix
(``benchmark/traffic/<name>.json``: the stream's parameters). A metric is
a reader of its own (``benchmark/metrics/<name>.py``, ``read(run)``)
that returns nothing where it finds nothing to read. So a later change
adds a cell or a metric by adding files and entries.

The run drives ``svt_av1_tpu_torch.pipeline.encoder.Encoder`` the way
``encode_ivf`` does: ``send_picture``, then ``get_packet`` until it
returns None. Set-up (imports, the first use's builds, the stream's first
frames) ends with the card synchronised; then the window:

- frames are sent until ``--seconds`` have passed, checked before each
  frame;
- after every drain that gave packets the card is synchronised and the
  clock read; the window's time is that of its last packet, and frames
  still buffered in the encoder at the close are not counted;
- after the window ``Encoder.flush()`` stops the entropy worker, the
  program's state is freed, and the reference decodes every packet up to
  the window's last.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"


class RunError(RuntimeError):
    """A run that cannot give a result."""


# --- the manifest -----------------------------------------------------------
def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, manifest: dict, root: Path = ROOT):
    """(workload entry, configuration file, traffic file) of cell ``name``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def encoder_config(config: dict, device: str):
    """The ``EncoderConfig`` a configuration file states: its ``encoder``
    options (the CLI's names) through ``preset_config``, then its
    optional ``encoder_fields``, fields of ``EncoderConfig`` by name
    (lists as tuples), set with ``dataclasses.replace``. A name that is
    no field, or ``device``, which is the harness's, stops the run."""
    from svt_av1_tpu_torch.app.cli import preset_config
    cfg = preset_config(**config["encoder"], device=device)
    fields = config.get("encoder_fields", {})
    names = {f.name for f in dataclasses.fields(cfg)} - {"device"}
    unknown = sorted(set(fields) - names)
    if unknown:
        raise RunError(f"encoder_fields names no field of EncoderConfig "
                       f"that a configuration may set: {unknown}")
    return dataclasses.replace(cfg, **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in fields.items()})


def metrics_of(cell: str, manifest: dict, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, run):
    """``read(run)`` of ``benchmark/metrics/<name>.py``; None where it
    finds nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


# --- the run ------------------------------------------------------------------
class Run:
    """What one run recorded; the metric readers read its attributes."""

    def __init__(self):
        self.setup_s = None        # process start to window start
        self.window_s = None       # window start to its last packet
        self.bursts = []           # times after window start packets came
        self.setup_marks = []      # set-up: each frame sent and drained,
        #                            seconds after process start
        self.frames = 0            # shown frames out in the window
        self.bytes = 0             # packet bytes out in the window
        self.psnr = []             # luma PSNR of each, reference decode
        self.peak_bytes = None     # torch.cuda.max_memory_allocated()
        self.spans = None          # program spans in the window (traced)
        self.profile = {}          # probe.Probe.reduce() (traced)

    def spans_named(self, *names) -> list:
        return [s for s in self.spans or () if s["stage"] in names]


def fps(times, shown, t0: float):
    """(shown frames, seconds) of a window from ``t0``: every frame whose
    packet is out, over the time to the last packet out."""
    n = sum(1 for s in shown if s)
    if not times:
        return 0, None
    return n, max(times) - t0


def run_cell(config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None):
    """Run one cell; returns (Run, checks, state): ``checks`` holds each
    number compared with its limit, ``state`` the frames judged and
    failed."""
    import torch

    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    from svt_av1_tpu_torch.utils import trace as program_trace

    from benchmark import reference
    from benchmark.probe import Probe
    from benchmark.traffic import Stream

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg = encoder_config(config, device)
    stream = Stream(cfg.width, cfg.height, seed, bit_depth=cfg.bit_depth,
                    **traffic["stream"])
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)

    enc = Encoder(cfg)
    packets = []            # [tu, recon, time, phase]
    sources = {}            # display index -> source luma
    sent = 0

    def send():
        nonlocal sent
        y, u, v = stream.frame(sent)
        sources[sent] = y
        enc.send_picture(y, u, v)
        sent += 1

    def drain(phase: str) -> None:
        got = []
        while (pkt := enc.get_packet()) is not None:
            got.append([pkt[0], pkt[1], None, phase])
        if got:
            sync()
            now = time.perf_counter()
            for p in got:
                p[2] = now
            packets.extend(got)

    tracer = program_trace.TRACER
    try:
        marks = []
        for _ in range(traffic["setup_frames"]):
            send()
            drain("setup")
            sync()
            marks.append(time.perf_counter() - t_start)
        sync()
        tracer.enabled = trace
        tracer.reset()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            send()
            drain("window")
    finally:
        tracer.enabled = False
    win = [p for p in packets if p[3] == "window"]
    if not win:
        raise RunError("the window emitted no packet")
    run = Run()
    run.setup_s = t0 - t_start
    run.frames, run.window_s = fps([p[2] for p in win],
                                   [p[1] is not None for p in win], t0)
    run.bytes = sum(len(p[0]) for p in win)
    run.bursts = sorted({p[2] - t0 for p in win})
    run.setup_marks = marks
    run.peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else None
    if trace:
        run.spans = list(tracer.spans)
        kind = traffic["profile"]
        frames = run.spans_named("keyframe" if kind == "key"
                                 else "inter_frame")
        frame_s = sum(s["dur"] for s in frames) / len(frames) \
            if frames else None
        run.profile = _profile_one_frame(
            Probe(kind, dev, frame_s), tracer, enc, send, drain)
    # the window is over: stop the entropy worker, free the program
    enc.flush()
    drain("flush")
    shown_total = sum(1 for p in packets if p[1] is not None)
    last = max(i for i, p in enumerate(packets) if p[3] == "window")
    judged = [(p[0], p[1]) for p in packets[:last + 1]]
    setup_shown = sum(1 for p in packets if p[3] == "setup"
                      and p[1] is not None)
    del enc, win, packets
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    res = reference.check(judged, sources, setup_shown, cfg.bit_depth)
    t_ref = time.perf_counter() - t_ref
    run.psnr = [f[2] for f in res["frames"] if f[2] is not None]
    limits = config["limits"]
    min_psnr = min(run.psnr) if run.psnr else 0.0
    lost = abs(sent - shown_total)
    checks = {
        "mismatch_samples": {"value": res["mismatch"],
                             "limit": limits["mismatch_samples"]},
        "frames_lost": {"value": lost, "limit": limits["frames_lost"]},
        "min_psnr_y_db": {"value": min_psnr,
                          "limit": limits["min_psnr_y_db"]},
    }
    bad = sum(1 for _, diff, p in res["frames"]
              if diff or p is None or p < limits["min_psnr_y_db"])
    state = {"attempted": len(res["frames"]) + lost,
             "failed": bad + lost,
             "decode_error": res["error"],
             "frames_sent": sent, "packets_judged": len(judged),
             "reference_s": t_ref}
    return run, checks, state


def _profile_one_frame(probe, tracer, enc, send, drain, most=64) -> dict:
    """Profile the first frame of the probe's kind that the encoder
    computes after the window: the frames the mini-GOP still buffers,
    else one more frame at a time."""
    probe.install()
    probe.armed = True
    tracer.reset()
    tracer.enabled = True
    t0 = time.perf_counter()
    try:
        enc.flush()
        drain("profile")
        for _ in range(most):
            if probe.done:
                break
            send()
            enc.flush()
            drain("profile")
        else:
            raise RunError(f"no {probe.kind} frame in {most} frames")
    finally:
        tracer.enabled = False
        probe.remove()
    return probe.reduce(list(tracer.spans), t0)


def passes(checks: dict) -> bool:
    """Counts (mismatch, frames lost) may not exceed their limits; a PSNR
    may not fall below its limit."""
    ok = True
    for name, c in checks.items():
        if name.startswith("min_"):
            ok &= c["value"] >= c["limit"]
        else:
            ok &= c["value"] <= c["limit"]
    return ok
