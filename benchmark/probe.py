"""The traced run's instruments, installed from the benchmark's own files
around calls into the program's layers.

- One frame is profiled with torch.profiler, device activity only
  (recording every host operation as well would slow the host-bound frame
  about fourfold and distort what the trace reads): the first frame of
  the kind the traffic names (a key frame or an inter frame) that the
  encoder computes once the window has closed, so that the profiler's
  cost stays out of the window. A frame that the window's spans say lasts
  no longer than ``SLICES * SLICE_S`` seconds is profiled whole. A longer
  one (a 480p key frame issues some 700,000 device operations in about
  10 s, whose trace takes minutes to read back) is profiled in
  ``SLICES`` slices of ``SLICE_S`` seconds each, centred on equal parts
  of the frame's expected length, so that every part of the frame is
  sampled and the trace stays small. A slice opens and closes at a call
  into the quantization stage, the card synchronised at both ends; each
  slice is a profiler session of its own. The frame's clock for placing
  slices leaves out the time spent starting and stopping sessions (the
  first start initialises the profiler, some seconds), during which the
  frame's work waits.
- While a slice is open, every call into the quantization stage's entries
  (``ops/device_md.quant_stage_j``, ``ops/device.quantize_qv``) records
  its host interval, and the bytes the stage needs are counted from the
  call's shapes.

Host intervals are read with ``time.time_ns()``, the clock on which the
profiler reports its launch calls and device operations. Installing
patches module and class attributes of the program; ``remove`` puts
them back.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from benchmark import devtrace, roofline

# spans the program records on its entropy worker thread; the others are
# the main thread's
WORKER_SPANS = ("entropy",)
SLICES = 4          # profiled slices of a frame longer than SLICES*SLICE_S
SLICE_S = 1.0       # seconds of each


def slice_starts(frame_s):
    """(start offsets in seconds after the frame's start, length of each)
    of the profiled slices of a frame expected to last ``frame_s``
    seconds: the whole frame where it is short or its length unknown."""
    if frame_s is None or frame_s <= SLICES * SLICE_S:
        return [0.0], float("inf")
    part = frame_s / SLICES
    return [max(0.0, (k + 0.5) * part - SLICE_S / 2)
            for k in range(SLICES)], SLICE_S


class Probe:
    def __init__(self, kind: str, device: torch.device, frame_s=None):
        if kind not in ("key", "inter"):
            raise ValueError(f"profile kind must be key or inter: {kind!r}")
        self.kind = kind
        self.device = device
        self.starts, self.length = slice_starts(frame_s)
        self.armed = False     # profile the next frame of the kind
        self.done = False      # a frame was profiled
        self.frame = None      # (start, end) time_ns of the profiled frame
        self.paused = 0        # ns spent starting and stopping sessions
        self.cur = None        # (profile, start time_ns) of the open slice
        self.slices = []       # (profile, start, end) time_ns, closed
        self.anchor = None     # (time_ns, perf_counter_ns) read together
        self.quant = []        # (start, end) time_ns of the stage's calls
        self.quant_bytes = 0
        self._undo = []

    # --- installation -------------------------------------------------------
    def install(self) -> None:
        from svt_av1_tpu_torch.ops import device as dev
        from svt_av1_tpu_torch.ops import device_md
        from svt_av1_tpu_torch.pipeline.encoder import Encoder
        meth = "_encode_key" if self.kind == "key" else "_encode_inter"
        self._patch(Encoder, meth, self._frame(getattr(Encoder, meth)))
        self._patch(device_md, "quant_stage_j",
                    self._quant(device_md.quant_stage_j, rate=True))
        self._patch(dev, "quantize_qv",
                    self._quant(dev.quantize_qv, rate=False))

    def remove(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)
        self.armed = False

    def _patch(self, owner, name, fn) -> None:
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    # --- slices -------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _open(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        act = ProfilerActivity.CUDA if self.device.type == "cuda" \
            else ProfilerActivity.CPU
        self._sync()
        t = time.time_ns()
        prof = profile(activities=[act])
        prof.start()
        self.cur = (prof, time.time_ns())
        self.paused += self.cur[1] - t

    def _close(self) -> None:
        if self.cur is None:
            return
        self._sync()
        prof, lo = self.cur
        hi = time.time_ns()
        prof.stop()
        self.slices.append((prof, lo, hi))
        self.cur = None
        self.paused += time.time_ns() - hi

    def _next_slice_due(self, now: int) -> bool:
        """No slice is open and the frame's own time (its wall less the
        sessions' start and stop) has reached the next slice's start."""
        k = len(self.slices)
        return self.cur is None and k < len(self.starts) \
            and now - self.frame[0] - self.paused >= self.starts[k] * 1e9

    def _frame(self, orig):
        probe = self

        def call(enc, *a, **k):
            if not probe.armed:
                return orig(enc, *a, **k)
            probe.armed = False
            probe._sync()
            probe.anchor = (time.time_ns(), time.perf_counter_ns())
            probe.frame = (probe.anchor[0], None)
            if probe.starts[0] == 0.0:
                probe._open()
            try:
                return orig(enc, *a, **k)
            finally:
                probe._close()
                probe.frame = (probe.frame[0], time.time_ns())
                probe.done = True
        return call

    def _quant(self, orig, rate: bool):
        probe = self

        def call(coeff, *a, **k):
            if probe.frame is None or probe.frame[1] is not None:
                return orig(coeff, *a, **k)
            if probe._next_slice_due(time.time_ns()):
                probe._open()
            if probe.cur is None:
                return orig(coeff, *a, **k)
            trim = rate and (len(a) > 6 and a[6] is not None
                             or k.get("rdoq_lam_qv") is not None)
            rows, n = coeff.shape
            probe.quant_bytes += roofline.quant_stage_bytes(rows, n, rate,
                                                            trim)
            t0 = time.time_ns()
            try:
                return orig(coeff, *a, **k)
            finally:
                t1 = time.time_ns()
                probe.quant.append((t0, t1))
                if t1 - probe.cur[1] >= probe.length * 1e9:
                    probe._close()
        return call

    # --- reduction ----------------------------------------------------------
    def reduce(self, spans, t0: float) -> dict:
        """The profiled slices' numbers, summed over the slices; ``spans``
        are the program's spans recorded while the frame ran, starts in
        seconds after ``t0`` (perf_counter s)."""
        if not self.slices:
            return {}
        # the program's spans on the profiler's clock
        shift = self.anchor[0] - self.anchor[1]
        host = [(s["stage"], int((t0 + s["start"]) * 1e9) + shift,
                 int((t0 + s["start"] + s["dur"]) * 1e9) + shift)
                for s in spans if s["stage"] not in WORKER_SPANS]
        host.append(("frame",) + self.frame)
        wall = busy = quant_ns = quant_kernels = ops = outside = 0
        top, gaps = defaultdict(float), defaultdict(float)
        for prof, lo, hi in self.slices:
            tl = devtrace.timeline(prof)
            wall += hi - lo
            busy += devtrace.busy_ns(tl, lo, hi)
            q_ns, q_k = devtrace.launched_within(tl, self.quant)
            quant_ns += q_ns
            quant_kernels += q_k
            inside = sum(1 for d in tl["device"] if d[2] > lo and d[1] < hi)
            ops += inside
            outside += len(tl["device"]) - inside
            for name, s in devtrace.top_device_ops(tl, lo, hi, n=None):
                top[name] += s
            for name, s in devtrace.idle_gaps(tl, lo, hi, host, n=None):
                gaps[name] += s
        f0 = self.frame[0]
        return {"wall_s": wall / 1e9,
                "busy_s": busy / 1e9,
                "frame_s": (self.frame[1] - f0) / 1e9,
                "paused_s": self.paused / 1e9,
                "slices": [[(lo - f0) / 1e9, (hi - lo) / 1e9]
                           for _, lo, hi in self.slices],
                "device_ops": ops,
                "device_ops_outside": outside,
                "quant_bytes": self.quant_bytes,
                "quant_calls": len(self.quant),
                "quant_device_s": quant_ns / 1e9,
                "quant_kernels": quant_kernels,
                "top_ops": _top(top),
                "idle_gaps": _top(gaps)}


def _top(by: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
