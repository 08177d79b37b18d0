"""The key-frame class step replayed as CUDA graphs.

A fused key-frame program (``ops/device_tile.py``) runs one class step
per (wave, shape class): some 600 small plain-PyTorch operations whose
host dispatch, not the card, sets the step's time. On a CUDA device the
runner here captures each step once and replays it:

- **Keys.** A capture serves one (step configuration, lane bucket, plane
  buffers) key. The bucket is the next power of two of the step's real
  lanes (``lane_bucket``); the lanes come packed [rows, lanes] and
  already padded to it by duplicates of the wave's last lane, which
  read and write exactly what that lane does, so the recon is unchanged
  and the pad lanes' outputs are cut off before anything reads them.
- **Fixed addresses.** The graphs read the recon and source planes and
  the lane buffer at the addresses they had at capture, so those are the
  runner's own buffers: ``recon`` (zeroed at each frame's start),
  ``source`` (copied in once a frame) and one lane buffer per key (one
  copy before each replay). Everything a step allocates inside a capture
  lives in one memory pool that the runner's graphs share: the steps run
  one after another, and a step's replay reads nothing of the pool that
  another key's replay wrote, except its own outputs, which the caller
  copies out before the next step.
- **The quantization stage stays a host call.** The full loop's calls of
  ``device_md.quant_stage_j`` launch the hand-written kernel
  (``csrc/quant.cu``) through its wrapper at every replay: a capture ends
  its graph at each call (``capturing().cut``), so a step is graph, call,
  graph, ..., the calls' operands and outputs at the addresses they had
  at capture.
- **Capture.** The first meeting of a key runs the step eagerly on the
  real lanes (its writes are the ones a replay would make; it fills the
  constant caches, so no upload is left inside the step), then captures
  it on a side stream with ``capture_error_mode="thread_local"`` (the
  entropy worker thread uses the card meanwhile) and with Python's
  garbage collector off (a collection could destroy another encoder's
  graphs on this thread, which a capture forbids). Besides their pool and
  the runner's buffers, the graphs read only the step's device constants,
  which caches with no bound hold for the life of the process
  (``device._stage_consts``, ``device_md.make_decide_core``, ...), so
  nothing they read is freed under them.

On any other device ``ClassGraphs.step`` runs the step eagerly on the real
lanes, and ``recon``/``source`` return new tensors, as without the runner.
"""

from __future__ import annotations

import gc
import threading

import numpy as np
import torch

_LOCAL = threading.local()


def lane_bucket(n: int) -> int:
    """The lanes a class step of ``n`` real lanes runs on the card: the
    next power of two (1 for 1)."""
    return 1 << max(n - 1, 0).bit_length()


def capturing():
    """The capture under way on this thread (its ``cut`` ends the open
    graph at a host call), or None."""
    return getattr(_LOCAL, "capture", None)


class _Capture:
    """One step's capture: its graphs, and between each two the host call
    that a replay makes (the call, its arguments, its output tensors)."""

    def __init__(self, pool):
        self.pool = pool
        self.graphs, self.calls = [], []
        self.open = None

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.open = g

    def end(self) -> None:
        g, self.open = self.open, None
        g.capture_end()
        self.graphs.append(g)

    def cut(self, call, args, out):
        """End the open graph at a host call ``call(*args, out=out)``,
        which each replay makes here; ``out``, the call's output tensors
        (allocated inside the capture), stands in for its result."""
        self.end()
        self.calls.append((call, args, out))
        self.begin()
        return out


class _Graphed:
    """A captured step: its lane buffer, graphs, host calls and outputs."""

    def __init__(self, lanes, capture, out):
        self.lanes = lanes
        self.seq = list(zip(capture.graphs, capture.calls + [None]))
        self.out = out

    def replay(self):
        for g, call in self.seq:
            g.replay()
            if call is not None:
                fn, args, out = call
                fn(*args, out=out)
        return self.out


class ClassGraphs:
    """The class-step runner of one encoder: its graphs, buffers and
    counts (``graph_replays``, ``graph_captures``, ``pad_lanes``: the pad
    lanes the replays ran)."""

    def __init__(self):
        self._graphs = {}
        self._planes = {}
        self._pool = None
        self._stream = None
        self.graph_replays = self.graph_captures = self.pad_lanes = 0

    def counts(self) -> dict:
        return dict(graph_replays=self.graph_replays,
                    graph_captures=self.graph_captures,
                    pad_lanes=self.pad_lanes)

    def _buffers(self, key, make):
        bufs = self._planes.get(key)
        if bufs is None:
            bufs = self._planes[key] = make()
        return bufs

    def recon(self, shapes, device) -> list:
        """int32 recon planes of ``shapes``, zeroed."""
        device = torch.device(device)
        if device.type != "cuda":
            return [torch.zeros(s, dtype=torch.int32, device=device)
                    for s in shapes]
        bufs = self._buffers(("recon", tuple(map(tuple, shapes)), device),
                             lambda: [torch.empty(s, dtype=torch.int32,
                                                  device=device)
                                      for s in shapes])
        for b in bufs:
            b.zero_()
        return bufs

    def source(self, planes, dtype, device) -> list:
        """The ``planes`` (numpy arrays or tensors) on ``device`` in
        ``dtype``."""
        device = torch.device(device)
        host = [p if isinstance(p, torch.Tensor)
                else torch.as_tensor(np.ascontiguousarray(p)) for p in planes]
        if device.type != "cuda":
            return [h.to(device).to(dtype) for h in host]
        bufs = self._buffers(
            ("source", tuple(tuple(h.shape) for h in host), dtype, device),
            lambda: [torch.empty(h.shape, dtype=dtype, device=device)
                     for h in host])
        for b, h in zip(bufs, host):
            b.copy_(h.to(device))
        return bufs

    def step(self, stage, key, recon, src, lanes, off: int, n: int):
        """``stage(recon, src, lanes[:, off:off + n])``'s outputs, which
        hold the real lanes' results first (a replay's hold its pad
        lanes' after them). On the card the lanes from ``off`` to
        ``off + lane_bucket(n)`` must be the real ones and then their pad,
        and the outputs are valid until the next step."""
        if lanes.device.type != "cuda":
            return stage(recon, src, lanes[:, off:off + n])
        nb = lane_bucket(n)
        key = (key, nb, tuple(p.data_ptr() for p in (*recon, *src)))
        ent = self._graphs.get(key)
        if ent is None:
            out = stage(recon, src, lanes[:, off:off + n])
            self._graphs[key] = self._capture(stage, recon, src,
                                              lanes[:, off:off + nb])
            self.graph_captures += 1
            return out
        ent.lanes.copy_(lanes[:, off:off + nb])
        self.graph_replays += 1
        self.pad_lanes += nb - n
        return ent.replay()

    def _capture(self, stage, recon, src, lanes) -> _Graphed:
        device = lanes.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
        buf = lanes.clone()
        cap = _Capture(self._pool)
        main = torch.cuda.current_stream(device)
        self._stream.wait_stream(main)
        # no garbage collection inside a capture: it could free another
        # encoder's graphs on this thread, which a capture forbids
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                cap.begin()
                _LOCAL.capture = cap
                done = False
                try:
                    out = stage(recon, src, buf)
                    done = True
                finally:
                    _LOCAL.capture = None
                    try:
                        cap.end()
                    except RuntimeError:
                        if done:    # else the step's own error propagates
                            raise
        finally:
            if gc_was_on:
                gc.enable()
        main.wait_stream(self._stream)
        return _Graphed(buf, cap, out)
