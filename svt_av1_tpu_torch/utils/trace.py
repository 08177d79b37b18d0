"""Stage tracing: host-clock spans over the encode pipeline, their
threads and host-device synchronisations, and the process's set-up.

- ``TRACER.span(stage, **meta)`` records a span while ``TRACER.enabled``:
  its stage, ``start`` (perf-counter seconds since ``reset()``), ``dur``,
  the ``thread`` it ran on and any ``meta``. The CLI dumps the spans as
  JSON (``--trace``) with the clock anchor of the last ``reset()``
  (``time.time_ns()`` and ``time.perf_counter_ns()`` read together, the
  first being torch.profiler's clock), so the dump lays over a profiler
  trace.
- While the tracer is enabled in a process that has initialised CUDA,
  torch's sync debug mode warns on every synchronising CUDA call; each
  such warning is counted on the innermost open span of the calling
  thread (its ``syncs``) and is not shown. Calls outside any span are not
  counted. Turning the tracer off restores the debug mode, the warning
  filters and ``warnings.showwarning`` as they were. The tracer never
  initialises CUDA itself.
- ``SETUP`` records once-per-process set-up steps (``setup_step``:
  native builds, kernel builds, table loads, ``Encoder.__init__``)
  whether the tracer is enabled or not; ``reset()`` leaves it.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
import warnings
from collections import defaultdict
from typing import Dict, List

# the text of torch's warning for a synchronising CUDA call
SYNC_TEXT = "called a synchronizing CUDA operation"
# the keys of every span (``syncs`` while the counter is on); others are meta
SPAN_KEYS = frozenset(("stage", "start", "dur", "thread", "syncs"))


def _cuda_initialised() -> bool:
    """True where this process has initialised CUDA; never initialises
    it, and never imports torch."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


class Tracer:
    def __init__(self):
        self._enabled = False
        self._local = threading.local()   # per thread: the open spans
        self._lock = threading.Lock()
        self._sync = None    # while counting: the debug mode, filters and
        #                      showwarning as they were, and the hook
        self.reset()

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, on) -> None:
        self._enabled = bool(on)
        if self._enabled:
            self._count_syncs()
        else:
            self._stop_counting()

    def reset(self) -> None:
        self.spans: List[dict] = []
        self.clock = {"time_ns": time.time_ns(),
                      "perf_counter_ns": time.perf_counter_ns()}
        self._t0 = self.clock["perf_counter_ns"] / 1e9

    # --- the synchronisation counter ------------------------------------------
    def _count_syncs(self) -> None:
        """Start counting if CUDA is initialised and counting is off."""
        if self._sync is not None or not _cuda_initialised():
            return
        import torch
        with self._lock:
            if self._sync is not None:
                return
            show = warnings.showwarning

            def hook(message, category, filename, lineno, file=None,
                     line=None):
                if SYNC_TEXT not in str(message):
                    show(message, category, filename, lineno, file, line)
                    return
                stack = getattr(self._local, "stack", None)
                if stack:
                    stack[-1]["syncs"] = stack[-1].get("syncs", 0) + 1

            self._sync = (torch.cuda.get_sync_debug_mode(),
                          list(warnings.filters), show, hook)
            warnings.filterwarnings("always", message=".*" + SYNC_TEXT)
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")

    def _stop_counting(self) -> None:
        with self._lock:
            if self._sync is None:
                return
            import torch
            mode, filters, show, hook = self._sync
            self._sync = None
            torch.cuda.set_sync_debug_mode(mode)
            warnings.filters[:] = filters
            warnings._filters_mutated()
            if warnings.showwarning is hook:
                warnings.showwarning = show

    # --- spans ----------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, stage: str, **meta):
        """Time the body as a span; yields its record (None while the
        tracer is off) so the body can add meta it learns."""
        if not self._enabled:
            yield None
            return
        if self._sync is None:
            self._count_syncs()
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        t0 = time.perf_counter()
        rec = {"stage": stage, "start": t0 - self._t0, "dur": 0.0,
               "thread": threading.current_thread().name, **meta}
        if self._sync is not None:
            rec["syncs"] = 0
        stack.append(rec)
        try:
            yield rec
        finally:
            rec["dur"] = time.perf_counter() - t0
            stack.pop()
            self.spans.append(rec)

    def summary(self) -> Dict[str, dict]:
        agg = defaultdict(lambda: {"count": 0, "total": 0.0})
        for s in self.spans:
            a = agg[s["stage"]]
            a["count"] += 1
            a["total"] += s["dur"]
        return {k: {"count": v["count"], "total_s": round(v["total"], 4),
                    "mean_ms": round(1e3 * v["total"] / v["count"], 3)}
                for k, v in sorted(agg.items())}

    def dump(self, path: str, **extra) -> None:
        """Write the summary, the clock anchor, the spans, the set-up
        record and any ``extra`` entries as JSON."""
        with open(path, "w") as f:
            json.dump({"summary": self.summary(), "clock": self.clock,
                       "spans": self.spans, "setup": SETUP, **extra},
                      f, indent=1)


TRACER = Tracer()


def span(stage: str, **meta):
    return TRACER.span(stage, **meta)


# --- set-up -------------------------------------------------------------------
SETUP: List[dict] = []
_SETUP_LOCK = threading.Lock()
_SETUP_OPEN = threading.local()


@contextlib.contextmanager
def setup_step(stage: str, **meta):
    """Time a once-per-process set-up step into ``SETUP``; yields a dict
    for meta the body learns. ``dur`` is the step's own time: a step
    nested in another is left out of the outer one's. A stage recorded
    again adds its time to its entry (and ``built`` if it built)."""
    rec = {"stage": stage, **meta}
    stack = getattr(_SETUP_OPEN, "stack", None)
    if stack is None:
        stack = _SETUP_OPEN.stack = []
    inner = [0.0]
    stack.append(inner)
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        dur = time.perf_counter() - t0
        stack.pop()
        if stack:
            stack[-1][0] += dur
        rec["dur"] = dur - inner[0]
        with _SETUP_LOCK:
            _record_setup(rec)


def _record_setup(rec: dict) -> None:
    for e in SETUP:
        if e["stage"] == rec["stage"]:
            e["dur"] += rec["dur"]
            if rec.get("built"):
                e["built"] = True
            return
    SETUP.append(rec)
