"""Stage tracing: lightweight span timers over the encode pipeline.

The analogue of the reference's per-process timing hooks:
stages register wall-clock spans into a process-global tracer that the
CLI can dump as JSON (``--trace``) for pipeline balancing, mirroring
what the reference's 15 thread-stage FIFO depths expose.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, List


class Tracer:
    def __init__(self):
        self.enabled = False
        self.spans: List[dict] = []
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        self.spans = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def span(self, stage: str, **meta):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.spans.append({"stage": stage,
                               "start": t0 - self._t0,
                               "dur": t1 - t0, **meta})

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
        """Write the summary, the spans and any ``extra`` entries as
        JSON."""
        with open(path, "w") as f:
            json.dump({"summary": self.summary(), "spans": self.spans,
                       **extra}, f, indent=1)


TRACER = Tracer()


def span(stage: str, **meta):
    return TRACER.span(stage, **meta)
