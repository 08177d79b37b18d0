"""Reduction of a torch.profiler trace to the numbers the per-layer
metrics read.

``timeline`` turns the profiler's events into plain tuples; every other
function works on those tuples alone, so the arithmetic is tested on
synthetic timelines without a card. Times are nanoseconds on the
profiler's clock.
"""

from __future__ import annotations

from collections import defaultdict


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ...), as the profiler names them."""
    for prefix in ("cuda", "cu"):
        if name.startswith(prefix) and name[len(prefix):][:1].isupper():
            return True
    return False


def timeline(prof) -> dict:
    """{"device": [(name, start, end, kind, corr, linked)],
    "runtime": {corr: start}, "ops": {corr: start},
    "host": [(name, start, end, thread)]} from a stopped
    ``torch.profiler.profile``: the device's operations (``kind``
    "kernel", "memcpy" or "memset"), the launch calls and the host
    operations (none where only device activity was profiled)."""
    from torch.autograd import DeviceType
    device, runtime, ops, host = [], {}, {}, []

    def get(e, attr):
        fn = getattr(e, attr, None)
        return fn() if fn is not None else None

    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        corr = get(e, "correlation_id")
        if e.device_type() == DeviceType.CUDA:
            low = name.lower()
            kind = "memcpy" if low.startswith("memcpy") else \
                "memset" if low.startswith("memset") else "kernel"
            device.append((name, start, end, kind, corr,
                           get(e, "linked_correlation_id")))
        elif _is_runtime(name):
            runtime[corr] = start
        else:
            ops[corr] = start
            host.append((name, start, end, get(e, "start_thread_id")))
    return {"device": device, "runtime": runtime, "ops": ops, "host": host}


def merge(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, lo: int, hi: int):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def busy_ns(tl: dict, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which the device ran any operation."""
    return sum(e - s for s, e in merge(clip(
        [(d[1], d[2]) for d in tl["device"]], lo, hi)))


def launch_ns(tl: dict, dev_event):
    """Host time at which a device operation was launched: its runtime
    call, else the host operation it is linked to; None if neither was
    recorded."""
    _, _, _, _, corr, linked = dev_event
    if corr in tl["runtime"]:
        return tl["runtime"][corr]
    return tl["ops"].get(linked)


def launched_within(tl: dict, intervals):
    """(device ns, operations) of the kernels launched inside any of the
    host ``intervals``: the device time of a stage entry."""
    ivs = merge(intervals)
    total = count = 0
    for d in tl["device"]:
        if d[3] != "kernel":
            continue
        t = launch_ns(tl, d)
        if t is not None and any(s <= t < e for s, e in ivs):
            total += d[2] - d[1]
            count += 1
    return total, count


def top_device_ops(tl: dict, lo: int, hi: int, n: int = 10,
                   width: int = 160):
    """[[name, seconds]] of the ``n`` device operations that took most time
    in [lo, hi), summed by name; names cut to ``width`` characters."""
    by = defaultdict(int)
    for name, s, e, *_ in tl["device"]:
        if e > lo and s < hi:
            by[name] += min(e, hi) - max(s, lo)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:width], v / 1e9] for k, v in top]


def idle_gaps(tl: dict, lo: int, hi: int, host_spans, n: int = 10):
    """[[name, seconds]]: the device's idle time in [lo, hi), each gap
    named by what the host was doing at its middle (the innermost of the
    nested ``host_spans`` [(name, start, end)] there, the one that began
    last, else "host"), summed by name, the ``n`` largest."""
    busy = merge(clip([(d[1], d[2]) for d in tl["device"]], lo, hi))
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    by = defaultdict(int)
    for s, e in gaps:
        mid = (s + e) // 2
        inner = [(hs, name) for name, hs, he in host_spans
                 if hs <= mid < he]
        by[max(inner)[1] if inner else "host"] += e - s
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in top]
