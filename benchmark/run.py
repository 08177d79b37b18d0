"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 benchmark/run.py --workload ra1080p.longgop --seed 7 \
        --seconds 10 --trace 0

With ``--trace 0`` the result line holds the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics. The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, which also end standard error). A run
with no card, with fewer cards than the cell asks for, or with a loaded
module of JAX or the JAX package, a live child process or a thread
left at its end exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def power_limit_w(index: int = 0):
    """The card's enforced power limit in watts, read through NVML in this
    process; None where NVML cannot be loaded."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    if nvml.nvmlInit_v2() != 0:
        return None
    try:
        handle = ctypes.c_void_p()
        mw = ctypes.c_uint()
        if nvml.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle)) \
                or nvml.nvmlDeviceGetEnforcedPowerLimit(handle,
                                                        ctypes.byref(mw)):
            return None
        return mw.value / 1000.0
    finally:
        nvml.nvmlShutdown()


def host_state() -> str:
    """The host as this process sees it: the cores it may run on, torch's
    CPU threads, the process's threads and the load average."""
    import torch
    try:
        load = Path("/proc/loadavg").read_text().split()[:3]
        tasks = len(os.listdir("/proc/self/task"))
    except OSError:
        load, tasks = "?", "?"
    return (f"cores {len(os.sched_getaffinity(0))}, torch threads "
            f"{torch.get_num_threads()}, process threads {tasks}, load "
            f"{' '.join(load)}")


def fail(msg: str, code: int) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")

    from benchmark import harness, hygiene
    manifest = harness.load_manifest()
    cell, config, traffic = harness.load_cell(args.workload, manifest)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device", 2)
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell asks for {cell['chips']} cards, "
             f"{torch.cuda.device_count()} present", 2)

    trace = bool(args.trace)
    print(f"benchmark: host at start: {host_state()}", file=sys.stderr)
    run, checks, state = harness.run_cell(config, traffic, args.seed,
                                          args.seconds, trace,
                                          t_start=T_START)
    metrics = {}
    for m in harness.metrics_of(cell["name"], manifest, trace):
        v = harness.read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": run.peak_bytes,
              "power_limit_w": power_limit_w()}
    out = {"correct": harness.passes(checks) and not state["decode_error"],
           "attempted": state["attempted"], "failed": state["failed"],
           "metrics": metrics, "device": device}
    if trace:
        prof = run.profile
        if prof.get("busy_s"):
            device["busy_s"] = prof["busy_s"]
            device["window_s"] = prof["wall_s"]
        out["breakdown"] = {"device_ops": prof.get("top_ops", []),
                            "idle_gaps": prof.get("idle_gaps", [])}
        print(f"benchmark: profiled frame {json.dumps(prof)}",
              file=sys.stderr)
    out["checks"] = checks

    left = hygiene.end_of_run()
    if left:
        fail(f"left at the end of the run: {left}", 4)
    print("benchmark: end of run: no child process, no thread but the main "
          "one, no module of JAX or the JAX package", file=sys.stderr)
    print(f"benchmark: host at end: {host_state()}", file=sys.stderr)
    print(f"benchmark: set-up frames sent and drained at "
          f"{[round(t, 3) for t in run.setup_marks]} s after process start",
          file=sys.stderr)
    print(f"benchmark: {run.frames} frames in a window of {run.window_s} s,"
          f" packets out at {[round(t, 3) for t in run.bursts]} s; the "
          f"reference decoded {state['packets_judged']} packets in "
          f"{state['reference_s']} s", file=sys.stderr)
    if state["decode_error"]:
        print(f"benchmark: the reference could not decode the stream: "
              f"{state['decode_error']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
