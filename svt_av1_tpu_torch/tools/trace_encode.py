"""Traced end-to-end encode of the port: per-stage timing of the
production encoder (the twin of the JAX package's
``tools/trace_encode.py``).

Usage: python -m svt_av1_tpu_torch.tools.trace_encode
       [W H frames preset device [qp]]
Prints per-frame wall times, the span summary, the spans with meta and
the kernel launches of the timed pass."""

from __future__ import annotations

import json
import sys
import time

import torch


def main(argv=None):
    args = sys.argv[1:] if argv is None else list(argv)
    w = int(args[0]) if args else 1920
    h = int(args[1]) if len(args) > 1 else 1080
    n = int(args[2]) if len(args) > 2 else 9
    preset = int(args[3]) if len(args) > 3 else 5
    device = args[4] if len(args) > 4 else "cuda"
    qp = int(args[5]) if len(args) > 5 else 40

    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    from svt_av1_tpu_torch.utils.clip import make_clip
    from svt_av1_tpu_torch.utils.trace import SPAN_KEYS, TRACER

    frames = make_clip(w, h, frames=n)
    cfg = preset_config(width=w, height=h, qp=qp, preset=preset,
                        hierarchical_levels=3, device=device)
    on_card = torch.device(device).type == "cuda"

    def run(tag):
        enc = Encoder(cfg)
        t0 = time.perf_counter()
        last = t0
        nbytes = 0
        for fi, (y, u, v) in enumerate(frames):
            enc.send_picture(y, u, v)
            while (pkt := enc.get_packet()) is not None:
                nbytes += len(pkt[0])
            now = time.perf_counter()
            print(f"[{tag}] fed {fi + 1}/{n} +{now - last:.2f}s "
                  f"total {now - t0:.1f}s", flush=True)
            last = now
        enc.flush()
        while (pkt := enc.get_packet()) is not None:
            nbytes += len(pkt[0])
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[{tag}] {n} frames in {dt:.2f}s = {n / dt:.3f} fps, "
              f"{nbytes} bytes", flush=True)
        return nbytes

    run("warmup")
    TRACER.enabled = True
    TRACER.reset()
    dev.LAUNCHES.clear()
    nbytes = run("timed")
    TRACER.enabled = False
    print(json.dumps(TRACER.summary(), indent=1))
    for s in TRACER.spans:
        if set(s) - SPAN_KEYS:   # spans with meta (counts)
            print(json.dumps(s))
    print(json.dumps({"kernel_launches": dict(dev.LAUNCHES)}))
    return nbytes


if __name__ == "__main__":
    main()
