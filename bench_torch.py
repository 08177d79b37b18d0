"""Benchmark of the PyTorch/CUDA port: END-TO-END 1080p encode throughput
(IVF bytes out), the twin of ``bench.py``.

    python3 bench_torch.py                 # on the card
    python3 bench_torch.py --device cpu    # the plain PyTorch versions

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} under a
metric name of its own, so the two packages' numbers are never confused.

What is measured: ``svt_av1_tpu_torch.pipeline.encoder.Encoder`` at
``bench.py``'s operating point — 9 frames of the moving-texture clip
(``utils/clip.make_clip``), 1920x1080 8-bit, random access with a 3-level
hierarchical-B pyramid, qp 40, preset 5 (4 tile columns). A first untimed
pass absorbs the kernels' build, the allocator and the caches; the timed
pass runs until every temporal unit is in hand, and the card is
synchronised before the clock stops. The timed stream must equal the JAX
package's stream of the same clip (``GOLDEN_RA_*``, copied from
``chip_smoke.py``); a stream that differs is an error, not a number.

``vs_baseline`` is against ``bench.py``'s anchor, the reference encoder's
1.38 fps on the same clip (BASELINE.md).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import sys
import time

import torch

BASELINE_FPS = 1.38  # bench.py's anchor: reference config 3 (BASELINE.md)
METRIC = "1080p_e2e_encode_fps_torch"     # + "_cuda" or "_cpu"
# the JAX package's stream of this operating point (chip_smoke.py's
# GOLDEN_RA_*: encode_ivf(backend="host") on make_clip(1920, 1080, 9))
GOLDEN_RA_SHA256 = \
    "3f3f8896fd6341d88d0ab7231ee84b994c93834f2e6a7a808da2e634457e07a4"
GOLDEN_RA_BYTES = 415319
WIDTH, HEIGHT, FRAMES = 1920, 1080, 9


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def encode_once(frames, cfg, tag=""):
    """Encode ``frames`` through ``Encoder``; return the temporal units'
    byte count (``bench.encode_once``'s) and the stream as the IVF that
    ``encode_ivf`` writes."""
    from svt_av1_tpu_torch.bitstream.ivf import (patch_ivf_frame_count,
                                                 write_ivf_frame,
                                                 write_ivf_header)
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    enc = Encoder(cfg)
    buf = io.BytesIO()
    write_ivf_header(buf, cfg.width, cfg.height, cfg.frame_rate_num,
                     cfg.frame_rate_den, len(frames))
    n = nbytes = 0
    t0 = time.perf_counter()

    def drain():
        nonlocal n, nbytes
        while (pkt := enc.get_packet()) is not None:
            write_ivf_frame(buf, pkt[0], n)
            n += 1
            nbytes += len(pkt[0])

    for fi, (y, u, v) in enumerate(frames):
        enc.send_picture(y, u, v)
        drain()
        if tag:
            print(f"[bench {tag}] fed {fi + 1}/{len(frames)} "
                  f"t={time.perf_counter() - t0:.1f}s", file=sys.stderr,
                  flush=True)
    enc.flush()
    drain()
    _sync(cfg.device)
    # pyramid GOPs emit extra packets (non-shown anchors + show_existing)
    assert n >= len(frames) and nbytes > 0
    patch_ivf_frame_count(buf, n)
    return nbytes, buf.getvalue()


def main(argv=None) -> dict:
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.utils.clip import make_clip
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    frames = make_clip(WIDTH, HEIGHT, frames=FRAMES)
    cfg = preset_config(width=WIDTH, height=HEIGHT, qp=40, preset=5,
                        intra_period=-1, hierarchical_levels=3,
                        device=a.device)

    encode_once(frames, cfg, tag="warmup")     # nvcc build, allocator
    _sync(a.device)
    t0 = time.perf_counter()
    _, ivf = encode_once(frames, cfg)
    dt = time.perf_counter() - t0
    sha = hashlib.sha256(ivf).hexdigest()
    if sha != GOLDEN_RA_SHA256 or len(ivf) != GOLDEN_RA_BYTES:
        raise SystemExit(f"bench_torch: the stream differs from the JAX "
                         f"golden: {len(ivf)} bytes sha256 {sha}")
    fps = len(frames) / dt
    out = {"metric": f"{METRIC}_{torch.device(a.device).type}",
           "value": round(fps, 3), "unit": "frames/s",
           "vs_baseline": round(fps / BASELINE_FPS, 3)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
