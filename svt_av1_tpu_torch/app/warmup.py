"""Warmup: pay a configuration's first-frame costs before serving.

The port's counterpart of the JAX package's ``app/warmup.py``. On the card
an encoder's first frames pay for what later frames reuse: the first-use
build of the hand-written kernels (``nvcc``, into the package's
``build/``; a later process loads the built library), the native range
coder's build, the CUDA context, the caching allocator's first blocks and
the per-shape constant tables. This tool drives one small synthetic clip
(a keyframe + one full mini-GOP, which together touch every path the
configuration can reach: all shape groups, the key-frame and flip
programs, DLF/CDEF/LR, every temporal layer) through the real encoder.

Usage:
    python -m svt_av1_tpu_torch.app.warmup --width 1920 --height 1080 \\
        --preset 5 [--bit-depth 8] [--hierarchical-levels 3] [--qp 40]
"""

from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _warm_one(width: int, height: int, preset: int, qp: int,
              bit_depth: int, hierarchical_levels: int, frames: int,
              device: str, verbose: bool, seed: int = 0,
              tag: str = "warmup") -> None:
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline.encoder import Encoder

    rng = np.random.default_rng(seed)
    h, w = height, width
    yy, xx = np.mgrid[0:h + 32, 0:w + 32].astype(np.float32)
    # content varies with the seed so concurrent warmers reach different
    # partition outcomes (and so different block-batch shapes)
    base = 96 + 48 * np.sin(xx / (17.0 + 2 * seed)) \
        * np.cos(yy / (23.0 + 3 * seed)) \
        + rng.normal(0, 6.0 + 4.0 * (seed % 3), (h + 32, w + 32))
    shift = (bit_depth - 8)
    cfg = preset_config(width=w, height=h, qp=qp, bit_depth=bit_depth,
                        intra_period=-1, preset=preset,
                        hierarchical_levels=hierarchical_levels,
                        device=device)
    enc = Encoder(cfg)
    dt = np.uint8 if bit_depth <= 8 else np.uint16
    t0 = time.perf_counter()
    for t in range(frames):
        y = (np.clip(base[2 * t:2 * t + h, 3 * t:3 * t + w], 0, 255)
             .astype(np.int32) << shift).astype(dt)
        u = np.full(((h + 1) // 2, (w + 1) // 2), 128 << shift, dtype=dt)
        v = u.copy()
        enc.send_picture(y, u, v)
        while enc.get_packet() is not None:
            pass
        if verbose:
            print(f"[{tag}] {t + 1}/{frames} "
                  f"t={time.perf_counter() - t0:.1f}s", file=sys.stderr,
                  flush=True)
    enc.flush()
    while enc.get_packet() is not None:
        pass


def warm(width: int, height: int, preset: int, qp: int = 40,
         bit_depth: int = 8, hierarchical_levels: int = 3,
         frames: int = 9, device: str = "cuda",
         verbose: bool = True, jobs: int = 1) -> float:
    """Encode the warmup clip on ``device`` (a CUDA device without a card
    raises); ``jobs`` > 1 runs that many encoder instances on threads
    over content variants, sharing the device (the kernel build runs
    once, under its lock). Returns the seconds it took, the device
    synchronised."""
    t0 = time.perf_counter()
    if jobs <= 1:
        _warm_one(width, height, preset, qp, bit_depth,
                  hierarchical_levels, frames, device, verbose)
    else:
        with ThreadPoolExecutor(max_workers=jobs) as ex:
            futs = [ex.submit(_warm_one, width, height, preset, qp,
                              bit_depth, hierarchical_levels, frames,
                              device, verbose and j == 0, j,
                              f"warmup#{j}")
                    for j in range(jobs)]
            for f in futs:
                f.result()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dt_s = time.perf_counter() - t0
    if verbose:
        print(f"[warmup] done in {dt_s:.1f}s (jobs={jobs})",
              file=sys.stderr, flush=True)
    return dt_s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--preset", type=int, default=5)
    ap.add_argument("--qp", type=int, default=40)
    ap.add_argument("--bit-depth", type=int, default=8)
    ap.add_argument("--hierarchical-levels", type=int, default=3)
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=1,
                    help="parallel warmers (threads on the one device)")
    a = ap.parse_args(argv)
    warm(a.width, a.height, a.preset, a.qp, a.bit_depth,
         a.hierarchical_levels, a.frames, a.device, jobs=a.jobs)


if __name__ == "__main__":
    main()
