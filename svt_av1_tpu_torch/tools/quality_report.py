#!/usr/bin/env python
"""RD quality dashboard of the port (the twin of the JAX package's
``tools/quality_report.py``): encode a fixed synthetic suite across QPs
and tool configurations, print bytes/PSNR per point. The numbers are
self-relative (no external anchor); the port's bytes and PSNR equal the
JAX package's at every point.

Run:  python -m svt_av1_tpu_torch.tools.quality_report [--quick]
      [--natural] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

CONFIGS = [
    ("baseline (fixed16, no tools)",
     dict(fixed_partition_size=16, enable_dlf=False)),
    ("partition RD + DLF", dict(fixed_partition_size=None)),
    ("+ CDEF + LR", dict(fixed_partition_size=None, enable_cdef=True,
                         enable_restoration=True)),
    ("+ tx search + AQ", dict(fixed_partition_size=None,
                              enable_cdef=True,
                              enable_restoration=True,
                              enable_tx_type_search=True,
                              adaptive_quantization=1)),
    ("RA hl=2 all tools", dict(fixed_partition_size=None,
                               enable_cdef=True,
                               enable_restoration=True,
                               enable_tx_type_search=True,
                               adaptive_quantization=1,
                               hierarchical_levels=2,
                               intra_period=31)),
]


def _psnr(a, b, peak=255.0):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(peak * peak / mse)


def _suite(w, h, n):
    rng = np.random.RandomState(42)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (120 + 55 * np.sin((yy + 2 * t) / 17.0)
             * np.cos((xx + 3 * t) / 23.0)
             + 25 * ((xx + yy + 4 * t) % 24 < 4)
             + rng.normal(0, 4, (h, w)))
        sx = 30 + 10 * t
        y[70:110, sx:sx + 50] = 220
        y = np.clip(y, 0, 255).astype(np.uint8)
        lu = y.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        u = np.clip(70 + 0.5 * lu, 0, 255).astype(np.uint8)
        v = np.clip(190 - 0.4 * lu, 0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def run_point(frames, device="cuda", **kw):
    """(bytes, mean Y-PSNR, encode seconds) of ``frames`` under the
    config options ``kw``; every TU is decoded by the port's mirror
    decoder and must equal the encoder's recon."""
    from svt_av1_tpu_torch.config import EncoderConfig
    from svt_av1_tpu_torch.pipeline.decode import StreamDecoder
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    cfg = EncoderConfig(width=frames[0][0].shape[1],
                        height=frames[0][0].shape[0],
                        scene_change_detection=False, device=device, **kw)
    enc = Encoder(cfg)
    outs = []
    t0 = time.perf_counter()
    for f in frames:
        enc.send_picture(*f)
        while (p := enc.get_packet()) is not None:
            outs.append(p)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        outs.append(p)
    dt = time.perf_counter() - t0
    dec = StreamDecoder()
    total = 0
    psnrs = []
    shown = 0
    for tu, disp in outs:
        total += len(tu)
        out = dec.decode_tu(tu)
        if disp is None:
            continue
        for p in range(3):
            assert (out[p] == disp[p]).all(), "decode mismatch"
        psnrs.append(_psnr(frames[shown][0], out[0]))
        shown += 1
    return total, float(np.mean(psnrs)), dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--natural", action="store_true",
                    help="the real-photograph pan clip (utils/natural.py)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    w, h, n = (320, 192, 4) if a.quick else (640, 360, 8)
    if a.natural:
        from svt_av1_tpu_torch.utils import natural
        assert natural.available(), "natural-content asset missing"
        frames = natural.natural_clip(w, h, n)
    else:
        frames = _suite(w, h, n)
    qps = (30, 45) if a.quick else (25, 35, 45, 55)
    print(f"# {w}x{h}, {n} frames")
    print(f"{'config':<28} {'qp':>3} {'bytes':>8} {'Y-PSNR':>7} {'enc s':>6}")
    for name, kw in CONFIGS:
        for qp in qps:
            total, psnr, dt = run_point(frames, a.device, qp=qp, **kw)
            print(f"{name:<28} {qp:>3} {total:>8} {psnr:>7.2f} {dt:>6.1f}")


if __name__ == "__main__":
    main()
