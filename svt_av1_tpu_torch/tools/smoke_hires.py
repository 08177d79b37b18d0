#!/usr/bin/env python
"""High-resolution / high-bit-depth operating-point smokes of the port
(the twin of the JAX package's ``tools/smoke_hires.py``).

Runs the two BASELINE.md configs above 1080p 8-bit:
  4k    — 3840x2160 10-bit CQP, few frames
  vbr10 — 1920x1080 10-bit VBR (rc 1, tbr 3000, lad 17)

Each clip encodes through the production Encoder, mirror-decodes with
the port's own decoder, and prints fps + bytes.

Usage: python -m svt_av1_tpu_torch.tools.smoke_hires [4k|vbr10|both]
       [--frames N] [--device cuda|cpu] [--preset P]
"""

from __future__ import annotations

import argparse
import io
import json
import time

import numpy as np


def make_clip(w, h, frames, bit_depth, seed=3):
    """The moving-texture luma of ``utils/clip.make_clip`` shifted to
    ``bit_depth``, with flat chroma at ``128 << s`` and ``130 << s``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 64, 0:w + 64].astype(np.float32)
    base = (96 + 48 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
            + 32 * np.sin((xx + 2 * yy) / 41.0)
            + rng.normal(0, 6.0, (h + 64, w + 64)))
    shift = bit_depth - 8
    dt = np.uint8 if bit_depth <= 8 else np.uint16
    out = []
    for t in range(frames):
        dx, dy = 3 * t, 2 * t
        y = (np.clip(base[dy:dy + h, dx:dx + w], 0, 255)
             .astype(np.int32) << shift).astype(dt)
        u = np.full((h // 2, w // 2), 128 << shift, dt)
        v = np.full((h // 2, w // 2), 130 << shift, dt)
        out.append((y, u, v))
    return out


def psnr(a, b, peak):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(peak * peak / mse)


def run(name, cfg, frames):
    """Encode ``frames`` through ``Encoder`` (timed), then as IVF, decode
    the IVF with the port's mirror decoder and return frames, wall
    time, fps, bytes and the lowest luma PSNR."""
    from svt_av1_tpu_torch.pipeline.decode import decode_ivf
    from svt_av1_tpu_torch.pipeline.encoder import Encoder, encode_ivf
    t0 = time.perf_counter()
    enc = Encoder(cfg)
    for f in frames:
        enc.send_picture(*f)
        while enc.get_packet() is not None:
            pass
    enc.flush()
    while enc.get_packet() is not None:
        pass
    wall = time.perf_counter() - t0
    iv = encode_ivf(frames, cfg)
    decs = decode_ivf(io.BytesIO(iv))
    assert len(decs) == len(frames), (len(decs), len(frames))
    peak = (1 << cfg.bit_depth) - 1
    ps = [psnr(f[0], d[0], peak) for f, d in zip(frames, decs)]
    # the wall includes the first use of every kernel and program shape
    print(f"[{name}] {len(frames)} frames, wall {wall:.1f}s = "
          f"{len(frames) / wall:.3f} fps, {len(iv)} bytes, "
          f"min Y-PSNR {min(ps):.2f} dB — mirror decode OK", flush=True)
    return dict(frames=len(frames), wall_s=round(wall, 1),
                wall_fps=round(len(frames) / wall, 3), bytes=len(iv),
                min_psnr=round(min(ps), 2))


def configs(device="cuda", preset=5) -> dict:
    """The two operating points' configs: {name: (label, config, clip
    (w, h, bit depth), least frames)}."""
    from svt_av1_tpu_torch.app.cli import preset_config
    return {
        "4k": ("4k 10-bit CQP", preset_config(
            width=3840, height=2160, qp=40, bit_depth=10, preset=preset,
            device=device), (3840, 2160, 10), 1),
        "vbr10": ("1080p 10-bit VBR", preset_config(
            width=1920, height=1080, qp=40, bit_depth=10, preset=preset,
            hierarchical_levels=3, tbr=3000, lad=17, device=device),
            (1920, 1080, 10), 6)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="both",
                    choices=("4k", "vbr10", "both"))
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", type=int, default=5)
    a = ap.parse_args(argv)
    out = {}
    for key, (label, cfg, (w, h, bd), least) in configs(
            a.device, a.preset).items():
        if a.which in (key, "both"):
            out[key] = run(label, cfg,
                           make_clip(w, h, max(a.frames, least), bd))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
