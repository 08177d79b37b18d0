"""Synthetic test clip: the content family of the JAX package's benchmark
(``bench.make_clip``), copied so that the port needs nothing outside its
package, and a y4m writer for the CLI's input."""

from __future__ import annotations

import numpy as np


def make_clip(w=1920, h=1080, frames=9, seed=3):
    """Moving-texture clip (sinusoid mix + noise + global pan) of
    ``frames`` 4:2:0 8-bit (y, u, v) frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 64, 0:w + 64].astype(np.float32)
    base = (
        96 + 48 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
        + 32 * np.sin((xx + 2 * yy) / 41.0)
        + rng.normal(0, 6.0, (h + 64, w + 64))
    )
    out = []
    for t in range(frames):
        dx, dy = 3 * t, 2 * t
        y = np.clip(base[dy:dy + h, dx:dx + w], 0, 255).astype(np.uint8)
        u = np.clip(128 + 24 * np.sin((xx[:h // 2, :w // 2] + 7 * t) / 29.0),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 24 * np.cos((yy[:h // 2, :w // 2] - 5 * t) / 31.0),
                    0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def write_y4m(path, frames, fps_num: int = 30, fps_den: int = 1) -> None:
    """Write 8-bit 4:2:0 (y, u, v) frames as a y4m file at
    ``fps_num:fps_den`` (the CLI's input: ``utils.yuv.read_y4m``)."""
    h, w = frames[0][0].shape
    with open(path, "wb") as fh:
        fh.write(f"YUV4MPEG2 W{w} H{h} F{fps_num}:{fps_den} Ip A1:1 "
                 f"C420jpeg\n".encode())
        for planes in frames:
            fh.write(b"FRAME\n")
            for p in planes:
                fh.write(np.ascontiguousarray(p, np.uint8).tobytes())
