"""Natural-content test clip from a real photograph.

Provenance: ``OutdoorSkybox2048.png`` is a real outdoor photograph
(2048x1536 RGBA skybox face) shipped inside the locally-installed
``dm_control`` package (Apache-2.0) — no network access is needed and
the pixels are genuine camera content (sky/terrain texture), unlike the
synthetic sinusoid+noise family in ``bench.make_clip``. The clip is a
deterministic slow pan + exposure drift over BT.601 YUV 4:2:0
conversions of that photograph.

The port's copy of the JAX package's ``utils/natural.py``: the same
clips, the photograph found through the installed package rather than a
fixed path. Gate on ``available()``: a machine without ``dm_control``
has no photograph.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

# the photograph's place inside the installed dm_control package
_ASSET = ("locomotion", "arenas", "assets", "outdoor_natural",
          "OutdoorSkybox2048.png")


def _skybox() -> str:
    """The photograph's path in the installed ``dm_control`` package, or
    "" when the package is not installed."""
    spec = importlib.util.find_spec("dm_control")
    if spec is None or not spec.submodule_search_locations:
        return ""
    return os.path.join(list(spec.submodule_search_locations)[0], *_ASSET)


_SKYBOX = _skybox()


def available() -> bool:
    return bool(_SKYBOX) and os.path.exists(_SKYBOX)


def _rgb_to_yuv420(rgb: np.ndarray):
    """BT.601 limited-range RGB -> YUV 4:2:0 (even dims)."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = 16 + (65.738 * r + 129.057 * g + 25.064 * b) / 256.0
    u = 128 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256.0
    v = 128 + (112.439 * r - 94.154 * g - 18.285 * b) / 256.0
    y8 = np.clip(np.round(y), 0, 255).astype(np.uint8)

    def sub(p):
        p = p[: p.shape[0] // 2 * 2, : p.shape[1] // 2 * 2]
        q = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
             + p[1::2, 1::2]) / 4.0
        return np.clip(np.round(q), 0, 255).astype(np.uint8)

    return y8, sub(u), sub(v)


def natural_clip(w: int = 1280, h: int = 720, frames: int = 8,
                 pan=(2, 3), path: str = _SKYBOX, origin=(620, 0)):
    """Deterministic panning clip over the outdoor photograph.

    ``origin``: top-left of the pan window — the default sits in the
    textured terrain band of the photograph (rows 512-1024; the top of
    the skybox is flat sky and compresses to nothing).
    Returns a list of (y, u, v) uint8 planes, or raises FileNotFoundError
    when the source asset is absent (callers gate on ``available()``)."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    rgb = np.asarray(im)
    H, W = rgb.shape[:2]
    oy, ox = origin
    need_h = oy + h + pan[0] * (frames - 1)
    need_w = ox + w + pan[1] * (frames - 1)
    assert need_h <= H and need_w <= W, (need_h, need_w, H, W)
    out = []
    for t in range(frames):
        win = rgb[oy + pan[0] * t:oy + pan[0] * t + h,
                  ox + pan[1] * t:ox + pan[1] * t + w].astype(np.float64)
        win = np.clip(win * (1.0 + 0.004 * t), 0, 255)  # exposure drift
        out.append(_rgb_to_yuv420(win.astype(np.uint8)))
    return out


def occluder_clip(w: int = 448, h: int = 256, frames: int = 9,
                  speed: int = 24, patch=(96, 128), path: str = _SKYBOX,
                  origin=(620, 0)):
    """Static natural background + a moving natural-texture occluder.

    The corridor the patch sweeps keeps being covered/uncovered, so
    nothing references those pixels across the window, while the stable
    background is referenced by every frame — exactly the spatial
    heterogeneity TPL AQ exploits (finer q on the referenced
    background, coarser on the churn corridor).
    Returns (y, u, v) uint8 plane lists."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    rgb = np.asarray(im)
    oy, ox = origin
    bg = rgb[oy:oy + h, ox:ox + w].astype(np.uint8)
    ph, pw = patch
    tex = rgb[oy + h:oy + h + ph, ox:ox + pw].astype(np.uint8)
    out = []
    for t in range(frames):
        f = bg.copy()
        x0 = (8 + speed * t) % max(1, w - pw)
        y0 = h // 2 - ph // 2
        f[y0:y0 + ph, x0:x0 + pw] = tex
        out.append(_rgb_to_yuv420(f))
    return out
