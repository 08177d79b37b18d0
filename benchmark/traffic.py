"""The benchmark's video source: a seeded stream of frames, made one at a
time.

The content family is that of the program's ``utils/clip.make_clip`` (a
sinusoid mix plus Gaussian noise of sigma 6, panned 3 px right and 2 px
down per frame, with sinusoidal chroma), copied here so that the yardstick
does not change with the program. Two things differ:

- the stream has any length: the pan wraps around a tiled base texture
  (``make_clip`` pads its base by 64 px, so it ends at 22 frames), and
- a cut starts a new shot: a new texture drawn from (seed, shot), whose
  mean luma alternates by ``shot_luma_step`` so that the encoder's scene
  change detector fires (mean absolute difference 28 and histogram
  distance 0.55 on decimated luma); nothing else in the stream fires it.

Shot 0 is ``make_clip``'s base, so with no cut the first 22 frames equal
``make_clip(width, height, frames, seed)``'s.

Above 8 bits the same float field is scaled by ``1 << (bit_depth - 8)``
(means, amplitudes, noise and the shots' luma step with it) before it is
clipped and cast as at 8 bits, toward zero: the two low bits of a 10-bit
sample carry the field's fraction, and its top 8 bits are the 8-bit
stream's sample.
"""

from __future__ import annotations

import numpy as np

PAD = 64                   # make_clip's base padding, in pixels


def _wrap(a: np.ndarray, start: int, n: int, axis: int) -> np.ndarray:
    """``n`` entries of ``a`` along ``axis`` from ``start``, wrapping."""
    size = a.shape[axis]
    start %= size
    idx = np.arange(start, start + n) % size
    if start + n <= size:
        return a[start:start + n] if axis == 0 else a[:, start:start + n]
    return np.take(a, idx, axis=axis)


class Stream:
    """Frames of one traffic mix at one size and seed.

    ``cut_every`` 0 makes one shot; otherwise shot 1 starts at frame
    ``first_cut`` and every ``cut_every`` frames start the next. Planes are
    ``uint8`` at 8 bits and ``uint16`` at 10."""

    def __init__(self, width: int, height: int, seed: int, *,
                 cut_every: int = 0, first_cut: int = 0,
                 pan_px=(3, 2), noise_sigma: float = 6.0,
                 shot_luma_step: float = 60.0, bit_depth: int = 8):
        if seed < 0:
            raise ValueError(f"seed must be >= 0, got {seed}")
        if cut_every < 0 or first_cut < 0:
            raise ValueError("cut_every and first_cut must be >= 0")
        if bit_depth not in (8, 10):
            raise ValueError(f"bit_depth must be 8 or 10, got {bit_depth}")
        self.width, self.height, self.seed = width, height, seed
        self.bit_depth = bit_depth
        self.cut_every, self.first_cut = cut_every, first_cut
        self.pan = tuple(pan_px)
        self.noise_sigma = noise_sigma
        self.shot_luma_step = shot_luma_step
        self._shot = None          # (shot index, base texture samples)
        hb, wb = height + PAD, width + PAD
        yy, xx = np.mgrid[0:hb, 0:wb].astype(np.float32)
        self._grid = (yy, xx)
        # the chroma planes depend on one coordinate each
        self._cx = xx[0, :width // 2]
        self._cy = yy[:height // 2, 0]

    # --- shots --------------------------------------------------------------
    def shot_of(self, t: int) -> int:
        if self.cut_every == 0 or t < self.first_cut:
            return 0
        return 1 + (t - self.first_cut) // self.cut_every

    def shot_start(self, shot: int) -> int:
        return 0 if shot == 0 else self.first_cut + (shot - 1) * self.cut_every

    def is_cut(self, t: int) -> bool:
        """True where frame ``t`` starts a shot (frame 0 excluded)."""
        return t > 0 and self.shot_start(self.shot_of(t)) == t

    def _base(self, shot: int) -> np.ndarray:
        if self._shot is not None and self._shot[0] == shot:
            return self._shot[1]
        yy, xx = self._grid
        hb, wb = yy.shape
        if shot == 0:
            # make_clip's base, term for term
            rng = np.random.default_rng(self.seed)
            base = (96 + 48 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
                    + 32 * np.sin((xx + 2 * yy) / 41.0)
                    + rng.normal(0, self.noise_sigma, (hb, wb)))
        else:
            rng = np.random.default_rng([self.seed, shot])
            ox, oy = rng.uniform(0, 1000, 2).astype(np.float32)
            mean = 96 + self.shot_luma_step * (shot % 2)
            base = (mean + 48 * np.sin((xx + ox) / 17.0)
                    * np.cos((yy + oy) / 23.0)
                    + 32 * np.sin((xx + ox + 2 * (yy + oy)) / 41.0)
                    + rng.normal(0, self.noise_sigma, (hb, wb)))
        base = self._samples(base)
        self._shot = (shot, base)
        return base

    def _samples(self, field: np.ndarray) -> np.ndarray:
        """The float ``field`` (8-bit scale) as samples at the stream's
        depth."""
        bd = self.bit_depth
        return np.clip(field * (1 << (bd - 8)), 0, (1 << bd) - 1) \
            .astype(np.uint8 if bd == 8 else np.uint16)

    # --- frames -------------------------------------------------------------
    def frame(self, t: int):
        """Frame ``t`` as 4:2:0 (y, u, v) planes at the stream's depth."""
        shot = self.shot_of(t)
        k = t - self.shot_start(shot)
        base = self._base(shot)
        dx, dy = self.pan[0] * k, self.pan[1] * k
        y = np.ascontiguousarray(_wrap(_wrap(base, dy, self.height, 0),
                                       dx, self.width, 1))
        h2, w2 = self.height // 2, self.width // 2
        u_row = self._samples(128 + 24 * np.sin((self._cx + 7 * t) / 29.0))
        v_col = self._samples(128 + 24 * np.cos((self._cy - 5 * t) / 31.0))
        u = np.ascontiguousarray(np.broadcast_to(u_row[None, :], (h2, w2)))
        v = np.ascontiguousarray(np.broadcast_to(v_col[:, None], (h2, w2)))
        return y, u, v
