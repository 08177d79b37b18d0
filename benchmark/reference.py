"""The comparison that decides ``correct``: the benchmark's frozen NumPy
copy of the port's own AV1 decoder (``benchmark/avref``) decodes every
packet the encoder emitted, from the stream's first, and the decode is
compared with what the encoder said it reconstructed and with the source.

What it shows, and what it does not: the copy was taken from the port's
``pipeline/decode.py`` with the host modules it needs, and the encoder
derives its contexts, MV predictions and availability with the same
code. So a decode equal to the encoder's reconstruction shows that the
stream is self-consistent under a snapshot of that syntax code, and
catches any later change to the encoder that breaks it; a fault that the
encoder and the snapshot share passes. It is not an independent AV1
decoder. The luma PSNR of the decode against the benchmark's own source
is the part that does not rest on the program's code; it is taken at the
peak of the bit depth the configuration states, and a stream whose
sequence header states another depth decodes as wholly wrong.

It imports NumPy and the frozen copy only: nothing of the program, of
JAX or of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.avref.pipeline.decode import StreamDecoder

PSNR_CAP_DB = 100.0        # a frame decoded without error reads this


def psnr_db(a: np.ndarray, b: np.ndarray, peak: int = 255) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0.0:
        return PSNR_CAP_DB
    return min(PSNR_CAP_DB, 10.0 * math.log10(peak * peak / mse))


def _samples(planes) -> int:
    return sum(p.size for p in planes)


def _differ(a, b) -> int:
    """Samples of plane triple ``a`` that differ from ``b`` (every sample
    of a plane whose shape differs)."""
    return sum(int(np.count_nonzero(x != y)) if x.shape == y.shape
               else max(x.size, y.size) for x, y in zip(a, b))


def check(packets, sources: dict, judged_from: int,
          bit_depth: int = 8) -> dict:
    """Decode ``packets`` [(tu bytes, encoder's display recon or None)] in
    order. Returns the per-frame judgement: ``mismatch`` (samples where
    the decode differs from the encoder's recon, a frame one side shows
    and the other does not counting whole), ``frames`` [(display index,
    samples differing, luma PSNR against ``sources[index]`` at the peak
    of ``bit_depth``, or None)] for the shown frames from display index
    ``judged_from`` on, and ``error`` (the decoder's exception, or a
    sequence header that states another bit depth than ``bit_depth``:
    from that packet on every shown frame counts as differing whole)."""
    peak = (1 << bit_depth) - 1
    dec = StreamDecoder()
    mismatch, shown, frames, error = 0, 0, [], None
    for tu, recon in packets:
        out = None
        if error is None:
            try:
                out = dec.decode_tu(tu)
            except Exception as e:   # a stream the decoder cannot read
                error = f"{type(e).__name__}: {e}"
            else:
                if dec.seq is not None and dec.seq.bit_depth != bit_depth:
                    error = (f"the sequence header states "
                             f"{dec.seq.bit_depth} bits, the configuration "
                             f"{bit_depth}")
        if out is None and recon is None:
            continue
        if error is not None:
            bad = _samples(recon if recon is not None else out)
        elif out is None or recon is None:
            bad = _samples(recon if recon is not None else out)
        else:
            bad = _differ(out, recon)
        mismatch += bad
        if shown >= judged_from:
            src = sources.get(shown)
            psnr = psnr_db(out[0], src, peak) \
                if (out is not None and src is not None
                    and out[0].shape == src.shape) else None
            frames.append((shown, bad, psnr))
        shown += 1
    return {"mismatch": mismatch, "frames": frames, "error": error}
