"""Parallel GOP encoding: keyframe-delimited chunks encoded concurrently.

The port's copy of the JAX package's ``pipeline/parallel.py``, the answer
to the reference's parallel-GOP machinery (PARALLEL_GOP_MAX_NUMBER
interval contexts, EbRateControlProcess.c:1089 and the 15-stage pipeline
keeping dozens of pictures in flight): closed GOPs are fully independent
streams, so they encode on a thread pool and concatenate in order. Every
worker's ``Encoder`` runs on the config's one device, on its default
stream (torch and the native coder release the GIL in the heavy work).
Output packets are byte-identical to a serial encode because every chunk
starts from a keyframe reset.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

from svt_av1_tpu_torch.config import EncoderConfig, RateControlMode


def gop_chunks(n_frames: int, cfg: EncoderConfig) -> List[Tuple[int, int]]:
    """[start, end) ranges, each beginning at a keyframe position."""
    period = cfg.intra_period
    if period < 0:
        return [(0, n_frames)]
    step = period + 1 if period > 0 else 1
    return [(i, min(i + step, n_frames)) for i in range(0, n_frames, step)]


def parallelizable(cfg: EncoderConfig) -> bool:
    """Chunks are independent only with closed GOPs and stateless RC."""
    return (cfg.intra_period >= 0
            and not cfg.scene_change_detection
            and cfg.rate_control_mode == RateControlMode.CQP
            and cfg.film_grain_strength >= 0)


def _encode_chunk(frames, cfg: EncoderConfig):
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    enc = Encoder(cfg)
    out = []
    for f in frames:
        enc.send_picture(*f)
        while (p := enc.get_packet()) is not None:
            out.append(p)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        out.append(p)
    return out


def encode_parallel(frames: List[tuple], cfg: EncoderConfig,
                    jobs: int) -> List[tuple]:
    """Encode (y, u, v) frames with `jobs` concurrent GOP workers.

    Returns the packet list [(tu, display_recon_or_None), ...] in the
    same order a serial Encoder would produce.
    """
    if not parallelizable(cfg):
        raise ValueError("parallel GOPs need closed GOPs (intra_period >= "
                         "0), CQP, and no scene-change detection")
    chunks = gop_chunks(len(frames), cfg)
    if jobs <= 1 or len(chunks) <= 1:
        return _encode_chunk(frames, cfg)
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        futs = [pool.submit(_encode_chunk, frames[a:b], cfg)
                for a, b in chunks]
        out = []
        for f in futs:
            out.extend(f.result())
    return out
