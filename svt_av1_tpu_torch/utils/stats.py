"""Quality/rate statistics (reference: EbPsnr.c, stat_report path)."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


def sse(a: np.ndarray, b: np.ndarray) -> int:
    d = a.astype(np.int64) - b.astype(np.int64)
    return int(np.sum(d * d))


def psnr(a: np.ndarray, b: np.ndarray, bit_depth: int = 8) -> float:
    """aom_sse_to_psnr semantics (EbPsnr.c:19)."""
    peak = (1 << bit_depth) - 1
    s = sse(a, b)
    if s == 0:
        return 99.0
    return min(99.0, 10.0 * np.log10(peak * peak * a.size / s))


@dataclasses.dataclass
class FrameStat:
    frame_idx: int
    frame_type: str
    bytes: int
    psnr_y: float
    psnr_u: float
    psnr_v: float


class StatReport:
    """Per-frame stats + end-of-stream summary (reference: stat_report /
    average speed prints in EbAppProcessCmd.c)."""

    def __init__(self):
        self.frames: List[FrameStat] = []

    def add(self, idx, frame_type, nbytes, src_planes, recon_planes,
            bit_depth: int = 8):
        self.frames.append(FrameStat(
            idx, frame_type, nbytes,
            psnr(src_planes[0], recon_planes[0], bit_depth),
            psnr(src_planes[1], recon_planes[1], bit_depth),
            psnr(src_planes[2], recon_planes[2], bit_depth)))

    def summary(self, fps_num: int = 30, fps_den: int = 1) -> dict:
        if not self.frames:
            return {}
        total_bytes = sum(f.bytes for f in self.frames)
        secs = len(self.frames) * fps_den / fps_num
        return {
            "frames": len(self.frames),
            "total_bytes": total_bytes,
            "kbps": 8.0 * total_bytes / max(secs, 1e-9) / 1000.0,
            "avg_psnr_y": float(np.mean([f.psnr_y for f in self.frames])),
            "avg_psnr_u": float(np.mean([f.psnr_u for f in self.frames])),
            "avg_psnr_v": float(np.mean([f.psnr_v for f in self.frames])),
        }
