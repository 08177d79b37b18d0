"""Raw YUV 4:2:0 and y4m readers/writers.

Reference behavior: ``EbAppProcessCmd.c:754`` (ReadInputFrames) and
``EbAppInputy4m.c`` (y4m header parse). Host-side NumPy; frames are delivered
to the device pipeline as padded planar arrays.
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Frame:
    """One planar 4:2:0 frame. y: (H, W), u/v: (H//2, W//2)."""
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]


def frame_size_bytes(width: int, height: int, bit_depth: int = 8) -> int:
    per = 2 if bit_depth > 8 else 1
    return (width * height * 3 // 2) * per


def read_yuv_frames(fh: BinaryIO, width: int, height: int,
                    bit_depth: int = 8,
                    max_frames: Optional[int] = None) -> Iterator[Frame]:
    dtype = np.uint16 if bit_depth > 8 else np.uint8
    ysz, csz = width * height, (width // 2) * (height // 2)
    n = 0
    while max_frames is None or n < max_frames:
        raw = fh.read(frame_size_bytes(width, height, bit_depth))
        if len(raw) < frame_size_bytes(width, height, bit_depth):
            return
        buf = np.frombuffer(raw, dtype=dtype)
        yield Frame(
            y=buf[:ysz].reshape(height, width),
            u=buf[ysz:ysz + csz].reshape(height // 2, width // 2),
            v=buf[ysz + csz:].reshape(height // 2, width // 2),
        )
        n += 1


def write_yuv_frame(fh: BinaryIO, frame: Frame) -> None:
    fh.write(frame.y.tobytes())
    fh.write(frame.u.tobytes())
    fh.write(frame.v.tobytes())


def parse_y4m_header(line: bytes) -> dict:
    if not line.startswith(b"YUV4MPEG2"):
        raise ValueError("not a y4m stream")
    info = dict(width=None, height=None, fps_num=30, fps_den=1,
                bit_depth=8, fmt="420")
    for tok in line.split()[1:]:
        key, val = tok[:1], tok[1:]
        if key == b"W":
            info["width"] = int(val)
        elif key == b"H":
            info["height"] = int(val)
        elif key == b"F":
            num, den = val.split(b":")
            info["fps_num"], info["fps_den"] = int(num), int(den)
        elif key == b"C":
            s = val.decode()
            if s.startswith("420"):
                info["fmt"] = "420"
                if s.endswith("p10"):
                    info["bit_depth"] = 10
            else:
                raise ValueError(f"unsupported y4m chroma format {s}")
    if info["width"] is None or info["height"] is None:
        raise ValueError("y4m missing W/H")
    return info


def read_y4m(fh: BinaryIO,
             max_frames: Optional[int] = None) -> Tuple[dict, Iterator[Frame]]:
    header = bytearray()
    while not header.endswith(b"\n"):
        b = fh.read(1)
        if not b:
            raise ValueError("truncated y4m header")
        header += b
    info = parse_y4m_header(bytes(header[:-1]))

    def frames():
        n = 0
        while max_frames is None or n < max_frames:
            line = bytearray()
            b = fh.read(1)
            if not b:
                return
            line += b
            while not line.endswith(b"\n"):
                line += fh.read(1)
            if not line.startswith(b"FRAME"):
                raise ValueError("bad y4m frame marker")
            yield next(read_yuv_frames(fh, info["width"], info["height"],
                                       info["bit_depth"], max_frames=1))
            n += 1

    return info, frames()


def pad_frame(frame: Frame, padded_w: int, padded_h: int) -> Frame:
    """Pad to SB multiple by edge replication (reference: PadPicture...,
    ``EbPictureAnalysisProcess.c``)."""
    def pad(plane, pw, ph):
        h, w = plane.shape
        if (h, w) == (ph, pw):
            return plane
        return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
    return Frame(
        y=pad(frame.y, padded_w, padded_h),
        u=pad(frame.u, padded_w // 2, padded_h // 2),
        v=pad(frame.v, padded_w // 2, padded_h // 2),
    )
