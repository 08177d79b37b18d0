"""Decoder CLI: IVF (this encoder's streams) -> raw YUV / y4m.

The port's mirror decoder (``pipeline/decode.py``) as a tool: it needs
no external AV1 decoder, no GPU and no JAX (SURVEY.md §4).

Usage: python -m svt_av1_tpu_torch.app.decode_cli in.ivf out.yuv
"""

from __future__ import annotations

import argparse
import sys

from svt_av1_tpu_torch.pipeline.decode import StreamDecoder
from svt_av1_tpu_torch.bitstream.ivf import read_ivf
from svt_av1_tpu_torch.utils import yuv


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="svt_av1_tpu_torch.decode")
    p.add_argument("input", help="IVF file")
    p.add_argument("output", help="raw planar YUV output")
    args = p.parse_args(argv)
    dec = StreamDecoder()
    n = 0
    with open(args.input, "rb") as f, open(args.output, "wb") as out:
        info, frames = read_ivf(f)
        for _, payload in frames:
            recon = dec.decode_tu(payload)
            if recon is not None:
                yuv.write_yuv_frame(out, yuv.Frame(*recon))
                n += 1
    print(f"decoded {n} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
