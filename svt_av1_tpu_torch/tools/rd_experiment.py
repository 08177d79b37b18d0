#!/usr/bin/env python
"""RD operating-point experiment of the port vs the locally-built
reference encoder (the twin of the JAX package's
``tools/rd_experiment.py``).

Encodes one shared synthetic clip (the BASELINE.md moving-texture family)
with (a) the reference SvtAv1EncApp at a QP ladder and (b) the port's
encoder at the same ladder under different lambda scalings / AQ settings,
printing bytes + mean Y-PSNR for each point so RD curves can be compared
at matched rate. The reference path shells out to the same binary as the
JAX tool.

Usage: python -m svt_av1_tpu_torch.tools.rd_experiment
       [--ref-only|--ours-only] [--w 640] [--h 360] [--n 8]
       [--qps 25,35,45,55] [--scales 1,4,10,18] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import numpy as np

from svt_av1_tpu_torch.utils.clip import make_clip

REF_APP = "/tmp/svtref/Bin/Release/SvtAv1EncApp"


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 * 255.0 / mse)


def run_reference(frames, w, h, qp, tmpdir, intra_period="0"):
    raw = os.path.join(tmpdir, "in.yuv")
    with open(raw, "wb") as f:
        for (y, u, v) in frames:
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())
    out = os.path.join(tmpdir, f"ref_q{qp}.ivf")
    rec = os.path.join(tmpdir, f"ref_q{qp}.rec")
    cmd = [REF_APP, "-i", raw, "-w", str(w), "-h", str(h),
           "-q", str(qp), "-b", out, "-o", rec,
           "-intra-period", intra_period, "-n", str(len(frames))]
    subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    nbytes = os.path.getsize(out)
    # recon PSNR from the recon file (same yuv420 layout)
    fsz = w * h * 3 // 2
    ps = []
    with open(rec, "rb") as f:
        data = f.read()
    nfr = min(len(frames), len(data) // fsz)
    for i in range(nfr):
        ry = np.frombuffer(data[i * fsz:i * fsz + w * h],
                           dtype=np.uint8).reshape(h, w)
        ps.append(psnr(frames[i][0], ry))
    return nbytes, float(np.mean(ps)), nfr


def run_ours(frames, w, h, qp, lam_scale, aq, intra_period=0, hier=0,
             device="cuda"):
    # pipeline/rd.rd_lambda reads the scale at every call
    os.environ["SVT_TPU_LAMBDA_SCALE"] = str(lam_scale)
    from svt_av1_tpu_torch.config import EncoderConfig
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    # partition RD (fixed_partition_size=None), as the CLI presets
    cfg = EncoderConfig(width=w, height=h, qp=qp, device=device,
                        intra_period=intra_period,
                        hierarchical_levels=hier,
                        fixed_partition_size=None,
                        adaptive_quantization=1 if aq else 0,
                        scene_change_detection=False)
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
    total = sum(len(t) for t, _ in outs)
    ps = []
    shown = 0
    for tu, disp in outs:
        if disp is None:
            continue
        ps.append(psnr(frames[shown][0], disp[0]))
        shown += 1
    return total, float(np.mean(ps)), dt


def bd_rate(rate_a, psnr_a, rate_b, psnr_b) -> float:
    """Bjontegaard delta-rate (%) of curve B vs anchor A: average
    log-rate gap over the overlapping PSNR range via cubic log-rate
    fits (the standard BD-RATE metric; negative = B needs fewer bits
    at matched quality)."""
    ra = np.log(np.asarray(rate_a, dtype=np.float64))
    rb = np.log(np.asarray(rate_b, dtype=np.float64))
    pa = np.asarray(psnr_a, dtype=np.float64)
    pb = np.asarray(psnr_b, dtype=np.float64)
    ia, ib = np.argsort(pa), np.argsort(pb)
    pa, ra, pb, rb = pa[ia], ra[ia], pb[ib], rb[ib]
    fa = np.polyfit(pa, ra, min(3, len(pa) - 1))
    fb = np.polyfit(pb, rb, min(3, len(pb) - 1))
    lo = max(pa.min(), pb.min())
    hi = min(pa.max(), pb.max())
    if hi <= lo:
        return float("nan")
    xs = np.linspace(lo, hi, 100)
    avg = np.mean(np.polyval(fb, xs) - np.polyval(fa, xs))
    return float((np.exp(avg) - 1.0) * 100.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-only", action="store_true")
    ap.add_argument("--ours-only", action="store_true")
    ap.add_argument("--bd", action="store_true",
                    help="run the reference + ours at the qp ladder and "
                    "print BD-RATE (PSNR) of ours vs the reference")
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--h", dest="hh", type=int, default=360)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--qps", default="25,35,45,55")
    ap.add_argument("--scales", default="1,4,10,18")
    ap.add_argument("--aq", default="0,1")
    ap.add_argument("--intra-period", default="0")
    ap.add_argument("--hier", type=int, default=0)
    ap.add_argument("--natural", action="store_true",
                    help="use the real-photograph clip (utils/natural.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    qps = [int(q) for q in args.qps.split(",")]
    scales = [float(s) for s in args.scales.split(",")]
    aqs = [int(a) for a in args.aq.split(",")]
    if args.natural:
        from svt_av1_tpu_torch.utils import natural
        assert natural.available(), "natural-content asset missing"
        frames = natural.natural_clip(args.w, args.hh, args.n)
    else:
        frames = make_clip(args.w, args.hh, frames=args.n)
    tmpdir = os.path.join(tempfile.gettempdir(), "rdexp")
    os.makedirs(tmpdir, exist_ok=True)

    if args.bd:
        assert os.path.exists(REF_APP), "reference binary missing"
        ref_r, ref_p, our_r, our_p = [], [], [], []
        for qp in qps:
            b, p, nfr = run_reference(frames, args.w, args.hh, qp,
                                      tmpdir, args.intra_period)
            ref_r.append(b)
            ref_p.append(p)
            print(f"REF   q={qp:2d} bytes={b:9d} ypsnr={p:6.2f}",
                  flush=True)
        for qp in qps:
            b, p, dt = run_ours(frames, args.w, args.hh, qp, scales[0],
                                aqs[0], int(args.intra_period), args.hier,
                                args.device)
            our_r.append(b)
            our_p.append(p)
            print(f"OURS  q={qp:2d} bytes={b:9d} ypsnr={p:6.2f} "
                  f"({dt:5.1f}s)", flush=True)
        bd = bd_rate(ref_r, ref_p, our_r, our_p)
        print(f"BD-RATE (PSNR) ours vs reference: {bd:+.2f}%  "
              f"(negative = ours cheaper at matched quality)")
        return

    if not args.ours_only and os.path.exists(REF_APP):
        for qp in qps:
            b, p, nfr = run_reference(frames, args.w, args.hh, qp, tmpdir,
                                      args.intra_period)
            print(f"REF   q={qp:2d}              bytes={b:9d} "
                  f"ypsnr={p:6.2f} ({nfr} fr)", flush=True)
    if args.ref_only:
        return
    for aq in aqs:
        for sc in scales:
            for qp in qps:
                b, p, dt = run_ours(frames, args.w, args.hh, qp, sc, aq,
                                    int(args.intra_period), args.hier,
                                    args.device)
                print(f"OURS  q={qp:2d} lam x{sc:<5g} aq={aq} "
                      f"bytes={b:9d} ypsnr={p:6.2f} ({dt:5.1f}s)",
                      flush=True)


if __name__ == "__main__":
    main()
