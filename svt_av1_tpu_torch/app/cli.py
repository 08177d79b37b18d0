"""Encoder CLI of the port — the JAX package's ``app/cli.py`` on torch.

Mirrors the reference app's main tokens (``EbAppConfig.c:266`` config_entry
table): -i input (yuv/y4m/stdin), -b output IVF, -w/-h2, -q, -n frames,
--intra-period, --preset, -o recon yuv, -c config file, --nch channels,
--jobs parallel GOPs. Prints per-frame and summary stats like the
reference's stat_report path. Every option and config-file token is the
JAX CLI's, except the compute selector: ``--device`` (token ``device``,
default ``cuda``) in the place of ``--backend``. Without a card, the
default raises; ``--device cpu`` runs the plain PyTorch versions.

The preset ladder (``preset_config``) is the JAX package's, unchanged.
Every preset encodes all-intra and with inter frames on the device;
presets 0 and 1 with CDEF (and preset 0 with loop restoration) and, in
inter frames, the interpolation-filter search (and preset 0's inter
tx-type search) on the non-fused inter path.

Usage:
  python -m svt_av1_tpu_torch.app -i in.y4m -b out.ivf -q 40
  python -m svt_av1_tpu_torch.app -i in.yuv -w 854 -h2 480 -b out.ivf
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from svt_av1_tpu_torch.bitstream.ivf import (patch_ivf_frame_count,
                                             write_ivf_frame,
                                             write_ivf_header)
from svt_av1_tpu_torch.config import EncoderConfig, RateControlMode
from svt_av1_tpu_torch.utils import yuv
from svt_av1_tpu_torch.utils.stats import StatReport

# the encoder CLI's option defaults (``-w``/``-h`` have none that encodes)
CLI_DEFAULTS = dict(width=0, height=0, qp=40, bit_depth=8, intra_period=-1,
                    fps=30, film_grain=0, enable_denoise=False, preset=2,
                    hierarchical_levels=0, tbr=0, lad=0, tile_columns=None,
                    tile_rows=None, qp_file=None, device="cuda")


def preset_config(**options) -> EncoderConfig:
    """Map the preset scale onto mode-decision budgets (the analogue of
    the reference's signal_derivation_*_oq feature levels).

    ``options``: the CLI's option names as keywords, over CLI_DEFAULTS,
    e.g. ``preset_config(width=1920, height=1080, preset=5,
    intra_period=0)``."""
    unknown = set(options) - set(CLI_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown options {sorted(unknown)}")
    a = {**CLI_DEFAULTS, **options}
    kw = dict(width=a["width"], height=a["height"], qp=a["qp"],
              bit_depth=a["bit_depth"], intra_period=a["intra_period"],
              frame_rate_num=a["fps"],
              film_grain_strength=a["film_grain"],
              enable_source_denoise=a["enable_denoise"])
    preset = a["preset"]
    if preset <= 0:       # M0: full tools
        kw.update(fixed_partition_size=None, nfl=4,
                  angle_deltas=(-3, -2, -1, 0, 1, 2, 3),
                  enable_cdef=True, enable_restoration=True,
                  enable_tx_type_search=True,
                  enable_interp_filter_search=True)
    elif preset == 1:     # M1
        kw.update(fixed_partition_size=None, nfl=3,
                  angle_deltas=(-2, 0, 2), enable_cdef=True,
                  enable_interp_filter_search=True)
    elif preset == 2:     # M2
        kw.update(fixed_partition_size=None, nfl=2, angle_deltas=(0,))
    # M3+ keep partition RD at every preset — like the reference's
    # signal_derivation ladder (EbModeDecisionConfigurationProcess.c:926)
    # the budget shrinks (depth window, NFL, candidate counts, rect arms)
    # instead of pinning a fixed grid
    elif preset == 3:     # M3
        kw.update(fixed_partition_size=None, min_partition_size=8,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0, 1, 2, 9, 12))
    elif preset == 4:     # M4
        kw.update(fixed_partition_size=None, min_partition_size=16,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0, 1, 2, 12))
    elif preset == 5:     # M5
        kw.update(fixed_partition_size=None, min_partition_size=16,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0, 1, 2, 12),
                  enable_rect_partitions=False)
    elif preset == 6:     # M6
        kw.update(fixed_partition_size=None, min_partition_size=32,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0, 1, 2), enable_rect_partitions=False)
    elif preset == 7:     # M7
        kw.update(fixed_partition_size=None, min_partition_size=32,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0,), enable_rect_partitions=False,
                  scene_change_detection=False)
    else:                 # M8: fastest
        kw.update(fixed_partition_size=None, min_partition_size=32,
                  max_partition_size=64, nfl=1, angle_deltas=(0,),
                  intra_modes=(0,), enable_rect_partitions=False,
                  enable_dlf=False, scene_change_detection=False)
    # tile columns by resolution (the reference's segment fan-out): cuts
    # the wavefront scan critical path and parallelizes host entropy;
    # explicit tile_columns/tile_rows override
    tc, tr = a["tile_columns"], a["tile_rows"]
    if tc is None:
        tc = 2 if a["width"] >= 1920 else (1 if a["width"] >= 1280 else 0)
    kw.update(tile_cols_log2=tc, tile_rows_log2=tr or 0)
    if a["hierarchical_levels"]:
        kw.update(hierarchical_levels=a["hierarchical_levels"])
    if a["tbr"]:
        kw.update(rate_control_mode=RateControlMode.VBR,
                  target_bit_rate=a["tbr"], look_ahead_distance=a["lad"])
    kw.update(device=a["device"])
    if a["qp_file"]:
        with open(a["qp_file"]) as fh:
            kw.update(qp_file=tuple(
                int(line.split()[0]) for line in fh if line.strip()))
    return EncoderConfig(**kw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="svt_av1_tpu_torch", add_help=True,
        description="AV1 encoder on PyTorch/CUDA (SvtAv1EncApp-compatible "
                    "core options)")
    p.add_argument("-i", "--input", required=True,
                   help="input file (.y4m or raw .yuv; '-' = stdin y4m)")
    p.add_argument("-b", "--output", required=True,
                   help="output IVF file ('-' = stdout)")
    p.add_argument("-w", "--width", type=int, default=0)
    p.add_argument("-h2", "--height", type=int, default=0,
                   dest="height")
    p.add_argument("-q", "--qp", type=int, default=40)
    p.add_argument("-n", "--frames", type=int, default=0,
                   help="max frames (0 = all)")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--intra-period", type=int, default=-1)
    p.add_argument("--preset", type=int, default=2,
                   help="0 = highest quality .. 8 = fastest "
                        "(reference enc_mode M0-M8 scale)")
    p.add_argument("--hierarchical-levels", type=int, default=0,
                   help="mini-GOP pyramid depth 0..5 (0 = low delay)")
    p.add_argument("--lad", type=int, default=0,
                   help="look-ahead distance (VBR weighting window)")
    p.add_argument("--tbr", type=int, default=0,
                   help="target bit rate (bits/s; enables VBR)")
    p.add_argument("--bit-depth", type=int, default=8, choices=(8, 10))
    p.add_argument("-o", "--recon", default=None,
                   help="write reconstruction to this yuv file")
    p.add_argument("--no-stats", action="store_true")
    p.add_argument("--film-grain", type=int, default=0, metavar="LEVEL",
                   help="film grain synthesis strength 0..64 (0 = off, "
                        "-1 = auto-estimate from source noise)")
    p.add_argument("--enable-denoise", action="store_true",
                   help="noise-classified source denoising before encode "
                        "(reference -enable-denoise-flag)")
    p.add_argument("--jobs", type=int, default=1,
                   help="parallel GOP workers (closed GOPs + CQP only; "
                        "reads the whole input into memory; the workers "
                        "share the one device)")
    p.add_argument("--trace", default=None, metavar="JSON",
                   help="write per-stage timing spans and the process's "
                        "kernel launch counts to this file")
    p.add_argument("--nch", type=int, default=1,
                   help="independent encoder channels; -i/-b take "
                        "comma-separated lists (reference EbAppMain -nch)")
    p.add_argument("--device", default=CLI_DEFAULTS["device"],
                   help="torch device of the pixel path: 'cuda' (the "
                        "default; raises without a card), 'cuda:N', or "
                        "'cpu' for the plain PyTorch versions "
                        "(byte-identical output)")
    p.add_argument("-c", "--config", default=None, metavar="FILE",
                   help="config file with 'Token : value' lines using "
                        "the reference app's token names (EbAppConfig.c "
                        "config_entry); command-line options win")
    p.add_argument("--tile-columns", type=int, default=None,
                   metavar="LOG2", help="tile columns log2 (default: "
                   "by resolution — 4 cols at >=1080p, 2 at >=720p; "
                   "reference --tile-columns)")
    p.add_argument("--tile-rows", type=int, default=None, metavar="LOG2")
    p.add_argument("--qp-file", default=None, metavar="FILE",
                   help="per-frame qp overrides, one integer per line "
                        "(-1 keeps the configured qp); CQP only "
                        "(reference --use-q-file)")
    return p


# reference config-file tokens (EbAppConfig.c:266 config_entry) -> our
# long-option names; unknown tokens fail loudly like the reference app
CFG_TOKENS = {
    "inputfile": "-i", "streamfile": "-b", "outputfile": "-b",
    "sourcewidth": "-w", "sourceheight": "-h2", "qp": "-q",
    "encodermode": "--preset", "intraperiod": "--intra-period",
    "framerate": "--fps", "frametobeencoded": "-n",
    "hierarchicallevels": "--hierarchical-levels",
    "targetbitrate": "--tbr", "lookaheaddistance": "--lad",
    "encoderbitdepth": "--bit-depth", "filmgrain": "--film-grain",
    "reconfile": "-o", "device": "--device", "qpfile": "--qp-file",
    "channelnumber": "--nch",
}


def load_config_file(path: str) -> list:
    """Parse a reference-style cfg file into argv tokens (prepended so
    explicit command-line options override them)."""
    tokens = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            for sep in (":", "="):
                if sep in line:
                    key, val = line.split(sep, 1)
                    break
            else:
                raise ValueError(f"{path}:{ln}: expected 'Token : value'")
            key = key.strip().replace("_", "").replace("-", "").lower()
            if key not in CFG_TOKENS:
                raise ValueError(f"{path}:{ln}: unknown token {key!r}")
            tokens += [CFG_TOKENS[key], val.strip()]
    return tokens


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in ("-c", "--config"):
        if flag in argv:
            i = argv.index(flag)
            argv = load_config_file(argv[i + 1]) + argv[:i] + argv[i + 2:]
            break
    args = build_parser().parse_args(argv)
    if args.nch > 1:
        # multi-instance channels (reference EbAppMain.c:82-230): fully
        # independent encoder instances running CONCURRENTLY, a thread
        # per channel, all on the one device (stdin is not a legal
        # multi-channel input)
        inputs = args.input.split(",")
        outputs = args.output.split(",")
        if not len(inputs) == len(outputs) == args.nch:
            raise ValueError("--nch requires matching comma-separated -i "
                             "and -b lists")
        if "-" in inputs:
            raise ValueError("--nch channels cannot read stdin")
        chans = []
        for i, (inp, outp) in enumerate(zip(inputs, outputs)):
            ch = copy.copy(args)
            ch.input, ch.output, ch.nch = inp, outp, 1
            if not args.no_stats:
                print(f"--- channel {i}: {inp} -> {outp}")
            chans.append(ch)
        with ThreadPoolExecutor(max_workers=args.nch,
                                thread_name_prefix="channel") as pool:
            rcs = list(pool.map(main_single, chans))
        rc = 0
        for r in rcs:
            rc |= r
        return rc
    return main_single(args)


def main_single(args) -> int:
    from svt_av1_tpu_torch.pipeline import parallel
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    from svt_av1_tpu_torch.utils.trace import TRACER
    if args.trace:
        TRACER.enabled = True
        TRACER.reset()
    # open input
    if args.input == "-" or args.input.endswith(".y4m"):
        fh = sys.stdin.buffer if args.input == "-" else open(args.input,
                                                             "rb")
        info, frames = yuv.read_y4m(fh,
                                    args.frames if args.frames else None)
        args.width, args.height = info["width"], info["height"]
        args.bit_depth = info["bit_depth"]
        args.fps = info["fps_num"]
        fps_den = info["fps_den"]
    else:
        if not args.width or not args.height:
            print("raw yuv input requires -w/-h2", file=sys.stderr)
            return 2
        fh = open(args.input, "rb")
        frames = yuv.read_yuv_frames(fh, args.width, args.height,
                                     args.bit_depth,
                                     args.frames if args.frames else None)
        fps_den = 1

    cfg = preset_config(**{k: getattr(args, k) for k in CLI_DEFAULTS})
    if args.jobs > 1 and not parallel.parallelizable(cfg):
        print("--jobs needs --intra-period >= 0, CQP, and no scene "
              "detection; falling back to 1", file=sys.stderr)
        args.jobs = 1
    enc = Encoder(cfg)
    report = StatReport()
    to_stdout = args.output == "-"
    log = sys.stderr if to_stdout else sys.stdout
    n = 0          # packet counter (decode order)
    shown = 0      # display counter
    srcs = []      # sources in display order, for stats

    def drain(out, recon_fh):
        nonlocal n, shown
        while True:
            pkt = enc.get_packet()
            if pkt is None:
                return
            tu, recon = pkt
            write_ivf_frame(out, tu, n)
            if recon is not None:
                src = srcs[shown]
                ftype = "KEY" if shown == 0 or (
                    cfg.intra_period >= 0 and (
                        cfg.intra_period == 0
                        or shown % (cfg.intra_period + 1) == 0)) else "INT"
                report.add(shown, ftype, len(tu), (src.y, src.u, src.v),
                           recon, cfg.bit_depth)
                if recon_fh is not None:
                    yuv.write_yuv_frame(recon_fh, yuv.Frame(*recon))
                if not args.no_stats:
                    f = report.frames[-1]
                    print(f"frame {shown:4d} {ftype:3s} {f.bytes:7d} B  "
                          f"Y {f.psnr_y:6.2f}  U {f.psnr_u:6.2f}  "
                          f"V {f.psnr_v:6.2f} dB", file=log)
                shown += 1
            n += 1

    t0 = time.perf_counter()
    out_cm = contextlib.nullcontext(sys.stdout.buffer) if to_stdout \
        else open(args.output, "wb")
    recon_cm = open(args.recon, "wb") if args.recon \
        else contextlib.nullcontext()
    with fh if fh is not sys.stdin.buffer else contextlib.nullcontext(), \
            out_cm as out, recon_cm as recon_fh:
        write_ivf_header(out, cfg.width, cfg.height, args.fps, fps_den,
                         args.frames or 0)
        if args.jobs > 1:
            all_frames = list(frames)
            srcs.extend(all_frames)
            pkts = parallel.encode_parallel(
                [(f.y, f.u, f.v) for f in all_frames], cfg, args.jobs)
            enc._out.extend(pkts)
            drain(out, recon_fh)
        else:
            for frame in frames:
                srcs.append(frame)
                enc.send_picture(frame.y, frame.u, frame.v)
                drain(out, recon_fh)
            enc.flush()
            drain(out, recon_fh)
        if not to_stdout:
            patch_ivf_frame_count(out, n)  # pipes aren't seekable
        else:
            out.flush()
    dt = time.perf_counter() - t0
    if args.trace:
        # the process's hand-kernel launches beside the spans: per mode,
        # and per (mode, rows, row length, log_scale)
        from svt_av1_tpu_torch.ops import device as dev
        shapes = sorted(dev.LAUNCH_SHAPES.items())
        TRACER.dump(args.trace, kernel_launches=dict(dev.LAUNCHES),
                    kernel_launch_shapes=[[*k, v] for k, v in shapes])
        if not args.no_stats:
            print(f"trace: {TRACER.summary()}", file=log)
    s = report.summary(args.fps, fps_den)
    if s and not args.no_stats:
        print(f"\n{s['frames']} frames, {s['total_bytes']} bytes, "
              f"{s['kbps']:.1f} kbps, "
              f"PSNR Y {s['avg_psnr_y']:.2f} U {s['avg_psnr_u']:.2f} "
              f"V {s['avg_psnr_v']:.2f} dB, "
              f"{n / dt:.2f} fps encode speed", file=log)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
