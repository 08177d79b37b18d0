#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``svt_av1_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero (no phase is caught):

1. environment: the card's name and power limit, its int32 instruction
   rate (SMs x 64 INT32 lanes x the maximum SM clock), torch/CUDA/nvcc
   versions, whether triton imports;
2. build: every hand-written CUDA kernel from the checkout's sources,
   and, as a diagnostic, the integer SASS instructions of each kernel
   instantiation (``cuobjdump -sass``);
3. the quantization kernel in its three modes — quantize-only
   (``quantize_qv``), fused quantize + rate and quantize + RDOQ-lite trim
   + rate (``quant_stage_j``) — against its plain PyTorch versions on the
   card, exact, over every row length the full loop makes (16 to 1024,
   the rectangles' 32, 128 and 512 included), log_scales, plane types,
   RDOQ on/off, batch sizes and bit depths 8 and 10, and at the most rows
   a 1080p and a 4K shape group can give it (B = 16320 and 65280 rows
   of n = 256 and of n = 64), with times beside the bound;
4. the first slice's main path through the user entry point: a one-frame
   1920x1080 8-bit all-intra stream (preset 5, qp 40) through
   ``encode_ivf`` on ``cuda``, whose sha256 must equal the JAX package's
   stream of the same clip (``GOLDEN_*``), whose run must have launched
   the fused kernel, and in which the plain trim and rate must not have
   run. Every key frame (here and in 5) must run the fused frame-batched
   tile program (``device_tile.run_tiles_fused``) once over its 4 tiles,
   launching the kernel inside it, and the per-wave loop
   (``_code_wave``) never; per key frame its compute span, the
   ``intra_tiles_fused`` span, the program's wave and class steps and
   the kernel's launches and shapes inside it are printed;
5. ``[inter]``, the operating point of ``bench.py``: 9 frames of
   1920x1080 random access (one key frame, then a mini-GOP of 8 inter
   frames as a 3-level hierarchical-B pyramid with compound prediction,
   TMVP and the intra-flip pass; preset 5, qp 40, 4 tile columns)
   through ``encode_ivf`` on ``cuda``, whose sha256 must equal the JAX
   package's (``GOLDEN_RA_*``); the fused kernel must have been launched
   inside the inter frames and the plain trim and rate never; seconds
   per frame of the key frame and of the inter frames, the stage spans,
   the flipped blocks, the kernel's launches and shapes inside the inter
   frames, and the largest shape group under torch.profiler;
6. ``[directional]``, preset 2 (the CLI default): one 1920x1080 key
   frame through ``encode_ivf`` on ``cuda``, all 13 intra modes with the
   normative intra edge filter, so the key frame runs the per-wave loop
   (``_code_wave``) with per-lane filt_type and never the frame program;
   its sha256 must equal the JAX package's (``GOLDEN_DIR_*``), and the
   edge-filtered predictor and the fused kernel must have run; the key
   frame's time, the spans, the wave and (wave, shape) counts and the
   kernel's launches by mode and row length are printed;
7. ``[postfilter]``, the in-loop post-filters: the random-access clip of
   5 again with CDEF and loop restoration turned on (the two filters of
   preset 0 on the library's ``EncoderConfig``), through ``encode_ivf``
   on ``cuda``, whose sha256 must equal the JAX package's
   (``GOLDEN_PF_*``), with spans ``cdef`` and ``lr`` once on each of the
   9 frames; the total, key-frame and inter times, per frame the two
   spans, the CDEF strengths chosen and the LR frame types per plane,
   and one inter frame's CDEF + LR replayed under torch.profiler for the
   card's busy share;
8. ``[search]``, the non-fused inter path: the random-access clip of 5
   again with the interpolation-filter search and the inter tx-type
   sweep turned on (preset 0's two inter searches on the library's
   ``EncoderConfig``), through ``encode_ivf`` on ``cuda``, whose sha256
   must equal the JAX package's (``GOLDEN_SEARCH_*``); spans
   ``interp_filter_search`` and ``inter_tx_search`` must run on every
   shape group (span ``me_rd``) of each of the 8 inter frames, the fused
   kernel inside them and the plain trim and rate never; the total,
   key-frame and inter times, per inter frame the stage spans, the
   blocks per filter type and the tx-type histogram, and the largest
   shape group's stages replayed under torch.profiler;
9. ``[aq]``, the rate and analysis slice's adaptive quantization: the
   random-access clip of 5 again with variance AQ and SATD partition
   scoring (``adaptive_quantization=1, intra_dp_satd=True``), through
   ``encode_ivf`` on ``cuda``, whose sha256 must equal the JAX package's
   (``GOLDEN_AQ_*``); the key frame must run the per-wave loop
   (``_code_wave``) and never the frame program, the SATD twin must run
   in its partition DP on the card (its largest issue is then held
   against the CPU run), every frame must code SBs off its base qindex
   and the fused kernel must be launched with rows of differing qindex
   in the key frame and in the inter frames (a spy on ``qv``); per frame
   its qindex, the SBs off it and the kernel launches, the spans;
10. ``[rc]``: the same clip with TPL AQ, VBR at 6 Mb/s with a lookahead
   of 8 frames, film grain (strength 10) and source denoising, whose
   sha256 must equal the JAX package's (``GOLDEN_RC_*``); the
   controller's qindex must vary over the frames, every frame header must
   carry the grain parameters and the key frame must run the frame
   program; per frame its qindex and the SBs with a TPL delta;
11. ``[entry]``, the analysis entry steps: ``entry.entry()`` (64 blocks
   of 16x16), ``intra_analysis_step`` over the 8160 16x16 luma blocks of
   the clip's frame 0 (padded to 1088 rows, edges from the source),
   ``inter_core_step`` and ``inter_core_subpel_step`` of frame 1 against
   frame 0 (size 16, search range 16), each equal to its CPU run exactly,
   each launching the kernel's quantize-only mode and never the plain
   quantizer; times and launches;
12. ``[app]``, the entry points a user runs: the CLI (``python -m
   svt_av1_tpu_torch.app``, a subprocess with no ``--device``) on the
   random-access clip as a 30:1 y4m, whose stream must equal
   ``GOLDEN_RA_*`` and whose recon file the port's own mirror decoder
   must reproduce frame by frame; the port's independent checker over
   the stream's TUs up to the first with a compound block (the whole
   stream would take minutes of host NumPy); the EbApi lifecycle
   (``api.eb_*``) on the one-frame clip, whose packets as IVF must equal
   ``GOLDEN_*``, and the checker over that key frame; the warmup tool at
   1080p for 2 frames;
13. ``[multichip]``, the multi-device slice (``parallel/tiles.py``) on
   ``["cuda:0"] * 4`` at 2048x1080 (DCI 2K: preset 5's 4 tile columns
   are equal there): the tile-sharded key frame (8-px leaves, one tile
   program per device, the halo ring, the summed stats), whose TU must
   equal the JAX package's (``GOLDEN_MC_KEY_*``) with every tile program
   launching the kernel; 3 frames (key, then a compound B) through
   ``encode_ivf`` with every shape group fanned out over 4 column strips,
   whose stream must equal the JAX package's (``GOLDEN_MC_INTER_*``) with
   every strip launching the kernel; the distributed DLF on the key
   frame's recon, equal to ``dlf_search_apply_dev``
   on the card; the plain quantizer never runs. Seconds per check, per
   tile program and per inter frame (beside ``[inter]``'s unsharded
   s/frame), launches per tile and per strip;
14. ``[baseline]``, the four BASELINE.md operating points no phase
   above runs, each through ``encode_ivf`` on ``cuda`` against the JAX
   package's stream (``BASELINE``, ``GOLDEN_HIRES4K_*``,
   ``GOLDEN_VBR10_*``, ``GOLDEN_AI480_*``, ``GOLDEN_LDP720_*``): 2
   frames of 3840x2160 10-bit (key + P, 4 tile columns), 6 frames of
   1920x1080 10-bit VBR (tbr 3000, lookahead 17, hier 3), 2 all-intra
   frames of 848x480 (one tile: the tile's own program) and 3 LD-P
   frames of 1280x720 (2 tiles); each must match its golden's bytes and
   TU count, launch the fused kernel and never the plain trim or rate,
   and run every key frame in a fused program and never ``_code_wave``;
   the 4K stream must decode, by the port's mirror decoder, to the
   encoder's recon; per config the spans, s/frame (key and inter apart),
   launches by mode and row length and the peak device memory; then
   (``[kernel-4k]``) the kernel exact against its plain versions at the
   most rows the 4K run gave each mode, row length and log_scale;
15. each mode and row length timed at the heaviest shape the encodes
   and the phases above gave it; one wave of the per-wave path through
   ``decide_block_batch_dev``, one (step, shape) group of the
   directional key frame, the largest shape groups of ``[inter]`` and
   ``[search]`` and one inter frame's post-filters, each replayed under
   torch.profiler; the seconds each phase took (``[time]``);
16. a ``{"kernels": [...]}`` line, one entry per mode and row length
   (``launches``: the sum over the seven encodes, ``[entry]``, ``[app]``,
   ``[multichip]`` and ``[baseline]``; ``launches_by_path``: each one's
   own count, and the RA encode's inside its inter frames), the card's
   line, and last the device line.

Needs one CUDA device; without one it exits 2 and prints no result.
Details (per-shape times, stage spans, ptxas report) go to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import hashlib
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

# the JAX package's stream of the same input: svt_av1_tpu.pipeline.encoder.
# encode_ivf(backend="host") on make_clip(1920, 1080, frames=1, seed=3),
# preset 5, intra_period 0, qp 40
GOLDEN_SHA256 = \
    "37e9a555563504073baf0c83099ece5d0eed212fdc1e69d16109c2473452c3b7"
GOLDEN_BYTES = 389165
WIDTH, HEIGHT, FRAMES, QP, PRESET = 1920, 1080, 1, 40, 5
TILES = 4       # preset 5 at 1920 wide: 4 tile columns (app/cli.py)
# the JAX package's stream of bench.py's operating point: encode_ivf(
# backend="host") on make_clip(1920, 1080, frames=9, seed=3), preset 5,
# qp 40, intra_period -1, hierarchical_levels 3 (4 tile columns by width)
GOLDEN_RA_SHA256 = \
    "3f3f8896fd6341d88d0ab7231ee84b994c93834f2e6a7a808da2e634457e07a4"
GOLDEN_RA_BYTES = 415319
RA_FRAMES, RA_LEVELS = 9, 3
# the JAX package's stream of the directional preset: encode_ivf(backend=
# "host") on make_clip(1920, 1080, frames=1, seed=3), preset 2, qp 40,
# intra_period 0 (4 tile columns by width)
GOLDEN_DIR_SHA256 = \
    "29f15e2d04c26721ee4d6eed4a574dad929aa8ee31f26845bbad07badeb6de69"
GOLDEN_DIR_BYTES = 372813
DIR_PRESET = 2
# the JAX package's stream of the post-filter phase: encode_ivf(backend=
# "host") on make_clip(1920, 1080, frames=9, seed=3), preset 5, qp 40,
# intra_period -1, hierarchical_levels 3 (4 tile columns by width), with
# enable_cdef=True and enable_restoration=True
GOLDEN_PF_SHA256 = \
    "6d3f3695b5405f93708c34194e70ff2c5767b21e6b0ee51a3a4d7950b0e68986"
GOLDEN_PF_BYTES = 417146
# the JAX package's stream of the search phase: the post-filter phase's
# clip and config with enable_interp_filter_search=True and
# enable_tx_type_search=True (preset 0's two inter searches) in place of
# the two filters
GOLDEN_SEARCH_SHA256 = \
    "8ab84ce4383687aa86325cedfe2a81350d1b88023699c09c80aa8adc28818d85"
GOLDEN_SEARCH_BYTES = 426525
SEARCH_SPANS = ("me_rd", "compound", "interp_filter_search",
                "inter_tx_search")
# the JAX package's stream of the AQ phase: the random-access clip and
# config of [inter] with adaptive_quantization=1 (variance AQ) and
# intra_dp_satd=True (SATD partition scoring)
GOLDEN_AQ_SHA256 = \
    "deca178757e6816dd0e5124b6c9e8f1fbb2eb95838880169f372090ede85325a"
GOLDEN_AQ_BYTES = 419484
# the JAX package's stream of the rate-control phase: the same clip and
# config with adaptive_quantization=2 (TPL AQ), VBR at 6 Mb/s with a
# lookahead of 8 frames, film_grain_strength=10 and
# enable_source_denoise=True
GOLDEN_RC_SHA256 = \
    "2a987a17a54bd986d71f0eb323d48bf21532fd75dd1a1d0d8f1227ecfb97a1a9"
GOLDEN_RC_BYTES = 292529
RC_TARGET_BPS, RC_LOOKAHEAD, RC_GRAIN = 6_000_000, 8, 10
# [baseline]: the four BASELINE.md operating points no other phase runs.
# Each golden is the JAX package's stream of the same clip and options:
# encode_ivf(backend="host") with svt_av1_tpu.app.cli.preset_config
# (tests/torch_baseline_goldens.py computes them). Clips: "hires" is
# tools/smoke_hires.make_clip(w, h, frames, bit_depth), "bench" is
# utils/clip.make_clip(w, h, frames) (seed 3 both).
GOLDEN_HIRES4K_SHA256 = \
    "6f9db4d99a16e0386385c47208491cbc7fe7c9caf5c5d5dfd152752b3097575c"
GOLDEN_HIRES4K_BYTES, GOLDEN_HIRES4K_TUS = 1560782, 2
GOLDEN_VBR10_SHA256 = \
    "b64cf39c9514c30bff084d9ffd88cafd8d89a4c00a76458f9871dc315ef1d70a"
GOLDEN_VBR10_BYTES, GOLDEN_VBR10_TUS = 14536, 9
GOLDEN_AI480_SHA256 = \
    "2c367518db7d1176acf55f1fccda7c556936cca47336a5ae0a3e24eecc762965"
GOLDEN_AI480_BYTES, GOLDEN_AI480_TUS = 153374, 2
GOLDEN_LDP720_SHA256 = \
    "0bfb360e5be166ec29718ca8273b1a5d9b9dd4b534cc7a39b3dc8175a7940902"
GOLDEN_LDP720_BYTES, GOLDEN_LDP720_TUS = 178973, 3
# (name, clip, (w, h, frames[, bit depth]), preset_config options, key
# frame tiles, golden bytes, golden sha256, golden TUs). One tile runs the
# tile's own program (analyze_tile_fused[_mixed]); several run the frame
# program (run_tiles_fused).
BASELINE = (
    ("hires4k", "hires", (3840, 2160, 2, 10),
     dict(width=3840, height=2160, qp=40, bit_depth=10, preset=5,
          intra_period=-1), 4,
     GOLDEN_HIRES4K_BYTES, GOLDEN_HIRES4K_SHA256, GOLDEN_HIRES4K_TUS),
    ("vbr10", "hires", (1920, 1080, 6, 10),
     dict(width=1920, height=1080, qp=40, bit_depth=10, preset=5,
          intra_period=-1, hierarchical_levels=3, tbr=3000, lad=17), 4,
     GOLDEN_VBR10_BYTES, GOLDEN_VBR10_SHA256, GOLDEN_VBR10_TUS),
    ("ai480", "bench", (848, 480, 2),
     dict(width=848, height=480, qp=40, preset=5, intra_period=0), 1,
     GOLDEN_AI480_BYTES, GOLDEN_AI480_SHA256, GOLDEN_AI480_TUS),
    ("ldp720", "bench", (1280, 720, 3),
     dict(width=1280, height=720, qp=40, preset=5, intra_period=-1), 2,
     GOLDEN_LDP720_BYTES, GOLDEN_LDP720_SHA256, GOLDEN_LDP720_TUS),
)
# [multichip]: DCI 2K, where preset 5's 4 tile columns are 4 equal tiles
# of 8 superblocks (at 1920 wide they are 8, 8, 8 and 6, which the tile
# program refuses), on 4 shards of the one card
MC_WIDTH, MC_HEIGHT, MC_DEVICES = 2048, 1080, 4
# 8-px leaves: at 1080 rows the bottom row of 16-px leaves crosses the
# frame edge and splits to 8 px, so 16 px gives no uniform leaf map
MC_LEAF = 8
# the inter planes are bucket-padded to 2560 columns (common.bucket_dims),
# which 4 superblock-aligned strips of 640 tile
MC_STRIP_W = 640
MC_QINDEX = 160
# the JAX package's TU of the sharded key frame: svt_av1_tpu.pipeline.
# wavefront.encode_keyframe_wavefront with backend="host" on
# make_clip(2048, 1080, frames=1, seed=3), preset 5, qp 40, intra_period 0
# (4 tile columns by width) with fixed_partition_size=8
GOLDEN_MC_KEY_SHA256 = \
    "7378bd471f57ce52ca40175a7b921dca5ae5774e9f784c97d1a7d3e34287e701"
GOLDEN_MC_KEY_BYTES = 33456
# the JAX package's stream of the strip-sharded inter check: encode_ivf(
# backend="host") on make_clip(2048, 1080, frames=3, seed=3), preset 5,
# qp 40, intra_period -1, hierarchical_levels 1 (frame 1 a compound B)
GOLDEN_MC_INTER_SHA256 = \
    "7627ced4ddaa8244a900f8e7cddcd44e5b84440a34ad57052d1607fdf47be3f5"
GOLDEN_MC_INTER_BYTES = 423291
TOOL_SPANS = ("keyframe", "intra_partition_dp", "waves", "intra_tiles_fused",
              "inter_frame", "dlf", "entropy", "tpl", "denoise", "grain")
# synthetic large-batch checks at the most rows a 1080p and a 4K shape
# group can give the quantization stage: the [2B] single-ref pair of the
# 16x16 luma blocks (n = 256; 8160 at 1080p, 32640 on the 3840x2176
# bucket) and U+V of their 8x8 chroma. The partition DP picks large
# blocks, so the encodes' own launches stay far below.
INTER_BATCHES = ((256, 16320), (64, 16320), (256, 65280), (64, 65280))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (data sheet)
INT32_LANES_PER_SM = 64          # Hopper SM: 64 INT32 lanes (128 FP32)
OUT_DIR = "chiprun_out"
# The integer work the quantization stage needs, in 32-bit instructions
# (INT32 pipe, IMAD pipe), counted from its arithmetic (the formulas at
# the head of csrc/quant.cu), not from the kernel's code. A product
# takes one IMAD per 32-bit word of the result it needs: a 64-bit
# product of two 32-bit operands 2, of a 64-bit and a 32-bit one 3, of
# two 64-bit ones 4. A 64-bit add, shift, compare or select takes 2.
# Per coefficient, quantize: |c| 1, + round 1, clamp 2, * quant 1 IMAD
# (fits 32 bits), >> 16 and + tmp 2, * qshift 2 IMAD, >> 1, the zbin test
# and select 2, the sign test 1, q's negate and select 2, * dequant
# 2 IMAD, >> 1, dq's negate and select 2, the eob candidate's select and
# max 2.
OPS_QUANT = (17, 5)
# Per coefficient, rate: min(|q|, 255) 1, the LUT address 1, the 64-bit
# sum 2.
OPS_RATE = (4, 0)
# Per scan position up to and including the eob, in rows with qindex > 0
# (the trim reads nothing past the eob and skips lossless rows): the
# k < eob test 1, zeroing dd and dr 3, dq * dq 2 IMAD, * gq12 3 IMAD,
# >> 12 2, the two 64-bit suffix sums 4, ebits(e) 2, sufr + ebits(eob) -
# ebits(e) 2, lam/2 * t 4 IMAD, >> 8 2, sufd << 9 2, the subtraction 2,
# the e > eob select of 1 << 62 3, the first-minimum compare of
# (cost, index) 2 and its selects 3, zeroing q and dq past the new eob 3.
OPS_TRIM = (31, 9)
# SASS opcodes (before the first '.') of integer work, for the [build]
# diagnostic: the integer multiply-adds run on the FMA pipe, the rest on
# the INT32 (ALU) pipe
SASS_IMAD = {"IMAD", "IMUL"}
SASS_ALU = {"IADD3", "IADD", "ISETP", "IMNMX", "VIMNMX", "IABS", "LOP3",
            "LOP", "SHF", "SHL", "SHR", "SEL", "LEA", "PRMT", "POPC", "FLO",
            "BMSK", "BREV", "IDP", "ISCADD", "MOV", "I2I", "VABSDIFF"}


def _run(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"


def _max_sm_mhz() -> float:
    """The card's maximum SM clock in MHz, from nvidia-smi."""
    clk = _run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                "--format=csv,noheader,nounits"])
    try:
        return float(clk.splitlines()[0])
    except (ValueError, IndexError):
        raise SystemExit(f"cannot read the SM clock from nvidia-smi: {clk}")


def phase_environment(torch) -> dict:
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    sm_mhz = _max_sm_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_ops = sms * INT32_LANES_PER_SM * sm_mhz * 1e6
    from svt_av1_tpu_torch import cuda_build
    try:
        nvcc = _run([cuda_build.nvcc_path(), "--version"]).splitlines()[-1]
    except FileNotFoundError as e:
        nvcc = f"unavailable ({e})"
    try:
        import triton
        tri = f"triton {triton.__version__}"
    except ImportError as e:
        tri = f"triton unavailable ({e})"
    env = {"nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": nvcc, "triton": tri,
           "python": sys.version.split()[0], "sms": sms,
           "sm_clock_max_mhz": sm_mhz, "int32_ops_per_s": int32_ops}
    print(f"[env] {smi} | int32 rate {sms} SMs x {INT32_LANES_PER_SM} "
          f"lanes x {sm_mhz:.0f} MHz = {int32_ops / 1e12:.3f}e12 instr/s | "
          f"torch {env['torch']} cuda {env['cuda']} | {nvcc} | {tri}",
          flush=True)
    return env


def sass_counts(lib: Path) -> dict:
    """{(n, mode): [INT32-pipe, integer multiply-add, all instructions]}
    of each instantiation of csrc/quant.cu's kernel, from ``cuobjdump
    -sass``: static counts of the kernel's code (moves, shuffle scans,
    the argmin and branches a lane skips included), a diagnostic beside
    the function's own count in OPS_*; the bound does not use them."""
    from svt_av1_tpu_torch import cuda_build
    tool = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : \S*quant_stage_kernelILi(\d+)ELi(\d)E",
                      line)
        if m:
            cur = (int(m[1]), int(m[2]))
            counts[cur] = [0, 0, 0]
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9]*)", line)
        if m and cur is not None and m[1] != "NOP":
            counts[cur][0] += m[1] in SASS_ALU
            counts[cur][1] += m[1] in SASS_IMAD
            counts[cur][2] += 1
    want = 3 * len(_row_lengths())
    if len(counts) != want:
        raise SystemExit(f"expected {want} kernel instantiations in the "
                         f"SASS, found {sorted(counts)}")
    return counts


def phase_build() -> dict:
    from svt_av1_tpu_torch import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    dt = time.perf_counter() - t0
    sass = sass_counts(cuda_build.library_path("quant"))
    print(f"[build] {len(cuda_build.KERNELS)} kernel source(s), "
          f"{dt:.2f} s", flush=True)
    for (n, mode), (alu, imad, n_all) in sorted(sass.items()):
        print(f"[build] quant_stage_kernel<{n}, mode {mode}>: {alu} INT32 "
              f"+ {imad} IMAD of {n_all} SASS instructions per thread "
              f"({(alu + imad) / 4:.1f} integer per coefficient; "
              f"diagnostic, not the bound)", flush=True)
    return {"seconds": dt, "nvcc_output": logs,
            "sass": {f"n={n} mode={m}": v for (n, m), v in sass.items()}}


_SM_MHZ = []


def _keep_busy(torch, ms: float) -> None:
    """Enqueue a device-side sleep of at least ``ms`` milliseconds. The
    sleep counts SM cycles; they are taken at the card's maximum SM
    clock, so a lower clock only lengthens it (a rate calibrated while
    the clock was still low shortens it once the clock rises, and the
    card then waits for the host inside the timed window)."""
    if not _SM_MHZ:
        _SM_MHZ.append(_max_sm_mhz())
    torch.cuda._sleep(int(ms * _SM_MHZ[0] * 1e3))


def _time_ms(torch, fn, reps: int = 10, trials: int = 21):
    """(device ms, host ms) per call of fn(). Device: CUDA events around
    ``reps`` back-to-back calls queued behind a device-side sleep that
    outlasts their enqueue, so the card runs them without waiting for
    the host; the median over ``trials``. Host: wall time per call over
    ``reps`` calls with a synchronize at the end (what a caller that
    waits sees), the median of 5 such windows."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0) / reps)
    host_ms = statistics.median(host)
    dev = []
    for _ in range(trials):
        _keep_busy(torch, 2.0 * host_ms * reps + 1.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b) / reps)
    return statistics.median(dev), host_ms


def _row_lengths() -> tuple:
    from svt_av1_tpu_torch.ops import device as dev
    return dev.ROW_LENGTHS


def _stage_inputs(torch, n: int, ls: int, b: int, seed: int):
    """b rows of the quantization-stage check batch (the tail of a batch
    with every special row when b is small: all-zero, +-2^20, +-32767,
    INT32_MIN, DC-only, zero-lambda ties, lossless, qindex 255, a
    wrapping lambda) as CUDA tensors, with the scan and tx size."""
    from tests.torch_quant_cases import stage_rows
    coeff, qv, lam, scan, tx = stage_rows(n, ls, b, seed)
    c, q, lm = (torch.as_tensor(a, device="cuda") for a in (coeff, qv, lam))
    return c, q, lm, scan, tx


def _modes() -> dict:
    """{launch counter name: template argument MODE of csrc/quant.cu}."""
    from svt_av1_tpu_torch.ops import device as dev
    return {name: mode for mode, name in dev.MODE_NAMES.items()}


def _mode_fns(mode: str, c, q, lm, scan, tx, ls, plane_type=0, bd=8):
    """(kernel call, plain call) of one kernel mode on these inputs."""
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import device_md as tmd
    if mode == "quantize_qv":
        return (lambda: dev.quantize_qv(c, scan, q, ls, bd),
                lambda: dev.quantize_qv_plain(c, scan, q, ls, bd))
    rl = lm if mode == "quant_stage_rdoq" else None
    return (lambda: tmd.quant_stage_j(c, scan, q, ls, bd, tx, plane_type,
                                      rl),
            lambda: tmd.quant_stage_plain(c, scan, q, ls, bd, tx,
                                          plane_type, rl))


def _bound(mode: str, c, q, scan, ls: int, int32_ops: float, bd: int = 8):
    """(bound ms, "bytes" or "operations", (INT32, IMAD) instructions) of
    one call on these inputs. Bytes: 4 B read and 8 B written per
    coefficient; per row the qindex in and the eob out, plus the rate
    out (fused) and the lambda in (trim); the parameter table, inverse
    scan and, for the rate, the level-cost and eob-bits tables, once.
    Operations: OPS_* over the coefficients and, for the trim, over the
    scan positions this data's rows need; the INT32 pipe and the IMAD
    pipe each at the card's int32 rate, side by side."""
    from svt_av1_tpu_torch.ops import device as dev
    b, n = c.shape
    rate, trim = mode != "quantize_qv", mode == "quant_stage_rdoq"
    nbytes = b * n * 12 + b * (8 + 8 * rate + 8 * trim) + 16384 + 4 * n
    alu, imad = (b * n * k for k in OPS_QUANT)
    if rate:
        nbytes += 4096 + 4 * (n + 1)
        alu += b * n * OPS_RATE[0]
        imad += b * n * OPS_RATE[1]
    if trim:
        eob = dev.quantize_qv_plain(c, scan, q, ls, bd)[2].long()
        positions = int(((eob + 1) * (q > 0)).sum())
        alu += positions * OPS_TRIM[0]
        imad += positions * OPS_TRIM[1]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(alu, imad) / int32_ops
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations", (alu, imad)


def _check(torch, mode, c, q, lm, scan, tx, ls, plane_type=0,
           bd=8) -> dict:
    kern, plain = _mode_fns(mode, c, q, lm, scan, tx, ls, plane_type, bd)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    exact = all(g.dtype == w.dtype and torch.equal(g, w)
                for g, w in zip(got, want))
    return {"mode": mode, "B": len(q), "n": c.shape[1], "log_scale": ls,
            "plane_type": plane_type, "bd": bd, "exact": exact,
            "max_abs_err": err}


def _timed(torch, row, mode, c, q, lm, scan, tx, ls, int32_ops,
           plane_type=0, bd=8) -> dict:
    kern, plain = _mode_fns(mode, c, q, lm, scan, tx, ls, plane_type, bd)
    row["ms"], row["call_ms"] = _time_ms(torch, kern)
    row["plain_ms"], row["plain_call_ms"] = _time_ms(torch, plain)
    row["bound_ms"], row["bound_by"], row["int_instr"] = _bound(
        mode, c, q, scan, ls, int32_ops, bd)
    return row


def phase_kernels(torch, int32_ops: float) -> list:
    """Every (n, log_scale, B) of the check grid, each kernel mode (the
    fused ones with plane type 0 and 1) against its plain version, exact,
    at bit depths 8 and 10; each mode timed at log_scale 0 (the others
    change no work the kernel does) at B=8 (a typical wave) and B=8160
    (a 1080p frame's 16x16 blocks) at 8 bits, at B=8160 at 10 bits, and
    at the inter path's B=16320 batches."""
    rows = []
    for bd in (8, 10):
        for n in _row_lengths():
            for ls in (0, 1, 2):
                for b in (1, 8, 37, 8160):
                    ins = _stage_inputs(torch, n, ls, b,
                                        seed=n * 7 + ls * 3 + b + bd)
                    for mode in _modes():
                        for pt in ((0,) if mode == "quantize_qv"
                                   else (0, 1)):
                            row = _check(torch, mode, *ins, ls, pt, bd)
                            if not row["exact"]:
                                raise SystemExit(f"{mode} kernel != plain "
                                                 f"at {row}")
                            if pt == 0 and ls == 0 and (
                                    b == 8160 or (bd == 8 and b == 8)):
                                _timed(torch, row, mode, *ins, ls,
                                       int32_ops, bd=bd)
                            rows.append(row)
    for n, b in INTER_BATCHES:
        ins = _stage_inputs(torch, n, 0, b, seed=n + b)
        for mode in _modes():
            for pt in ((0,) if mode == "quantize_qv" else (0, 1)):
                row = _check(torch, mode, *ins, 0, pt)
                if not row["exact"]:
                    raise SystemExit(f"{mode} kernel != plain at {row}")
                if pt == 0:
                    _timed(torch, row, mode, *ins, 0, int32_ops)
                rows.append(row)
    for r in rows:
        if "ms" in r:
            print(f"[kernel] {r['mode']} B={r['B']} n={r['n']} "
                  f"ls={r['log_scale']} bd={r['bd']}: {r['ms']:.5f} ms "
                  f"(call {r['call_ms']:.4f} ms), plain "
                  f"{r['plain_ms']:.4f} ms (call {r['plain_call_ms']:.4f} "
                  f"ms), bound {r['bound_ms']:.5f} ms ({r['bound_by']}; "
                  f"{r['int_instr'][0]} INT32 + {r['int_instr'][1]} IMAD "
                  f"instr), {100 * r['bound_ms'] / r['ms']:.0f}% of bound",
                  flush=True)
    print(f"[kernel] quant_stage_kernel exact in every mode at all "
          f"{len(rows)} checks (row lengths {list(_row_lengths())}, bit "
          f"depths 8 and 10)", flush=True)
    return rows


def _keyframe_spies(keys):
    """Spies on the key frames' paths, recording into ``keys``: per key
    frame the fused frame program's tiles, steps and kernel launches
    (mode, B, n, log_scale) inside it and inside the whole key frame
    compute, and the per-wave loop's tiles, waves and (wave, shape)
    calls."""
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import device_tile as tdt
    from svt_av1_tpu_torch.pipeline import wavefront as twf
    keys.update(frames=[], code_wave=0, wave_tiles=0, wave_steps=0,
                waves=0, groups=[])

    def launches_in(fn, into):
        before = collections.Counter(dev.LAUNCH_SHAPES)
        out = fn()
        into.update(collections.Counter(dev.LAUNCH_SHAPES) - before)
        return out

    def compute_spy(fn):
        def call(self, *a, **k):
            rec = {"programs": [], "shapes": collections.Counter(),
                   "program_shapes": collections.Counter()}
            keys["frames"].append(rec)
            return launches_in(lambda: fn(self, *a, **k), rec["shapes"])
        return call

    def program_spy(fn):
        def call(enc, metas, *a):
            rec = keys["frames"][-1]
            out = launches_in(lambda: fn(enc, metas, *a),
                              rec["program_shapes"])
            rec["programs"].append(dict(enc.fused_stats))
            return out
        return call

    def wave_spy(fn):
        """Counts the per-wave loop's (step, shape) groups and keeps each
        group's lane count, shape and arguments for the profiled
        replay."""
        def call(self, parts, bw, bh, cands):
            keys["code_wave"] += 1
            keys["groups"].append((sum(len(ids) for _, ids in parts), bw,
                                   bh, (self, parts, bw, bh, cands)))
            return fn(self, parts, bw, bh, cands)
        return call

    def loop_spy(fn):
        """Per call of the per-wave loop: its tiles, its steps (the most
        waves of one tile) and the waves summed over the tiles."""
        def call(self, tiles, cands):
            per_tile = [int(t["waves"].max()) + 1 if len(t["waves"]) else 0
                        for t in tiles]
            keys["wave_tiles"] += len(tiles)
            keys["wave_steps"] += max(per_tile, default=0)
            keys["waves"] += sum(per_tile)
            return fn(self, tiles, cands)
        return call

    spies = [(twf.WavefrontIntraEncoder, "encode_compute", compute_spy),
             (twf.WavefrontIntraEncoder, "_code_wave", wave_spy),
             (twf.WavefrontIntraEncoder, "_wave_loop", loop_spy)]
    if hasattr(tdt, "run_tiles_fused"):    # a checkout before the program
        spies.append((tdt, "run_tiles_fused", program_spy))
    return spies


def _run_patched(patches, fn):
    """fn() with each (object, attribute, wrapper factory) of ``patches``
    patched in; the originals come back however fn ends."""
    saved = [(obj, nm, getattr(obj, nm)) for obj, nm, _ in patches]
    for (obj, nm, wrap), (_, _, orig) in zip(patches, saved):
        setattr(obj, nm, wrap(orig))
    try:
        return fn()
    finally:
        for obj, nm, orig in saved:
            setattr(obj, nm, orig)


def _encode_counted(torch, frames, cfg, spies=()):
    """encode_ivf on the card with the launch counters and spans set to 0
    just before and read just after; the plain trim and rate are counted
    too (the fused kernel replaces both on the main path). ``spies``:
    (object, attribute, wrapper factory) patched in for the run only;
    the key frames' spies always are (``_keyframe_spies``).
    Returns (ivf, seconds, launches, shapes, plain calls, spans, key
    frame records)."""
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import device_md as tmd
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    from svt_av1_tpu_torch.utils.trace import TRACER
    plain_calls = collections.Counter()
    keys = {}

    def counted(nm, fn):
        def call(*a, **k):
            plain_calls[nm] += 1
            return fn(*a, **k)
        return call

    patches = [(tmd, nm, lambda fn, nm=nm: counted(nm, fn))
               for nm in ("rdoq_trim_j", "_rate_cdf_j")] + list(spies) \
        + list(_keyframe_spies(keys))

    def run():
        TRACER.enabled = True
        TRACER.reset()
        dev.LAUNCHES.clear()
        dev.LAUNCH_SHAPES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ivf = encode_ivf(frames, cfg)
        torch.cuda.synchronize()
        return ivf, time.perf_counter() - t0

    ivf, dt = _run_patched(patches, run)
    TRACER.enabled = False
    return (ivf, dt, dict(dev.LAUNCHES), dict(dev.LAUNCH_SHAPES),
            dict(plain_calls), TRACER, keys)


def _keyframe_report(tag, keys, tracer, tiles: int) -> dict:
    """Print the key frames' path and fail unless every key frame ran
    the frame-batched program once over ``tiles`` tiles and the per-wave
    loop never ran."""
    key_s = [s["dur"] for s in tracer.spans if s["stage"] == "keyframe"]
    fused_s = [s["dur"] for s in tracer.spans
               if s["stage"] == "intra_tiles_fused"]
    for i, rec in enumerate(keys["frames"]):
        progs = rec["programs"]
        steps = ", ".join(f"{p['wave_steps']} wave steps, "
                          f"{p['class_steps']} class steps, "
                          f"{p['lanes']} lanes in {p['classes']} classes"
                          for p in progs)
        print(f"[{tag}] key frame {i}: compute {key_s[i]:.3f} s, "
              f"intra_tiles_fused {fused_s[i] if i < len(fused_s) else 0:.3f}"
              f" s; frame program x{len(progs)} over "
              f"{[p['tiles'] for p in progs]} tiles: {steps}", flush=True)
        print(f"[{tag}] key frame {i} kernel launches: "
              f"{sum(rec['shapes'].values())} in the compute "
              f"({sum(rec['program_shapes'].values())} in the frame "
              f"program); shapes in the program "
              f"{_shape_keys(rec['program_shapes'])}", flush=True)
    for rec in keys["frames"]:
        if [p["tiles"] for p in rec["programs"]] != [tiles]:
            raise SystemExit(f"{tag}: a key frame did not run the frame "
                             f"program once over {tiles} tiles: "
                             f"{rec['programs']}")
        if not rec["program_shapes"]:
            raise SystemExit(f"{tag}: the frame program launched no kernel")
    if keys["code_wave"]:
        raise SystemExit(f"{tag}: the per-wave loop ran "
                         f"{keys['code_wave']} times")
    print(f"[{tag}] every key frame through run_tiles_fused over {tiles} "
          f"tiles; per-wave _code_wave calls 0", flush=True)
    return {"keyframe_compute_s": key_s, "intra_tiles_fused_s": fused_s,
            "programs": [r["programs"] for r in keys["frames"]],
            "launch_shapes": [_shape_keys(r["shapes"])
                              for r in keys["frames"]],
            "program_launch_shapes": [_shape_keys(r["program_shapes"])
                                      for r in keys["frames"]],
            "code_wave_calls": keys["code_wave"]}


def _check_stream(what, ivf, sha, golden_bytes, golden_sha) -> None:
    if sha != golden_sha or len(ivf) != golden_bytes:
        raise SystemExit(f"{what} stream differs from the JAX golden: "
                         f"{len(ivf)} bytes sha256 {sha}, want "
                         f"{golden_bytes} bytes sha256 {golden_sha}")


def _shape_keys(shapes) -> dict:
    return {f"{k[0]} B={k[1]} n={k[2]} ls={k[3]}": v
            for k, v in sorted(shapes.items())}


def phase_slice(torch):
    """Returns (result, {(mode, B, n, log_scale): launches})."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=WIDTH, h=HEIGHT, frames=FRAMES, seed=3)
    cfg = preset_config(width=WIDTH, height=HEIGHT, qp=QP, preset=PRESET,
                        intra_period=0, device="cuda")
    ivf, dt, launches, shapes, plain_calls, tracer, keys = _encode_counted(
        torch, frames, cfg)
    sha = hashlib.sha256(ivf).hexdigest()
    spans = tracer.summary()
    keyframes = [s["dur"] for s in tracer.spans if s["stage"] == "keyframe"]
    print(f"[slice] {WIDTH}x{HEIGHT} all-intra preset {PRESET} qp {QP}: "
          f"{FRAMES} frames in {dt:.2f} s ({dt / FRAMES:.2f} s/frame), "
          f"{len(ivf)} bytes, sha256 {sha}", flush=True)
    for stage, v in spans.items():
        print(f"[slice] span {stage}: {v['count']} x, {v['total_s']} s",
              flush=True)
    _check_stream("all-intra", ivf, sha, GOLDEN_BYTES, GOLDEN_SHA256)
    if launches.get("quant_stage_rdoq", 0) + launches.get("quant_stage",
                                                           0) <= 0:
        raise SystemExit("the main path never launched the fused kernel")
    if plain_calls:
        raise SystemExit(f"the plain trim or rate ran on the main path: "
                         f"{plain_calls}")
    print(f"[slice] stream equals the JAX golden; launches {launches}; "
          f"plain rdoq_trim_j / _rate_cdf_j calls 0", flush=True)
    key = _keyframe_report("slice", keys, tracer, TILES)
    return {"seconds": dt, "seconds_per_frame": dt / FRAMES,
            "keyframe_span_s": keyframes, "keyframes": key,
            "bytes": len(ivf),
            "sha256": sha, "launches": launches,
            "plain_trim_rate_calls": plain_calls,
            "launch_shapes": _shape_keys(shapes), "spans": spans}, shapes


def _by_mode_n(shapes) -> dict:
    """{(mode, n): launches} from {(mode, B, n, log_scale): launches}."""
    out = collections.Counter()
    for (mode, _, n, _), v in shapes.items():
        out[(mode, n)] += v
    return dict(out)


def phase_directional(torch):
    """Preset 2's key frame: the per-wave loop with the intra edge filter.
    Returns (result, {(mode, B, n, log_scale): launches})."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import intra_dir
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=WIDTH, h=HEIGHT, frames=1, seed=3)
    cfg = preset_config(width=WIDTH, height=HEIGHT, qp=QP, preset=DIR_PRESET,
                        intra_period=0, device="cuda")
    edge_calls = collections.Counter()

    def edge_spy(fn):
        def call(mode, delta, *a, **k):
            edge_calls[(mode, delta)] += 1
            return fn(mode, delta, *a, **k)
        return call

    ivf, dt, launches, shapes, plain_calls, tracer, keys = _encode_counted(
        torch, frames, cfg,
        spies=((intra_dir, "predict_directional_edge_t", edge_spy),))
    sha = hashlib.sha256(ivf).hexdigest()
    spans = tracer.summary()
    key_s = [s["dur"] for s in tracer.spans if s["stage"] == "keyframe"]
    print(f"[directional] {WIDTH}x{HEIGHT} all-intra preset {DIR_PRESET} "
          f"qp {QP} (13 intra modes, intra edge filter on, NFL {cfg.nfl}, "
          f"partition DP down to {cfg.min_partition_size} px with rect "
          f"arms): 1 frame in {dt:.2f} s, key frame compute "
          f"{key_s[0] if key_s else 0:.2f} s, {len(ivf)} bytes, sha256 "
          f"{sha}", flush=True)
    for stage, v in spans.items():
        print(f"[directional] span {stage}: {v['count']} x, {v['total_s']} s",
              flush=True)
    by_mn = _by_mode_n(shapes)
    print(f"[directional] per-wave loop: {keys['wave_tiles']} tiles, "
          f"{keys['waves']} tile waves in {keys['wave_steps']} steps (wave w "
          f"of every tile per step), {keys['code_wave']} (step, shape) "
          f"groups; edge-filtered predictor calls "
          f"{sum(edge_calls.values())} over {len(edge_calls)} (mode, delta)",
          flush=True)
    print(f"[directional] kernel launches by mode and n: "
          f"{ {f'{m} n={n}': v for (m, n), v in sorted(by_mn.items())} }",
          flush=True)
    _check_stream("directional", ivf, sha, GOLDEN_DIR_BYTES,
                  GOLDEN_DIR_SHA256)
    if not keys["code_wave"] or not edge_calls:
        raise SystemExit("the key frame did not run the per-wave loop with "
                         "the edge-filtered predictor")
    if any(rec["programs"] for rec in keys["frames"]):
        raise SystemExit("the directional key frame ran the frame program")
    if launches.get("quant_stage_rdoq", 0) + launches.get("quant_stage",
                                                           0) <= 0:
        raise SystemExit("the directional key frame never launched the "
                         "fused kernel")
    if plain_calls:
        raise SystemExit(f"the plain trim or rate ran on the main path: "
                         f"{plain_calls}")
    print("[directional] stream equals the JAX golden; per-wave loop with "
          "the edge filter; plain rdoq_trim_j / _rate_cdf_j calls 0",
          flush=True)
    return {"seconds": dt, "keyframe_compute_s": key_s, "bytes": len(ivf),
            "sha256": sha, "launches": launches,
            "launches_by_mode_n": {f"{m} n={n}": v
                                   for (m, n), v in sorted(by_mn.items())},
            "launch_shapes": _shape_keys(shapes),
            "wave_tiles": keys["wave_tiles"], "waves": keys["waves"],
            "wave_steps": keys["wave_steps"], "groups": keys["groups"],
            "wave_shape_groups": keys["code_wave"],
            "edge_predictor_calls": {f"{m},{d}": v for (m, d), v
                                     in sorted(edge_calls.items())},
            "plain_trim_rate_calls": plain_calls, "spans": spans}, shapes


INTER_SPANS = ("inter_partition_dp", "inter_blocks", "intra_flip",
               "flip_decision", "flip_apply", "tmvp_build", "dlf", "entropy")


def _group_spy(biggest):
    """A wrapper factory for ``shape_group_issue`` that keeps the arguments
    of the largest shape group in ``biggest`` for the profiled replay.
    Only references: the group writes the recon planes and reads nothing
    of them, so the replay clones whatever they hold then, and the timed
    encode copies nothing."""
    def spy(fn):
        def call(recon, *a, **k):
            if len(a[6]) > biggest.get("b", 0):
                biggest.update(b=len(a[6]), recon=recon, args=a, kw=k)
            return fn(recon, *a, **k)
        return call
    return spy


def phase_inter(torch, check_keyframes: bool = True):
    """The random-access operating point. Returns (result, {(mode, B, n,
    log_scale): launches} over the whole encode, the same inside the inter
    frames, the largest shape group's arguments).
    ``check_keyframes=False`` (``inter_ab.py`` on a checkout before the
    fused keyframe program) skips the key frame report and its checks."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import device_inter as di
    from svt_av1_tpu_torch.pipeline.inter import InterFrameEncoder
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=WIDTH, h=HEIGHT, frames=RA_FRAMES, seed=3)
    cfg = preset_config(width=WIDTH, height=HEIGHT, qp=QP, preset=PRESET,
                        intra_period=-1, hierarchical_levels=RA_LEVELS,
                        device="cuda")
    inter_launches = collections.Counter()
    inter_shapes = collections.Counter()
    flipped = []
    biggest = {}

    def compute_spy(fn):
        """Kernel launches inside each inter frame's compute (the entropy
        worker launches nothing) and the blocks the flip pass made
        intra."""
        def call(self, *a, **k):
            before = collections.Counter(dev.LAUNCHES)
            before_s = collections.Counter(dev.LAUNCH_SHAPES)
            out = fn(self, *a, **k)
            inter_launches.update(collections.Counter(dev.LAUNCHES) - before)
            inter_shapes.update(collections.Counter(dev.LAUNCH_SHAPES)
                                - before_s)
            flipped.append(int((~self.block_is_inter).sum()))
            return out
        return call

    ivf, dt, launches, shapes, plain_calls, tracer, keys = _encode_counted(
        torch, frames, cfg,
        spies=((InterFrameEncoder, "encode_compute", compute_spy),
               (di, "shape_group_issue", _group_spy(biggest))))
    sha = hashlib.sha256(ivf).hexdigest()
    spans = tracer.summary()
    key_s = sum(s["dur"] for s in tracer.spans if s["stage"] == "keyframe")
    frame_s = [s["dur"] for s in tracer.spans if s["stage"] == "inter_frame"]
    n_inter = RA_FRAMES - 1
    print(f"[inter] {WIDTH}x{HEIGHT} random access hier-{RA_LEVELS} preset "
          f"{PRESET} qp {QP}: {RA_FRAMES} frames in {dt:.2f} s "
          f"({dt / RA_FRAMES:.2f} s/frame), {len(ivf)} bytes, sha256 {sha}",
          flush=True)
    print(f"[inter] key frame {key_s:.2f} s (its compute); inter frames "
          f"{(dt - key_s) / n_inter:.3f} s/frame (wall after the key "
          f"frame's compute, entropy drained, / {n_inter}); inter compute "
          f"{sum(frame_s) / n_inter:.3f} s/frame (span inter_frame)",
          flush=True)
    for stage in INTER_SPANS:
        v = spans.get(stage, {"count": 0, "total_s": 0.0})
        print(f"[inter] span {stage}: {v['count']} x, {v['total_s']} s",
              flush=True)
    print(f"[inter] intra blocks placed by the flip pass: {sum(flipped)} "
          f"({flipped} per inter frame)", flush=True)
    print(f"[inter] kernel launches inside the inter frames: "
          f"{dict(inter_launches)}; shapes {_shape_keys(inter_shapes)}",
          flush=True)
    _check_stream("random-access", ivf, sha, GOLDEN_RA_BYTES,
                  GOLDEN_RA_SHA256)
    if inter_launches.get("quant_stage_rdoq", 0) \
            + inter_launches.get("quant_stage", 0) <= 0:
        raise SystemExit("the inter frames never launched the fused kernel")
    if plain_calls:
        raise SystemExit(f"the plain trim or rate ran on the main path: "
                         f"{plain_calls}")
    print(f"[inter] stream equals the JAX golden; plain rdoq_trim_j / "
          f"_rate_cdf_j calls 0", flush=True)
    key = _keyframe_report("inter", keys, tracer, TILES) \
        if check_keyframes else None
    return {"seconds": dt, "seconds_per_frame": dt / RA_FRAMES,
            "keyframe_compute_s": key_s, "keyframes": key,
            "inter_s_per_frame": (dt - key_s) / n_inter,
            "inter_compute_s_per_frame": sum(frame_s) / n_inter,
            "inter_frame_span_s": frame_s, "bytes": len(ivf),
            "sha256": sha, "launches": launches,
            "inter_launches": dict(inter_launches),
            "inter_launch_shapes": _shape_keys(inter_shapes),
            "flipped_blocks": flipped,
            "plain_trim_rate_calls": plain_calls,
            "spans": spans}, shapes, inter_shapes, biggest


def _clone(p):
    return p.clone() if hasattr(p, "clone") else p.copy()


def _pf_record(idx_map, cdef_kw, rinfos) -> dict:
    """One frame's post-filter choices: the CDEF strength set and how many
    SBs took each entry (-1: no coded block), the LR frame types per plane
    and the per-unit types of each plane."""
    import numpy as np
    vals, counts = np.unique(idx_map, return_counts=True)
    return {"cdef_y_strengths": list(cdef_kw["cdef_y_strengths"]),
            "cdef_uv_strengths": list(cdef_kw["cdef_uv_strengths"]),
            "cdef_damping": cdef_kw["cdef_damping"],
            "cdef_sbs_per_entry": {int(v): int(c)
                                   for v, c in zip(vals, counts)},
            "lr_types": [ri.frame_restoration_type for ri in rinfos],
            "lr_unit_types": [dict(collections.Counter(
                u.restoration_type for u in ri.units)) for ri in rinfos]}


def phase_postfilter(torch):
    """The random-access clip with CDEF and LR on every frame. Returns
    (result, {(mode, B, n, log_scale): launches}, the first inter frame's
    post-filter arguments for the profiled replay)."""
    import dataclasses

    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline import postfilter as tpf
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=WIDTH, h=HEIGHT, frames=RA_FRAMES, seed=3)
    cfg = dataclasses.replace(preset_config(
        width=WIDTH, height=HEIGHT, qp=QP, preset=PRESET, intra_period=-1,
        hierarchical_levels=RA_LEVELS, device="cuda"),
        enable_cdef=True, enable_restoration=True)
    per_frame, replay = [], {}

    def pf_spy(fn):
        """Each frame's choices; the first inter frame's pre-filter
        planes (one clone of 3 planes inside the timed run)."""
        def call(cfg_, recon, src, tiles, *a):
            if len(per_frame) == 1:
                replay["args"] = (cfg_, [_clone(p) for p in recon], src,
                                  tiles) + a
            out = fn(cfg_, recon, src, tiles, *a)
            per_frame.append(_pf_record(out[0], out[1], out[2]))
            return out
        return call

    ivf, dt, launches, shapes, plain_calls, tracer, keys = _encode_counted(
        torch, frames, cfg, spies=((tpf, "run_postfilters", pf_spy),))
    sha = hashlib.sha256(ivf).hexdigest()
    spans = tracer.summary()
    key_s = sum(s["dur"] for s in tracer.spans if s["stage"] == "keyframe")
    n_inter = RA_FRAMES - 1
    per_span = {st: [s["dur"] for s in tracer.spans if s["stage"] == st]
                for st in ("cdef", "lr")}
    print(f"[postfilter] {WIDTH}x{HEIGHT} random access hier-{RA_LEVELS} "
          f"preset {PRESET} qp {QP} with CDEF and LR: {RA_FRAMES} frames in "
          f"{dt:.2f} s ({dt / RA_FRAMES:.2f} s/frame), {len(ivf)} bytes, "
          f"sha256 {sha}", flush=True)
    print(f"[postfilter] key frame {key_s:.2f} s (its compute); inter "
          f"frames {(dt - key_s) / n_inter:.3f} s/frame (wall after the key "
          f"frame's compute, entropy drained, / {n_inter})", flush=True)
    for i, rec in enumerate(per_frame):
        cd = per_span["cdef"][i] if i < len(per_span["cdef"]) else 0.0
        lr = per_span["lr"][i] if i < len(per_span["lr"]) else 0.0
        print(f"[postfilter] frame {i} (coding order): cdef {cd:.4f} s, lr "
              f"{lr:.4f} s; CDEF y {rec['cdef_y_strengths']} uv "
              f"{rec['cdef_uv_strengths']} damping {rec['cdef_damping']}, "
              f"SBs per entry {rec['cdef_sbs_per_entry']}; LR types Y/U/V "
              f"{rec['lr_types']}, unit types {rec['lr_unit_types']}",
              flush=True)
    for stage in INTER_SPANS + ("cdef", "lr"):
        v = spans.get(stage, {"count": 0, "total_s": 0.0})
        print(f"[postfilter] span {stage}: {v['count']} x, {v['total_s']} s",
              flush=True)
    _check_stream("post-filter", ivf, sha, GOLDEN_PF_BYTES, GOLDEN_PF_SHA256)
    for stage in ("cdef", "lr"):
        if len(per_span[stage]) != RA_FRAMES:
            raise SystemExit(f"span {stage} ran {len(per_span[stage])} "
                             f"times, want once on each of {RA_FRAMES} "
                             f"frames")
    if len(per_frame) != RA_FRAMES:
        raise SystemExit(f"the post-filters ran on {len(per_frame)} frames")
    if launches.get("quant_stage_rdoq", 0) + launches.get("quant_stage",
                                                           0) <= 0:
        raise SystemExit("the post-filter encode never launched the fused "
                         "kernel")
    if plain_calls:
        raise SystemExit(f"the plain trim or rate ran on the main path: "
                         f"{plain_calls}")
    print("[postfilter] stream equals the JAX golden; cdef and lr once on "
          "each frame; plain rdoq_trim_j / _rate_cdf_j calls 0", flush=True)
    key = _keyframe_report("postfilter", keys, tracer, TILES)
    return {"seconds": dt, "seconds_per_frame": dt / RA_FRAMES,
            "keyframe_compute_s": key_s, "keyframes": key,
            "inter_s_per_frame": (dt - key_s) / n_inter,
            "cdef_s": per_span["cdef"], "lr_s": per_span["lr"],
            "frames": per_frame, "bytes": len(ivf), "sha256": sha,
            "launches": launches, "launch_shapes": _shape_keys(shapes),
            "plain_trim_rate_calls": plain_calls, "spans": spans}, \
        shapes, replay


def phase_search(torch):
    """The random-access clip with the interpolation-filter search and the
    inter tx-type sweep on: the non-fused inter path on every inter frame.
    Returns (result, {(mode, B, n, log_scale): launches}, the largest shape
    group's encoder and batch for the profiled replay)."""
    import dataclasses

    import numpy as np

    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import device_inter as di
    from svt_av1_tpu_torch.pipeline.inter import InterFrameEncoder
    from svt_av1_tpu_torch.utils.clip import make_clip
    from svt_av1_tpu_torch.utils.trace import TRACER
    frames = make_clip(w=WIDTH, h=HEIGHT, frames=RA_FRAMES, seed=3)
    cfg = dataclasses.replace(preset_config(
        width=WIDTH, height=HEIGHT, qp=QP, preset=PRESET, intra_period=-1,
        hierarchical_levels=RA_LEVELS, device="cuda"),
        enable_interp_filter_search=True, enable_tx_type_search=True)
    per_frame, biggest = [], {}

    def compute_spy(fn):
        """Per inter frame: its stage spans, the kernel's launches inside
        it, the inter blocks per filter type and per luma tx type."""
        def call(self, *a, **k):
            first = len(TRACER.spans)
            before = collections.Counter(dev.LAUNCHES)
            out = fn(self, *a, **k)
            spans = collections.defaultdict(float)
            counts = collections.Counter()
            for sp in TRACER.spans[first:]:
                spans[sp["stage"]] += sp["dur"]
                counts[sp["stage"]] += 1
            inter = self.block_is_inter
            per_frame.append({
                "spans_s": {st: spans[st] for st in SEARCH_SPANS},
                "span_counts": {st: counts[st] for st in SEARCH_SPANS},
                "launches": dict(collections.Counter(dev.LAUNCHES) - before),
                "blocks_per_filter": np.bincount(
                    self.interp_f[inter], minlength=3).tolist(),
                "tx_type_histogram": np.bincount(
                    self.y_tx_type[inter], minlength=16).tolist(),
                "intra_flips": int((~inter).sum())})
            return out
        return call

    ivf, dt, launches, shapes, plain_calls, tracer, keys = _encode_counted(
        torch, frames, cfg,
        spies=((InterFrameEncoder, "encode_compute", compute_spy),
               (di, "shape_group_issue", _group_spy(biggest))))
    sha = hashlib.sha256(ivf).hexdigest()
    spans = tracer.summary()
    key_s = sum(s["dur"] for s in tracer.spans if s["stage"] == "keyframe")
    n_inter = RA_FRAMES - 1
    print(f"[search] {WIDTH}x{HEIGHT} random access hier-{RA_LEVELS} preset "
          f"{PRESET} qp {QP} with the interpolation-filter search and the "
          f"inter tx-type sweep: {RA_FRAMES} frames in {dt:.2f} s "
          f"({dt / RA_FRAMES:.2f} s/frame), {len(ivf)} bytes, sha256 {sha}",
          flush=True)
    print(f"[search] key frame {key_s:.2f} s (its compute); inter frames "
          f"{(dt - key_s) / n_inter:.3f} s/frame (wall after the key "
          f"frame's compute, entropy drained, / {n_inter})", flush=True)
    for i, rec in enumerate(per_frame):
        st = ", ".join(f"{k} {v:.4f} s" for k, v in rec["spans_s"].items())
        print(f"[search] inter frame {i} (coding order): {st}; blocks per "
              f"filter (REGULAR, SMOOTH, SHARP) {rec['blocks_per_filter']}; "
              f"tx types {rec['tx_type_histogram']}; flips "
              f"{rec['intra_flips']}; launches {rec['launches']}",
              flush=True)
    for stage in INTER_SPANS + SEARCH_SPANS:
        v = spans.get(stage, {"count": 0, "total_s": 0.0})
        print(f"[search] span {stage}: {v['count']} x, {v['total_s']} s",
              flush=True)
    _check_stream("search", ivf, sha, GOLDEN_SEARCH_BYTES,
                  GOLDEN_SEARCH_SHA256)
    if len(per_frame) != n_inter:
        raise SystemExit(f"{len(per_frame)} inter frames, want {n_inter}")
    for i, rec in enumerate(per_frame):
        groups = rec["span_counts"]["me_rd"]
        for stage in ("interp_filter_search", "inter_tx_search"):
            if not groups or rec["span_counts"][stage] != groups:
                raise SystemExit(f"span {stage} ran "
                                 f"{rec['span_counts'][stage]} times in "
                                 f"inter frame {i}, on {groups} shape "
                                 f"groups")
        if rec["launches"].get("quant_stage_rdoq", 0) <= 0:
            raise SystemExit(f"inter frame {i} never launched the fused "
                             f"kernel")
    if plain_calls:
        raise SystemExit(f"the plain trim or rate ran on the main path: "
                         f"{plain_calls}")
    print("[search] stream equals the JAX golden; interp_filter_search and "
          "inter_tx_search on every shape group of every inter frame; "
          "plain rdoq_trim_j / _rate_cdf_j calls 0", flush=True)
    key = _keyframe_report("search", keys, tracer, TILES)
    return {"seconds": dt, "seconds_per_frame": dt / RA_FRAMES,
            "keyframe_compute_s": key_s, "keyframes": key,
            "inter_s_per_frame": (dt - key_s) / n_inter,
            "inter_frames": per_frame, "bytes": len(ivf), "sha256": sha,
            "launches": launches, "launch_shapes": _shape_keys(shapes),
            "plain_trim_rate_calls": plain_calls, "spans": spans}, \
        shapes, biggest


def _tool_spies(frames_rec, headers, satd):
    """Spies of the rate and analysis phases: per coded frame (in coding
    order) its kind, base qindex, SB qindex map, its kernel launches and
    how many of them had rows of differing qindex (a spy on ``qv``); into
    ``headers``, per frame header written (the entropy worker writes them
    in coding order), whether it carried film grain parameters; and into
    ``satd`` every SATD issue of the intra partition DP (``devices``) and
    the largest call's host inputs (``largest``) for the check against
    the CPU."""
    from svt_av1_tpu_torch.bitstream import obu
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.pipeline import encoder as tenc
    from svt_av1_tpu_torch.pipeline import inter as tinter
    from svt_av1_tpu_torch.pipeline import rd as trd
    from svt_av1_tpu_torch.pipeline import wavefront as twf
    cur = [None]

    def frame_spy(kind):
        def spy(fn):
            def call(*a, **k):
                cur[0] = {"kind": kind, "launches": 0, "mixed": 0}
                frames_rec.append(cur[0])
                try:
                    return fn(*a, **k)
                finally:
                    cur[0] = None
            return call
        return spy

    def enc_spy(fn):
        """Keeps the frame encoder of the current frame."""
        def call(self, *a, **k):
            cur[0]["enc"] = self
            return fn(self, *a, **k)
        return call

    def qv_spy(fn):
        def call(mode, coeff, scan, qv, *a, **k):
            rec = cur[0]
            if rec is not None and qv.numel():
                rec["launches"] += 1
                rec["mixed"] += int(bool((qv != qv[0]).any()))
            return fn(mode, coeff, scan, qv, *a, **k)
        return call

    def satd_spy(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            satd["devices"].append(out.device.type)
            if len(a[0]) > len(satd["largest"][0][0]):
                satd["largest"] = (a, k)
            return out
        return call

    def header_spy(fn):
        def call(seq, fh, *a, **k):
            headers.append(bool(seq.film_grain_params_present
                                and fh.film_grain is not None))
            return fn(seq, fh, *a, **k)
        return call

    satd.update(devices=[], largest=(([],), {}))
    return [(tenc.Encoder, "_encode_key", frame_spy("key")),
            (obu, "write_frame_obu", header_spy),
            (tenc.Encoder, "_encode_inter", frame_spy("inter")),
            (twf.WavefrontIntraEncoder, "_package_compute", enc_spy),
            (tinter.InterFrameEncoder, "encode_compute", enc_spy),
            (dev, "quant_stage_launch", qv_spy),
            (trd, "satd_modes", satd_spy)]


def _frame_summary(rec) -> dict:
    """One coded frame's facts from its spy record."""
    enc = rec.pop("enc")
    base = enc.cfg.base_q_idx
    qmap = enc.qmap
    return {"kind": rec["kind"], "base_qindex": base,
            "sbs_off_base": 0 if qmap is None else int((qmap != base).sum()),
            "qindex_range": None if qmap is None
            else [int(qmap.min()), int(qmap.max())],
            "kernel_launches": rec["launches"],
            "mixed_qindex_launches": rec["mixed"]}


def _tools_encode(torch, tag, cfg, golden_bytes, golden_sha):
    """Encode the random-access clip with ``cfg`` under the tool spies,
    print its stream, times, spans and per-frame facts, and check the
    stream against its golden. Returns (result, shapes, frames, SATD
    calls, key frame records, tracer)."""
    from svt_av1_tpu_torch.utils.clip import make_clip
    frames = make_clip(w=WIDTH, h=HEIGHT, frames=RA_FRAMES, seed=3)
    recs, headers, satd = [], [], {}
    ivf, dt, launches, shapes, plain_calls, tracer, keys = _encode_counted(
        torch, frames, cfg, spies=_tool_spies(recs, headers, satd))
    per_frame = [_frame_summary(r) for r in recs]
    if len(headers) != len(per_frame):
        raise SystemExit(f"{tag}: {len(headers)} frame headers written for "
                         f"{len(per_frame)} coded frames")
    for f, grain in zip(per_frame, headers):
        f["grain_params"] = grain
    sha = hashlib.sha256(ivf).hexdigest()
    spans = tracer.summary()
    key_s = sum(s["dur"] for s in tracer.spans if s["stage"] == "keyframe")
    n_inter = RA_FRAMES - 1
    print(f"[{tag}] {WIDTH}x{HEIGHT} random access hier-{RA_LEVELS} preset "
          f"{PRESET} qp {QP}: {RA_FRAMES} frames in {dt:.2f} s "
          f"({dt / RA_FRAMES:.2f} s/frame), {len(ivf)} bytes, sha256 {sha}",
          flush=True)
    print(f"[{tag}] key frame {key_s:.2f} s (its compute); inter frames "
          f"{(dt - key_s) / n_inter:.3f} s/frame (wall after the key "
          f"frame's compute, entropy drained, / {n_inter})", flush=True)
    for i, f in enumerate(per_frame):
        print(f"[{tag}] frame {i} (coding order, {f['kind']}): qindex "
              f"{f['base_qindex']}, SBs off it {f['sbs_off_base']} "
              f"(range {f['qindex_range']}), grain params "
              f"{f['grain_params']}, kernel launches "
              f"{f['kernel_launches']} ({f['mixed_qindex_launches']} with "
              f"rows of differing qindex)", flush=True)
    for stage in TOOL_SPANS:
        v = spans.get(stage, {"count": 0, "total_s": 0.0})
        print(f"[{tag}] span {stage}: {v['count']} x, {v['total_s']} s",
              flush=True)
    _check_stream(tag, ivf, sha, golden_bytes, golden_sha)
    if plain_calls:
        raise SystemExit(f"the plain trim or rate ran on the main path: "
                         f"{plain_calls}")
    if len(per_frame) != RA_FRAMES or per_frame[0]["kind"] != "key":
        raise SystemExit(f"{tag}: {len(per_frame)} coded frames")
    res = {"seconds": dt, "seconds_per_frame": dt / RA_FRAMES,
           "keyframe_compute_s": key_s,
           "inter_s_per_frame": (dt - key_s) / n_inter,
           "frames": per_frame, "bytes": len(ivf), "sha256": sha,
           "launches": launches, "launch_shapes": _shape_keys(shapes),
           "plain_trim_rate_calls": plain_calls, "spans": spans}
    return res, shapes, satd, keys, tracer


def phase_aq(torch):
    """Variance AQ with SATD partition scoring on the random-access clip:
    the key frame on the per-wave loop with per-lane qindex (the frame
    program takes one qindex), the inter frames' shape groups and flips
    with per-lane qindex, the SATD twin in the key frame's DP. Returns
    (result, {(mode, B, n, log_scale): launches})."""
    import dataclasses

    import numpy as np

    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops.device_md import satd_modes
    cfg = dataclasses.replace(preset_config(
        width=WIDTH, height=HEIGHT, qp=QP, preset=PRESET, intra_period=-1,
        hierarchical_levels=RA_LEVELS, device="cuda"),
        adaptive_quantization=1, intra_dp_satd=True)
    res, shapes, satd, keys, tracer = _tools_encode(
        torch, "aq", cfg, GOLDEN_AQ_BYTES, GOLDEN_AQ_SHA256)
    devices = satd["devices"]
    frames = res["frames"]
    programs = [p for r in keys["frames"] for p in r["programs"]]
    print(f"[aq] key frame: per-wave loop {keys['wave_tiles']} tiles, "
          f"{keys['wave_steps']} steps, {keys['code_wave']} (step, shape) "
          f"groups; frame programs {len(programs)}; SATD issues "
          f"{len(devices)} on {sorted(set(devices))}", flush=True)
    if not keys["code_wave"] or programs:
        raise SystemExit(f"aq: the key frame must run the per-wave loop "
                         f"({keys['code_wave']} groups) and no frame "
                         f"program ({len(programs)})")
    if not devices or set(devices) != {"cuda"}:
        raise SystemExit(f"aq: the SATD twin ran on {devices}")
    for kind in ("key", "inter"):
        mixed = [f["mixed_qindex_launches"] for f in frames
                 if f["kind"] == kind]
        if not all(f["sbs_off_base"] for f in frames if f["kind"] == kind):
            raise SystemExit(f"aq: a {kind} frame coded no SB off its base "
                             f"qindex")
        if not any(mixed):
            raise SystemExit(f"aq: no {kind} frame launched the kernel "
                             f"with rows of differing qindex")
    # the largest SATD issue of the DP again, on the card and on the CPU
    a, k = satd["largest"]
    got = satd_modes(*a, **k).cpu()
    want = satd_modes(*a, **{**k, "device": "cpu"})
    if not torch.equal(got, want):
        raise SystemExit("aq: the SATD twin on the card differs from its "
                         "CPU run")
    print(f"[aq] stream equals the JAX golden; key frame on _code_wave, "
          f"run_tiles_fused never; SATD twin on the card, its largest "
          f"issue (B={len(a[0])}, size {a[6]}) equal to the CPU run; "
          f"kernel launches with mixed qindex per frame "
          f"{[f['mixed_qindex_launches'] for f in frames]}; plain "
          f"rdoq_trim_j / _rate_cdf_j calls 0", flush=True)
    res.update(satd_issues=len(devices), satd_check_b=len(a[0]),
               waves={k_: keys[k_] for k_ in ("wave_tiles", "wave_steps",
                                              "code_wave")},
               mixed_total=int(np.sum([f["mixed_qindex_launches"]
                                       for f in frames])))
    return res, shapes


def phase_rc(torch):
    """VBR with lookahead, TPL AQ, film grain and source denoising on the
    random-access clip. Returns (result, {(mode, B, n, log_scale):
    launches})."""
    import dataclasses

    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.config import RateControlMode
    cfg = dataclasses.replace(preset_config(
        width=WIDTH, height=HEIGHT, qp=QP, preset=PRESET, intra_period=-1,
        hierarchical_levels=RA_LEVELS, device="cuda"),
        adaptive_quantization=2, rate_control_mode=RateControlMode.VBR,
        target_bit_rate=RC_TARGET_BPS, look_ahead_distance=RC_LOOKAHEAD,
        film_grain_strength=RC_GRAIN, enable_source_denoise=True)
    res, shapes, _, keys, tracer = _tools_encode(
        torch, "rc", cfg, GOLDEN_RC_BYTES, GOLDEN_RC_SHA256)
    frames = res["frames"]
    qindex = [f["base_qindex"] for f in frames]
    tpl = [f["sbs_off_base"] for f in frames if f["kind"] == "inter"]
    rate = res["bytes"] * 8 * 30 / RA_FRAMES
    print(f"[rc] per-frame qindex (coding order) {qindex}; SBs with a TPL "
          f"delta per inter frame {tpl}; {rate / 1e6:.3f} Mb/s against the "
          f"{RC_TARGET_BPS / 1e6:.1f} Mb/s target", flush=True)
    if not any(tpl):
        print("[rc] the TPL map is all zero on every frame of this clip "
              "(the CPU tests hold TPL deltas)", flush=True)
    if len(set(qindex)) < 2:
        raise SystemExit(f"rc: the controller's qindex is constant: {qindex}")
    if not all(f["grain_params"] for f in frames):
        raise SystemExit("rc: a frame header lacks the film grain params")
    key = _keyframe_report("rc", keys, tracer, TILES)
    print("[rc] stream equals the JAX golden; qindex varies by frame; film "
          "grain params in every frame header; the key frame in the frame "
          "program; plain rdoq_trim_j / _rate_cdf_j calls 0", flush=True)
    res.update(keyframes=key, qindex=qindex, tpl_sbs=tpl, bits_per_s=rate)
    return res, shapes


def _entry_inputs(np, frames):
    """The [entry] operands from the RA clip's frames 0 and 1 at 1080p,
    padded to 1088 rows by edge replication: every 16x16 luma block of
    frame 0 with its edges from the source (indices clamped into the
    frame; the have flags off on the first row and column), and frame 1's
    luma against frame 0's."""
    s = 16
    pad = ((0, -HEIGHT % s), (0, -WIDTH % s))
    y0, y1 = (np.pad(f[0], pad, mode="edge").astype(np.int32)
              for f in frames[:2])
    h, w = y0.shape
    by, bx = np.divmod(np.arange((h // s) * (w // s)), w // s)
    r0, c0 = by * s, bx * s
    ar = np.arange(2 * s)
    src = y0.reshape(h // s, s, w // s, s).transpose(0, 2, 1, 3) \
        .reshape(-1, s, s)
    above = y0[np.maximum(r0 - 1, 0)[:, None],
               np.minimum(c0[:, None] + ar, w - 1)]
    left = y0[np.minimum(r0[:, None] + ar, h - 1),
              np.maximum(c0 - 1, 0)[:, None]]
    tl = y0[np.maximum(r0 - 1, 0), np.maximum(c0 - 1, 0)]
    return (src, above, left, tl, by > 0, bx > 0), y1, y0


def _entry_step(torch, name, fn, args, **kw):
    """One analysis step on the card with the launch counters set to 0
    just before and read just after its first call (then timed once more,
    warm), held equal to the same function on the CPU tensors. Fails
    unless it launched the kernel's quantize-only mode, and only that,
    and never ran the plain quantizer on the card. Returns (row,
    {(mode, B, n, log_scale): launches})."""
    from svt_av1_tpu_torch.ops import device as dev
    plain = []
    real_plain = dev.quantize_qv_plain

    def spy(*a, **k):
        plain.append(1)
        return real_plain(*a, **k)

    cuda_args = [torch.as_tensor(a, device="cuda") for a in args]
    torch.cuda.synchronize()
    dev.quantize_qv_plain = spy
    try:
        dev.LAUNCHES.clear()
        dev.LAUNCH_SHAPES.clear()
        t0 = time.perf_counter()
        got = fn(*cuda_args, **kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches, shapes = dict(dev.LAUNCHES), dict(dev.LAUNCH_SHAPES)
        t0 = time.perf_counter()
        fn(*cuda_args, **kw)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        dev.quantize_qv_plain = real_plain
    t0 = time.perf_counter()
    want = fn(*[torch.as_tensor(a) for a in args], **kw)
    cpu_s = time.perf_counter() - t0
    exact = all(g.dtype == w.dtype and torch.equal(g.cpu(), w)
                for g, w in zip(got, want))
    print(f"[entry] {name}: B={got[0].shape[0]}; card {first_s * 1e3:.2f} "
          f"ms (first call), {warm_s * 1e3:.2f} ms (again); CPU "
          f"{cpu_s * 1e3:.1f} ms; launches {launches}, shapes "
          f"{_shape_keys(shapes)}; plain quantizer calls {len(plain)}; "
          f"equal to the CPU run: {exact}", flush=True)
    if not exact:
        raise SystemExit(f"entry: {name} on the card differs from the CPU")
    if set(launches) != {"quantize_qv"} or plain:
        raise SystemExit(f"entry: {name} launched {launches} with "
                         f"{len(plain)} plain quantizer calls")
    return {"name": name, "B": int(got[0].shape[0]), "first_s": first_s,
            "warm_s": warm_s, "cpu_s": cpu_s, "launches": launches,
            "launch_shapes": _shape_keys(shapes)}, shapes


def phase_entry(torch):
    """The analysis entry steps on the card: ``entry.entry()`` as it
    stands (64 blocks of 16x16), ``intra_analysis_step`` over the 8160
    16x16 luma blocks of the 1080p clip's frame 0, and
    ``inter_core_step`` / ``inter_core_subpel_step`` of frame 1 against
    frame 0 (size 16, search range 16). Returns (result, {(mode, B, n,
    log_scale): launches} over the four)."""
    import numpy as np

    from svt_av1_tpu_torch.entry import entry
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import mc as mch
    from svt_av1_tpu_torch.utils.clip import make_clip
    fn, args = entry()
    if any(a.device.type != "cuda" for a in args):
        raise SystemExit("entry: entry() did not put its operands on the "
                         "card")
    intra, cur, ref = _entry_inputs(
        np, make_clip(w=WIDTH, h=HEIGHT, frames=2, seed=3))
    steps = [("entry()", fn, [a.cpu() for a in args], {}),
             ("intra_analysis_step", dev.intra_analysis_step, intra,
              dict(size=16, qindex=160)),
             ("inter_core_step", dev.inter_core_step,
              (cur, np.pad(ref, 16, mode="edge")),
              dict(size=16, search_range=16)),
             ("inter_core_subpel_step", dev.inter_core_subpel_step,
              (cur, mch.pad_reference(ref).astype(np.int32)),
              dict(size=16, search_range=16))]
    rows, shapes = [], collections.Counter()
    for name, f, a, kw in steps:
        row, sh = _entry_step(torch, name, f, a, **kw)
        rows.append(row)
        shapes.update(sh)
    print("[entry] every step equals its CPU run exactly and launched "
          "the quantize-only kernel; plain quantizer calls 0", flush=True)
    return {"steps": rows}, shapes


def _ivf_of(tus) -> bytes:
    """An IVF of 1920x1080 temporal units at 30 fps, as ``encode_ivf``
    writes it for the CLI's default frame rate."""
    import io

    from svt_av1_tpu_torch.bitstream.ivf import write_ivf_frame, \
        write_ivf_header
    buf = io.BytesIO()
    write_ivf_header(buf, WIDTH, HEIGHT, 30, 1, len(tus))
    for i, tu in enumerate(tus):
        write_ivf_frame(buf, tu, i)
    return buf.getvalue()


def _app_cli(d: Path):
    """The CLI as a user runs it, in a subprocess, with no --device: the
    RA clip's y4m to out.ivf with recon.yuv and a trace. Returns (IVF
    bytes, wall seconds, the fps the CLI printed, {(mode, B, n,
    log_scale): launches} from its trace)."""
    from svt_av1_tpu_torch.utils.clip import make_clip, write_y4m
    write_y4m(d / "clip.y4m", make_clip(w=WIDTH, h=HEIGHT, frames=RA_FRAMES,
                                        seed=3))
    repo = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(repo)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "svt_av1_tpu_torch.app", "-i",
           str(d / "clip.y4m"), "-b", str(d / "out.ivf"), "-o",
           str(d / "recon.yuv"), "-q", str(QP), "--preset", str(PRESET),
           "--hierarchical-levels", str(RA_LEVELS), "--trace",
           str(d / "t.json")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"app: the CLI exited {proc.returncode}:\n"
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    m = re.search(r"^(.*) ([0-9.]+) fps encode speed$", proc.stdout, re.M)
    if not m:
        raise SystemExit(f"app: the CLI printed no speed:\n{proc.stdout}")
    print(f"[app] CLI: {m.group(0)}", flush=True)
    with open(d / "t.json") as f:
        trace = json.load(f)
    shapes = collections.Counter(
        {tuple(s[:4]): s[4] for s in trace["kernel_launch_shapes"]})
    return (d / "out.ivf").read_bytes(), wall, float(m.group(2)), shapes, \
        trace["summary"]


def phase_app(torch):
    """The entry points a user runs, on the card, and the port's own
    verification of their streams: the CLI (``python -m
    svt_av1_tpu_torch.app``, a subprocess with no --device) on the RA
    clip, its stream against the RA golden and its recon against the
    port's mirror decoder, the independent checker over the stream's
    leading TUs up to the first with a compound block; the EbApi
    lifecycle on the 1080p key frame against the all-intra golden, the
    checker over it; the warmup tool. Returns (result, {(mode, B, n,
    log_scale): launches} of the CLI, the API and the warmup)."""
    import io
    import tempfile

    import numpy as np

    from svt_av1_tpu_torch import api
    from svt_av1_tpu_torch.app.warmup import warm
    from svt_av1_tpu_torch.bitstream.ivf import read_ivf
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import mc as mch
    from svt_av1_tpu_torch.pipeline.decode import StreamDecoder
    from svt_av1_tpu_torch.utils import yuv
    from svt_av1_tpu_torch.utils.clip import make_clip
    from svt_av1_tpu_torch.verify.indep import check_ivf
    shapes = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        ivf, wall, fps, cli_shapes, cli_spans = _app_cli(d)
        sha = hashlib.sha256(ivf).hexdigest()
        print(f"[app] CLI {WIDTH}x{HEIGHT} RA hier-{RA_LEVELS} preset "
              f"{PRESET} qp {QP}, {RA_FRAMES} frames: wall {wall:.2f} s "
              f"(process start, imports and kernel load included), "
              f"{fps:.2f} fps as the CLI printed it; {len(ivf)} bytes, "
              f"sha256 {sha}", flush=True)
        _check_stream("CLI", ivf, sha, GOLDEN_RA_BYTES, GOLDEN_RA_SHA256)
        cli_by = _by_mode_n(cli_shapes)
        print(f"[app] CLI kernel launches (its trace): {cli_by}",
              flush=True)
        if not any(m in ("quant_stage", "quant_stage_rdoq")
                   for m, _ in cli_by):
            raise SystemExit("app: the CLI never launched the fused kernel")
        shapes.update(cli_shapes)
        _, tus = read_ivf(io.BytesIO(ivf))
        tus = [p for _, p in tus]
        compound = []
        real_avg = mch.compound_average

        def avg_spy(*a, **k):
            compound.append(1)
            return real_avg(*a, **k)

        shown, first_comp = [], None
        mch.compound_average = avg_spy
        t0 = time.perf_counter()
        try:
            dec = StreamDecoder()
            for i, tu in enumerate(tus):
                before = len(compound)
                out = dec.decode_tu(tu)
                if out is not None:
                    shown.append(out)
                if first_comp is None and len(compound) > before:
                    first_comp = i
        finally:
            mch.compound_average = real_avg
        dec_s = time.perf_counter() - t0
        with open(d / "recon.yuv", "rb") as fh:
            recon = [(f.y, f.u, f.v) for f in
                     yuv.read_yuv_frames(fh, WIDTH, HEIGHT)]
    if len(shown) != RA_FRAMES or len(recon) != RA_FRAMES:
        raise SystemExit(f"app: {len(shown)} decoded and {len(recon)} "
                         f"recon frames, want {RA_FRAMES}")
    for i, (a, b) in enumerate(zip(shown, recon)):
        if not all(np.array_equal(pa, pb) for pa, pb in zip(a, b)):
            raise SystemExit(f"app: decoded frame {i} differs from the "
                             f"CLI's recon")
    if first_comp is None:
        raise SystemExit("app: the RA stream holds no compound block")
    print(f"[app] the port's decoder: {len(tus)} TUs, {len(shown)} frames "
          f"in {dec_s:.2f} s, each equal to the CLI's recon; first "
          f"compound block in TU {first_comp}", flush=True)
    t0 = time.perf_counter()
    blocks = check_ivf(io.BytesIO(_ivf_of(tus[:first_comp + 1])))
    chk_s = time.perf_counter() - t0
    print(f"[app] the independent checker over TUs 0-{first_comp}: "
          f"{blocks} blocks in {chk_s:.2f} s, no mismatch", flush=True)

    frame = make_clip(w=WIDTH, h=HEIGHT, frames=1, seed=3)[0]
    torch.cuda.synchronize()
    dev.LAUNCHES.clear()
    dev.LAUNCH_SHAPES.clear()
    t0 = time.perf_counter()
    handle, params = api.eb_init_handle()
    params.width, params.height, params.qp = WIDTH, HEIGHT, QP
    params.enc_mode, params.intra_period = PRESET, 0
    rcs = [api.eb_svt_enc_set_parameter(handle, params),
           api.eb_init_encoder(handle),
           api.eb_svt_enc_send_picture(handle,
                                       api.EbBufferHeaderType(pic=frame)),
           api.eb_svt_enc_send_picture(handle, None)]
    pkts = []
    while (buf := api.eb_svt_get_packet(handle, done=True)) is not None:
        pkts.append(buf.p_buffer)
        api.eb_svt_release_out_buffer(buf)
    rcs += [api.eb_deinit_encoder(handle), api.eb_deinit_handle(handle)]
    torch.cuda.synchronize()
    api_s = time.perf_counter() - t0
    api_shapes = dict(dev.LAUNCH_SHAPES)
    if any(rcs) or params.device != "cuda":
        raise SystemExit(f"app: the API lifecycle returned {rcs}")
    api_ivf = _ivf_of(pkts)
    sha = hashlib.sha256(api_ivf).hexdigest()
    print(f"[app] API lifecycle (eb_*, enc_mode {PRESET}, intra_period 0, "
          f"qp {QP}, device {params.device}): {len(pkts)} packet(s) in "
          f"{api_s:.2f} s, {len(api_ivf)} bytes as IVF, sha256 {sha}; "
          f"launches {_by_mode_n(api_shapes)}", flush=True)
    _check_stream("API", api_ivf, sha, GOLDEN_BYTES, GOLDEN_SHA256)
    shapes.update(api_shapes)
    t0 = time.perf_counter()
    api_blocks = check_ivf(io.BytesIO(api_ivf))
    api_chk_s = time.perf_counter() - t0
    print(f"[app] the independent checker over the API's key frame: "
          f"{api_blocks} blocks in {api_chk_s:.2f} s, no mismatch",
          flush=True)

    dev.LAUNCHES.clear()
    dev.LAUNCH_SHAPES.clear()
    warm_s = warm(WIDTH, HEIGHT, preset=PRESET, frames=2, verbose=False)
    warm_shapes = dict(dev.LAUNCH_SHAPES)
    if not warm_shapes:
        raise SystemExit("app: the warmup launched no kernel")
    shapes.update(warm_shapes)
    print(f"[app] warmup {WIDTH}x{HEIGHT} preset {PRESET}, 2 frames: "
          f"{warm_s:.2f} s; launches {_by_mode_n(warm_shapes)}", flush=True)
    return {"cli_wall_s": wall, "cli_fps": fps, "cli_bytes": len(ivf),
            "cli_spans": cli_spans, "cli_launch_shapes":
            _shape_keys(cli_shapes), "decode_s": dec_s,
            "decoded_frames": len(shown), "first_compound_tu": first_comp,
            "checker_tus": first_comp + 1, "checker_blocks": blocks,
            "checker_s": chk_s, "api_s": api_s, "api_bytes": len(api_ivf),
            "api_checker_blocks": api_blocks, "api_checker_s": api_chk_s,
            "warmup_s": warm_s}, shapes


def _plain_quantizer_spies(plain):
    """Spies that count, into ``plain``, every call of the quantizer's
    plain versions (which must never run on the card)."""
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import device_md as tmd

    def counted(nm):
        def wrap(fn):
            def call(*a, **k):
                plain[nm] += 1
                return fn(*a, **k)
            return call
        return wrap

    return [(tmd, nm, counted(nm)) for nm in
            ("quant_stage_plain", "rdoq_trim_j", "_rate_cdf_j")] \
        + [(dev, "quantize_qv_plain", counted("quantize_qv_plain"))]


def phase_multichip(torch, inter_s_per_frame: float):
    """The multi-device slice on ``["cuda:0"] * 4``: the tile-sharded key
    frame (sha256 against ``GOLDEN_MC_KEY_*``, halo, stats, each tile
    program's launches), the strip-sharded inter stream through
    ``encode_ivf`` (against ``GOLDEN_MC_INTER_*``, each strip's
    launches), and the distributed DLF on the key frame's recon
    against ``dlf_search_apply_dev`` on the card. The plain quantizer
    never runs. Returns (result, {(mode, B, n, log_scale): launches})."""
    import dataclasses

    import numpy as np

    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops.device import dlf_search_apply_dev
    from svt_av1_tpu_torch.parallel import tiles
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    from svt_av1_tpu_torch.utils.clip import make_clip
    from svt_av1_tpu_torch.utils.trace import TRACER
    devices = ["cuda:0"] * MC_DEVICES
    frames = make_clip(w=MC_WIDTH, h=MC_HEIGHT, frames=3, seed=3)
    plain = collections.Counter()
    spies = _plain_quantizer_spies(plain)
    shapes = collections.Counter()
    res = {"devices": devices}

    # --- 1: tile-sharded key frame
    kcfg = dataclasses.replace(preset_config(
        width=MC_WIDTH, height=MC_HEIGHT, qp=QP, preset=PRESET,
        intra_period=0, device="cuda"), fixed_partition_size=MC_LEAF)
    report = {}
    dev.LAUNCHES.clear()
    dev.LAUNCH_SHAPES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tu, halo_ok, stats = _run_patched(
        spies, lambda: tiles.encode_keyframe_tiles_sharded(
            *frames[0], kcfg, devices, report=report))
    torch.cuda.synchronize()
    key_s = time.perf_counter() - t0
    shapes.update(dev.LAUNCH_SHAPES)
    sha = hashlib.sha256(tu).hexdigest()
    print(f"[multichip] tile-sharded key frame {MC_WIDTH}x{MC_HEIGHT} "
          f"(preset {PRESET}, qp {QP}, {MC_LEAF}-px leaves) on {devices}: "
          f"{key_s:.2f} s, {len(tu)} bytes, sha256 {sha}; halo_ok "
          f"{halo_ok}, stats {stats}", flush=True)
    for i, t in enumerate(report["tiles"]):
        print(f"[multichip] tile {i} on {t['device']}: program "
              f"{t['seconds']:.3f} s, kernel launches {t['launches']}",
              flush=True)
    if sha != GOLDEN_MC_KEY_SHA256 or len(tu) != GOLDEN_MC_KEY_BYTES:
        raise SystemExit(f"sharded key frame differs from the JAX golden: "
                         f"{len(tu)} bytes sha256 {sha}")
    if not halo_ok or stats <= 0 or report["injected"] != MC_DEVICES:
        raise SystemExit(f"sharded key frame: halo_ok {halo_ok}, stats "
                         f"{stats}, injected {report['injected']}")
    if not all(t["launches"].get("quant_stage_rdoq", 0) > 0
               for t in report["tiles"]):
        raise SystemExit("a tile program launched no kernel")
    res["keyframe"] = {"seconds": key_s, "bytes": len(tu), "sha256": sha,
                       "halo_ok": halo_ok, "stats": stats,
                       "tiles": report["tiles"], "recon": report["recon"]}

    # --- 2: strip-sharded inter shape groups
    icfg = preset_config(width=MC_WIDTH, height=MC_HEIGHT, qp=QP,
                         preset=PRESET, intra_period=-1,
                         hierarchical_levels=1, device="cuda")
    report = {}
    issue = tiles.make_sharded_shape_group_issue(devices, MC_STRIP_W,
                                                 report=report)
    TRACER.enabled = True
    TRACER.reset()
    dev.LAUNCHES.clear()
    dev.LAUNCH_SHAPES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = _run_patched(spies, lambda: encode_ivf(frames, icfg,
                                                 shape_group_issue=issue))
    torch.cuda.synchronize()
    inter_wall = time.perf_counter() - t0
    TRACER.enabled = False
    shapes.update(dev.LAUNCH_SHAPES)
    sha = hashlib.sha256(ivf).hexdigest()
    frame_s = [sp["dur"] for sp in TRACER.spans
               if sp["stage"] == "inter_frame"]
    kf_s = sum(sp["dur"] for sp in TRACER.spans if sp["stage"] == "keyframe")
    print(f"[multichip] strip-sharded inter: 3 frames (key, then a "
          f"hier-1 mini-GOP) in {inter_wall:.2f} s, {len(ivf)} bytes, "
          f"sha256 {sha}; key frame {kf_s:.2f} s; inter frames "
          f"{(inter_wall - kf_s) / 2:.3f} s/frame over {MC_DEVICES} strips "
          f"of {MC_STRIP_W} (compute {frame_s}) beside [inter]'s unsharded "
          f"{inter_s_per_frame:.3f} s/frame at 1920x1080", flush=True)
    for i, st in enumerate(report["strips"]):
        print(f"[multichip] strip {i} on {st['device']}: {st['groups']} "
              f"shape groups, {st['blocks']} blocks, kernel launches "
              f"{dict(st['launches'])}", flush=True)
    _check_stream("strip-sharded inter", ivf, sha, GOLDEN_MC_INTER_BYTES,
                  GOLDEN_MC_INTER_SHA256)
    if not all(st["launches"].get("quant_stage_rdoq", 0) > 0
               for st in report["strips"]):
        raise SystemExit("a strip's shape groups launched no kernel")
    res["inter"] = {"seconds": inter_wall, "keyframe_s": kf_s,
                    "inter_s_per_frame": (inter_wall - kf_s) / 2,
                    "inter_frame_span_s": frame_s, "bytes": len(ivf),
                    "sha256": sha,
                    "strips": [dict(st, launches=dict(st["launches"]))
                               for st in report["strips"]]}

    # --- 3: distributed DLF on the key frame's recon
    rec = [np.asarray(p.cpu() if hasattr(p, "cpu") else p)
           for p in res["keyframe"].pop("recon")]
    mi_rows, mi_cols = MC_HEIGHT // 4, MC_WIDTH // 4
    step = MC_LEAF // 4
    leaf_sizes = {(r, c): MC_LEAF for r in range(0, mi_rows, step)
                  for c in range(0, mi_cols, step)}
    src = [p.astype(np.int64) for p in frames[0]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planes, levels = tiles.dlf_search_apply_sharded(
        rec, src, leaf_sizes, mi_rows, mi_cols, MC_QINDEX, 8, devices)
    torch.cuda.synchronize()
    dlf_s = time.perf_counter() - t0
    single = [p.copy() for p in rec]
    t0 = time.perf_counter()
    want = dlf_search_apply_dev(single, src, leaf_sizes, mi_rows, mi_cols,
                                MC_QINDEX, 8, device="cuda")
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    same = levels == want and all(np.array_equal(a, b)
                                  for a, b in zip(planes, single))
    print(f"[multichip] distributed DLF on the key frame's recon "
          f"(qindex {MC_QINDEX}): levels {levels}, "
          f"{MC_DEVICES} strips {dlf_s:.3f} s, single-device "
          f"dlf_search_apply_dev {single_s:.3f} s, equal {same}",
          flush=True)
    if not same:
        raise SystemExit(f"sharded DLF != dlf_search_apply_dev: {levels} "
                         f"vs {want}")
    if plain:
        raise SystemExit(f"the plain quantizer ran on the card: "
                         f"{dict(plain)}")
    print(f"[multichip] streams equal the JAX goldens, the DLF the "
          f"single-device filter; plain quantizer calls 0", flush=True)
    res["dlf"] = {"levels": levels, "seconds": dlf_s,
                  "single_device_s": single_s}
    res["checks_s"] = {"keyframe": key_s, "inter": inter_wall,
                       "dlf": dlf_s}
    return res, shapes


def _baseline_frames(clip: str, args: tuple):
    """A [baseline] clip: "hires" is the port's tools/smoke_hires clip,
    "bench" the port's utils/clip one (seed 3 both)."""
    if clip == "hires":
        from svt_av1_tpu_torch.tools.smoke_hires import make_clip
        return make_clip(*args)
    from svt_av1_tpu_torch.utils.clip import make_clip
    w, h, n = args
    return make_clip(w, h, frames=n, seed=3)


def _single_tile_spies(runs):
    """Spies on the one-tile key frame programs (``analyze_tile_fused``,
    ``analyze_tile_fused_mixed``): per call its name, whether it coded
    the tile and the kernel launches inside it, into ``runs``."""
    from svt_av1_tpu_torch.ops import device as dev
    from svt_av1_tpu_torch.ops import device_tile as tdt

    def spy(name):
        def wrap(fn):
            def call(enc, cands):
                before = sum(dev.LAUNCHES.values())
                ok = fn(enc, cands)
                runs.append({"program": name, "coded": ok,
                             "launches": sum(dev.LAUNCHES.values())
                             - before,
                             "stats": dict(enc.fused_stats) if ok
                             else None})
                return ok
            return call
        return wrap

    return [(tdt, nm, spy(nm)) for nm in ("analyze_tile_fused",
                                          "analyze_tile_fused_mixed")]


def _recon_spy(recons):
    """A spy on ``Encoder.get_packet`` that keeps each displayed recon."""
    from svt_av1_tpu_torch.pipeline.encoder import Encoder

    def wrap(fn):
        def call(self):
            pkt = fn(self)
            if pkt is not None and pkt[1] is not None:
                recons.append(pkt[1])
            return pkt
        return call
    return [(Encoder, "get_packet", wrap)]


def _baseline_point(torch, point, decode_pool) -> tuple:
    """One BASELINE.md operating point through ``encode_ivf`` on the card
    against its JAX golden: the stream and its TU count, the fused
    kernel launched and the plain trim and rate never, every key frame in
    a fused program (the one-tile program, or the frame program over all
    tiles) and the per-wave loop never; the hires4k stream goes to the
    port's mirror decoder in ``decode_pool`` (the future in the result's
    ``decode``). Prints spans, s/frame (key and inter apart), launches by
    mode and row length and the peak device memory. Returns (result,
    {(mode, B, n, log_scale): launches})."""
    import numpy as np

    from svt_av1_tpu_torch.app.cli import preset_config
    name, clip, args, options, tiles, golden_bytes, golden_sha, \
        golden_tus = point
    tag = f"baseline {name}"
    frames = _baseline_frames(clip, args)
    cfg = preset_config(**options, device="cuda")
    runs, recons = [], []
    spies = _single_tile_spies(runs) + _recon_spy(recons)
    torch.cuda.reset_peak_memory_stats()
    ivf, dt, launches, shapes, plain_calls, tracer, keys = _encode_counted(
        torch, frames, cfg, spies=spies)
    peak = torch.cuda.max_memory_allocated()
    sha = hashlib.sha256(ivf).hexdigest()
    tus = int.from_bytes(ivf[24:28], "little")
    spans = tracer.summary()
    key_s = [s["dur"] for s in tracer.spans if s["stage"] == "keyframe"]
    n_inter = len(frames) - len(key_s)
    inter_s = (dt - sum(key_s)) / n_inter if n_inter else None
    print(f"[{tag}] {cfg.width}x{cfg.height} {cfg.bit_depth}-bit "
          f"{options}: {len(frames)} frames in {dt:.2f} s "
          f"({dt / len(frames):.3f} s/frame), {tus} TUs, {len(ivf)} bytes, "
          f"sha256 {sha}; peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    print(f"[{tag}] key frames {len(key_s)}: "
          f"{[round(k, 3) for k in key_s]} s (their compute); inter frames "
          f"{n_inter}: " + (f"{inter_s:.3f} s/frame (wall after the key "
                            f"frames' compute, entropy drained)"
                            if n_inter else "none"), flush=True)
    for stage, v in spans.items():
        print(f"[{tag}] span {stage}: {v['count']} x, {v['total_s']} s",
              flush=True)
    by_mode_n = {f"{m} n={n}": v
                 for (m, n), v in sorted(_by_mode_n(shapes).items())}
    print(f"[{tag}] kernel launches by mode and row length {by_mode_n}",
          flush=True)
    _check_stream(tag, ivf, sha, golden_bytes, golden_sha)
    if tus != golden_tus:
        raise SystemExit(f"{tag}: {tus} TUs, the golden has {golden_tus}")
    if launches.get("quant_stage_rdoq", 0) + launches.get("quant_stage",
                                                           0) <= 0:
        raise SystemExit(f"{tag}: the fused kernel was never launched")
    if plain_calls:
        raise SystemExit(f"{tag}: the plain trim or rate ran: "
                         f"{plain_calls}")
    res = {"frames": len(frames), "tiles": tiles, "seconds": dt,
           "seconds_per_frame": dt / len(frames), "keyframe_compute_s": key_s,
           "inter_s_per_frame": inter_s, "bytes": len(ivf), "sha256": sha,
           "tus": tus, "peak_memory_bytes": peak, "launches": launches,
           "launch_shapes": _shape_keys(shapes), "spans": spans}
    if tiles > 1:
        res["keyframes"] = _keyframe_report(tag, keys, tracer, tiles)
    else:
        coded = [r for r in runs if r["coded"]]
        for r in coded:
            print(f"[{tag}] key frame: {r['program']} (span "
                  f"intra_tile_fused) {r['stats']}, {r['launches']} kernel "
                  f"launches inside it", flush=True)
        if len(coded) != len(key_s) or keys["code_wave"] \
                or any(rec["programs"] for rec in keys["frames"]) \
                or not all(r["launches"] for r in coded):
            raise SystemExit(f"{tag}: every key frame must run the one-tile "
                             f"program, launching the kernel, and never "
                             f"the frame program or the per-wave loop: "
                             f"{runs}, _code_wave {keys['code_wave']}")
        print(f"[{tag}] every key frame in the one-tile program; "
              f"run_tiles_fused and _code_wave never", flush=True)
        res["keyframes"] = runs
    if name == "hires4k":
        # the port's mirror decoder is host NumPy (about 90 s for these two
        # 4K frames): it runs in a process of its own, beside the phases
        # that follow, and phase_baseline_decode waits for it
        res["decode"] = decode_pool.submit(
            _decode_equals_recon, ivf, [[np.asarray(p) for p in r]
                                        for r in recons])
    return res, shapes


def _decode_equals_recon(ivf: bytes, recons) -> dict:
    """The port's mirror decoder over ``ivf`` against the encoder's
    displayed recons: frames decoded, whether every plane is equal, and
    the seconds it took."""
    import io

    import numpy as np

    from svt_av1_tpu_torch.pipeline.decode import decode_ivf
    t0 = time.perf_counter()
    decs = decode_ivf(io.BytesIO(ivf))
    same = len(decs) == len(recons) and all(
        np.array_equal(np.asarray(a), b)
        for d, r in zip(decs, recons) for a, b in zip(d, r))
    return {"frames": len(decs), "recons": len(recons), "equal": same,
            "seconds": time.perf_counter() - t0}


def phase_baseline(torch, decode_pool):
    """The four BASELINE.md operating points no other phase runs
    (``BASELINE``), each against its JAX golden. Returns (result,
    {(mode, B, n, log_scale): launches} over the four, those of
    hires4k)."""
    res, shapes = {}, collections.Counter()
    for point in BASELINE:
        t0 = time.perf_counter()
        res[point[0]], sh = _baseline_point(torch, point, decode_pool)
        res[point[0]]["check_s"] = time.perf_counter() - t0
        shapes.update(sh)
        if point[0] == "hires4k":
            hires = sh
    return res, shapes, hires


def phase_baseline_decode(res) -> dict:
    """Wait for the hires4k stream's mirror decode and fail unless it
    reproduced the encoder's recon of every frame."""
    hires = res["hires4k"]
    out = hires.pop("decode").result()
    print(f"[baseline hires4k] the port's mirror decoder (its own "
          f"process): {out['frames']} frames in {out['seconds']:.2f} s, "
          f"equal to the encoder's {out['recons']} recon frames: "
          f"{out['equal']}", flush=True)
    if not out["equal"] or not out["frames"] == out["recons"] \
            == hires["frames"]:
        raise SystemExit("baseline hires4k: the decoded stream differs "
                         "from the encoder's recon")
    hires["decode"] = out
    return out


def phase_kernel_maxima(torch, shapes) -> list:
    """Phase 3's sweep at the most rows the 4K run gave each mode, row
    length and log_scale: the kernel against its plain version, exact, at
    bit depth 10 (the 4K clip's), plane types 0 and 1."""
    most = {}
    for (mode, b, n, ls) in shapes:
        most[(mode, n, ls)] = max(most.get((mode, n, ls), 0), b)
    rows = []
    for (mode, n, ls), b in sorted(most.items()):
        ins = _stage_inputs(torch, n, ls, b, seed=n + b + ls)
        for pt in ((0,) if mode == "quantize_qv" else (0, 1)):
            row = _check(torch, mode, *ins, ls, pt, 10)
            if not row["exact"]:
                raise SystemExit(f"{mode} kernel != plain at {row}")
            rows.append(row)
    most_rows = {f"{m} n={n} ls={ls}": b
                 for (m, n, ls), b in sorted(most.items())}
    print(f"[kernel-4k] exact at the 4K run's most rows per mode, row "
          f"length and log_scale: {most_rows}", flush=True)
    return rows


def phase_postfilter_profile(torch, replay) -> dict:
    """One inter frame's post-filters replayed from clones of its
    deblocked planes: CDEF + LR together (``postfilter.run_postfilters``),
    then CDEF alone and LR alone (on the CDEF output, with the boundary
    lines of the deblocked planes). Each plain for its wall after a warm
    call, and under torch.profiler (device activity only) for its device
    busy ms and device operations."""
    from torch.profiler import ProfilerActivity, profile

    from svt_av1_tpu_torch.ops import device_cdef as tdc
    from svt_av1_tpu_torch.ops import device_lr as tdl
    from svt_av1_tpu_torch.pipeline import lr_search as tls
    from svt_av1_tpu_torch.pipeline import postfilter as tpf
    cfg, deblocked, src, tiles, mi_rows, mi_cols, lam = replay["args"]
    bounds = [tdl.deblock_bounds_dev(deblocked[p], (cfg.height + (p > 0))
                                     >> (p > 0), (cfg.width + (p > 0))
                                     >> (p > 0), int(p > 0))
              for p in range(3)]
    skip8 = tpf.cdef_skip8(tiles, mi_rows, mi_cols)
    bd, q = cfg.bit_depth, cfg.base_q_idx
    cdefed = [_clone(p) for p in deblocked]
    tdc.cdef_search_apply_dev(cdefed, src, skip8, mi_rows, mi_cols, q, bd,
                              device="cuda")
    runs = {
        "cdef + lr": (deblocked, lambda pl: tpf.run_postfilters(
            cfg, pl, src, tiles, mi_rows, mi_cols, lam)),
        "cdef": (deblocked, lambda pl: tdc.cdef_search_apply_dev(
            pl, src, skip8, mi_rows, mi_cols, q, bd, device="cuda")),
        "lr": (cdefed, lambda pl: tls.search_restoration_dev(
            pl, src, bounds, cfg.width, cfg.height, bd, q, lam,
            device="cuda"))}
    cuda = torch.autograd.DeviceType.CUDA
    res = {}
    for name, (planes, fn) in runs.items():
        def once() -> float:
            pl = [_clone(p) for p in planes]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(pl)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        once()                              # warm: caches, allocator
        wall_ms = once()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prof_wall_ms = once()
        dev_ns = [e.duration_ns()
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda]
        busy_ms = sum(dev_ns) / 1e6
        res[name] = {"wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
                     "device_busy_ms": busy_ms,
                     "device_busy_share": busy_ms / wall_ms if busy_ms
                     else None, "device_ops": len(dev_ns)}
        share = "not measured" if not busy_ms \
            else f"{100 * busy_ms / wall_ms:.2f}% of the plain wall"
        print(f"[postfilter-profile] one inter frame's {name} replayed: "
              f"wall {wall_ms:.2f} ms plain, {prof_wall_ms:.2f} ms "
              f"profiled; device busy {busy_ms:.3f} ms ({share}), "
              f"{len(dev_ns)} device ops", flush=True)
    return res


def phase_group_profile(torch, biggest, tag: str = "inter-profile") -> dict:
    """An encode's largest shape group (``_group_spy``) replayed once under
    torch.profiler, on clones of its frame's recon planes, with the
    searches its config ran: device operations, device busy ms, wall
    ms."""
    from torch.profiler import ProfilerActivity, profile

    from svt_av1_tpu_torch.ops import device_inter as di

    def run():
        recon = [p.clone() for p in biggest["recon"]]
        di.shape_group_issue(recon, *biggest["args"], **biggest["kw"])

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    size = biggest["args"][8]
    res = {"B": biggest["b"], "size": size, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy_us / 1e3, "device_ops": len(dev_events),
           "device_busy_share": busy_us / wall_us if busy_us else None}
    share = "not measured" if res["device_busy_share"] is None \
        else f"{100 * res['device_busy_share']:.2f}%"
    print(f"[{tag}] shape group {size}, B={res['B']}: wall "
          f"{res['wall_ms']:.2f} ms, device busy {res['device_busy_ms']:.3f}"
          f" ms ({share}), {res['device_ops']} device ops", flush=True)
    return res


def phase_directional_profile(torch, groups) -> dict:
    """One (step, shape) group of the directional key frame's per-wave
    loop replayed under torch.profiler (device activity only): the
    median-lane group of the most frequent shape, Y, U and V decides with
    the edge filter. Returns its wall ms, device busy ms and device
    operations. The replay rewrites that group's decisions and recon with
    the same values (the stream is already written)."""
    from torch.profiler import ProfilerActivity, profile

    from svt_av1_tpu_torch.pipeline import wavefront as twf
    shapes = collections.Counter((bw, bh) for _, bw, bh, _ in groups)
    (bw, bh), _ = shapes.most_common(1)[0]
    same = sorted((g for g in groups if (g[1], g[2]) == (bw, bh)),
                  key=lambda g: g[0])
    lanes, _, _, args = same[len(same) // 2]

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        twf.WavefrontIntraEncoder._code_wave(*args)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    wall_ms = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = run()
    cuda = torch.autograd.DeviceType.CUDA
    dev_ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
    busy_ms = sum(dev_ns) / 1e6
    res = {"shape": [bw, bh], "lanes": lanes, "groups_of_shape": len(same),
           "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
           "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms if busy_ms else None,
           "device_ops": len(dev_ns)}
    share = "not measured" if res["device_busy_share"] is None \
        else f"{100 * res['device_busy_share']:.2f}% of the plain wall"
    print(f"[directional-profile] one per-wave group (Y {bw}x{bh}, U/V "
          f"{bw // 2}x{bh // 2}, {lanes} lanes; median of the {len(same)} "
          f"groups of the most frequent shape): wall {wall_ms:.2f} ms plain, "
          f"{prof_wall_ms:.2f} ms profiled; device busy {busy_ms:.3f} ms "
          f"({share}), {len(dev_ns)} device ops", flush=True)
    return res


def phase_profile(torch, np) -> dict:
    """The per-wave path's reading: one wave of the main path's most
    frequent shape — luma
    16x16, U and V 8x8 with CfL, B=8 — through decide_block_batch_dev
    under torch.profiler, device kernel time over wall time."""
    from torch.profiler import ProfilerActivity, profile

    from svt_av1_tpu_torch.ops import quant as quant_ops
    from svt_av1_tpu_torch.ops.device_md import decide_block_batch_dev
    from svt_av1_tpu_torch.pipeline import rd
    rng = np.random.default_rng(5)
    b, qidx = 8, 70                  # the key frames' qindex at qp 40
    qp = quant_ops.make_quant_params(qidx)
    lam = rd.rd_lambda(qidx, 8)
    cands = [(0, 0), (1, 0), (2, 0), (12, 0)]

    def wave():
        for plane, s in ((0, 16), (1, 8), (2, 8)):
            srcs = rng.integers(0, 256, (b, s, s))
            edges = rng.integers(0, 256, (b, 1 + 2 * s)).astype(np.int32)
            kw = {}
            if plane:
                kw["cfl_luma"] = rng.integers(0, 256, (b, 2 * s, 2 * s))
            if plane == 2:
                kw["forced"] = (np.zeros(b, np.int64), np.zeros(b, np.int64))
            decide_block_batch_dev(plane, srcs, edges, edges,
                                   np.ones(b, bool), np.ones(b, bool), cands,
                                   qp, s, lam, nfl=1, rdoq=True,
                                   device="cuda", **kw)

    wave()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wave()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    kernels = len(dev_events)
    res = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / wall_us if busy_us else None,
           "device_ops": kernels}
    share = "not measured" if res["device_busy_share"] is None \
        else f"{100 * res['device_busy_share']:.2f}%"
    print(f"[profile] per-wave path, one wave (Y 16x16 + U/V 8x8, B={b}): "
          f"wall {res['wall_ms']:.2f} ms, device busy "
          f"{res['device_busy_ms']:.3f} ms ({share}), {kernels} device ops",
          flush=True)
    return res


def kernel_entries(torch, by_path, shapes, int32_ops) -> list:
    """The kernels line: one entry per mode and row length, each timed at
    the heaviest shape (B * n, then B) that the main path's runs gave
    it, against its plain version. A (mode, n) the runs never launched
    (the quantize-only mode but at n = 256, and some rows of the
    rate-only mode) is timed at the heaviest shape any mode had at that
    n, or at B=8160.
    ``by_path``: {path: {(mode, n): launches}}, each counted from 0 in its
    own run; ``ra_inter_frames`` is part of ``random_access``."""
    replaces = "svt_av1_tpu/ops/device.py:728 quantize_pallas " \
        "(quantize_qv contract, device.py:250)"
    fused = replaces + "; fused with _rate_cdf_j " \
        "svt_av1_tpu/ops/device_md.py:198"
    what = {
        "quantize_qv": ("quantize only", replaces),
        "quant_stage": ("quantize + rate (RDOQ off)", fused),
        "quant_stage_rdoq": ("quantize + RDOQ-lite trim + rate",
                             fused + " and rdoq_trim_j device_md.py:216")}
    heaviest, any_mode = {}, {}
    for k in shapes:
        mode, b, n, ls = k
        heaviest[(mode, n)] = max(heaviest.get((mode, n), k), k,
                                  key=lambda s: (s[1], s))
        any_mode[n] = max(any_mode.get(n, k), k, key=lambda s: (s[1], s))
    out = []
    for name in _modes():
        for n in _row_lengths():
            key = heaviest.get((name, n)) or any_mode.get(n) \
                or (name, 8160, n, 0)
            _, b, _, ls = key
            ins = _stage_inputs(torch, n, ls, b, seed=11 + n)
            row = _check(torch, name, *ins, ls)
            if not row["exact"]:
                raise SystemExit(f"{name} kernel != plain at {row}")
            _timed(torch, row, name, *ins, ls, int32_ops)
            by = {path: p.get((name, n), 0) for path, p in by_path.items()}
            out.append({
                "name": f"{name} n={n}", "route": "cuda",
                "source": "svt_av1_tpu_torch/csrc/quant.cu",
                "replaces": what[name][1], "mode": what[name][0],
                "launches": sum(v for path, v in by.items()
                                if path != "ra_inter_frames"),
                "launches_by_path": by,
                "exact": row["exact"], "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "kernel_ms": row["ms"],
                "call_ms": row["call_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "int_instr": row["int_instr"],
                "library_ms": None,
                "shape": {"B": b, "n": n, "log_scale": ls},
                "shape_from": "main path" if (name, n) in heaviest
                else "another mode's main-path shape" if n in any_mode
                else "synthetic"})
    for e in out:
        print(f"[kernels] {e['name']}: {e['launches']} launches "
              f"{e['launches_by_path']}; B={e['shape']['B']} "
              f"ls={e['shape']['log_scale']} ({e['shape_from']}): "
              f"{e['ms']:.5f} ms, plain {e['plain_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.5f} ms ({e['bound_by']})", flush=True)
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        return out

    env = timed("env", phase_environment, torch)
    build = timed("build", phase_build)
    grid = timed("kernel", phase_kernels, torch, env["int32_ops_per_s"])
    slice_res, shapes = timed("slice", phase_slice, torch)
    inter_res, inter_shapes, inter_frame_shapes, biggest = \
        timed("inter", phase_inter, torch)
    dir_res, dir_shapes = timed("directional", phase_directional, torch)
    dir_groups = dir_res.pop("groups")
    pf_res, pf_shapes, pf_replay = timed("postfilter", phase_postfilter,
                                         torch)
    search_res, search_shapes, search_group = timed("search", phase_search,
                                                    torch)
    aq_res, aq_shapes = timed("aq", phase_aq, torch)
    rc_res, rc_shapes = timed("rc", phase_rc, torch)
    entry_res, entry_shapes = timed("entry", phase_entry, torch)
    app_res, app_shapes = timed("app", phase_app, torch)
    mc_res, mc_shapes = timed("multichip", phase_multichip, torch,
                              inter_res["inter_s_per_frame"])
    decode_pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    base_res, base_shapes, hires_shapes = timed("baseline", phase_baseline,
                                                torch, decode_pool)
    maxima = timed("kernel-4k", phase_kernel_maxima, torch, hires_shapes)
    by_path = {"all_intra": _by_mode_n(shapes),
               "random_access": _by_mode_n(inter_shapes),
               "ra_inter_frames": _by_mode_n(inter_frame_shapes),
               "directional": _by_mode_n(dir_shapes),
               "postfilter": _by_mode_n(pf_shapes),
               "search": _by_mode_n(search_shapes),
               "aq": _by_mode_n(aq_shapes),
               "rc": _by_mode_n(rc_shapes),
               "entry": _by_mode_n(entry_shapes),
               "app": _by_mode_n(app_shapes),
               "multichip": _by_mode_n(mc_shapes),
               "baseline": _by_mode_n(base_shapes)}
    shapes = collections.Counter(shapes)
    shapes.update(inter_shapes)
    shapes.update(dir_shapes)
    shapes.update(pf_shapes)
    shapes.update(search_shapes)
    shapes.update(aq_shapes)
    shapes.update(rc_shapes)
    shapes.update(entry_shapes)
    shapes.update(app_shapes)
    shapes.update(mc_shapes)
    shapes.update(base_shapes)
    kernels = timed("kernels", kernel_entries, torch, by_path, shapes,
                    env["int32_ops_per_s"])
    group_prof = timed("inter-profile", phase_group_profile, torch, biggest)
    prof = timed("wave-profile", phase_profile, torch, np)
    dir_prof = timed("directional-profile", phase_directional_profile,
                     torch, dir_groups)
    pf_prof = timed("postfilter-profile", phase_postfilter_profile, torch,
                    pf_replay)
    search_prof = timed("search-profile", phase_group_profile, torch,
                        search_group, "search-profile")
    timed("baseline-decode", phase_baseline_decode, base_res)
    decode_pool.shutdown()
    phase_s["total"] = time.perf_counter() - t_start
    print("[time] " + ", ".join(f"{k} {v:.2f} s" for k, v in phase_s.items())
          + " (after the imports)", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"env": env, "build": build, "kernel_grid": grid,
                   "slice": slice_res, "inter": inter_res,
                   "directional": dir_res, "postfilter": pf_res,
                   "search": search_res, "aq": aq_res, "rc": rc_res,
                   "entry": entry_res, "app": app_res,
                   "multichip": mc_res, "baseline": base_res,
                   "kernel_4k_maxima": maxima,
                   "kernels": kernels, "shape_group_profile": group_prof,
                   "wave_profile": prof,
                   "directional_group_profile": dir_prof,
                   "postfilter_profile": pf_prof,
                   "search_profile": search_prof,
                   "phase_seconds": phase_s}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
