#!/usr/bin/env python3
"""Time the quantizer of two checkouts of this repository on one card,
in turns.

    python3 quant_ab.py OTHER_CHECKOUT

from the root of a checkout, on a machine with one CUDA device. Runs
the other checkout, this one, this one, the other — each in its own
process whose working directory is that checkout, so it imports that
checkout's ``svt_av1_tpu_torch``. Every process measures with this
checkout's ``chip_smoke.py`` (loaded from its path), so both trees are
timed by the same code: ``quantize_qv`` on CUDA tensors
(``chip_smoke._time_ms``: device ms from CUDA events around 10
back-to-back calls behind a device-side sleep, median of 21; host ms
per call over 10 calls with a synchronize, median of 5 windows) at B=8
and B=8160 for n in 16, 64, 256, 1024 (log_scale 0, random levels,
random qindex), then ``chip_smoke.phase_profile`` (one profiled wave of
the main path: wall time, device busy time, device operations). Prints
one JSON line per run and writes ``chiprun_out/quant_ab.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import importlib.util
import json
import sys
import numpy as np
import torch
spec = importlib.util.spec_from_file_location("ab_timer", sys.argv[1])
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
from svt_av1_tpu_torch.ops import device as dev
from svt_av1_tpu_torch.utils.blocks import (TX_4X4, TX_8X8, TX_16X16,
                                            TX_32X32, get_scan)
rows = []
for n, tx in ((16, TX_4X4), (64, TX_8X8), (256, TX_16X16),
              (1024, TX_32X32)):
    scan = get_scan(tx, 0)
    for b in (8, 8160):
        rng = np.random.default_rng(n + b)
        c = torch.as_tensor(rng.integers(-4096, 4097, (b, n)).astype(
            np.int32), device="cuda")
        q = torch.as_tensor(rng.integers(0, 256, b).astype(np.int32),
                            device="cuda")
        ms, call_ms = chip_smoke._time_ms(
            torch, lambda: dev.quantize_qv(c, scan, q, 0, 8))
        rows.append({"n": n, "B": b, "ms": ms, "call_ms": call_ms})
prof = chip_smoke.phase_profile(torch, np)
print(json.dumps({"quantize_qv": rows, "wave": prof}))
"""


def run(tree: str, child: str = CHILD) -> dict:
    """Run ``child`` in ``tree`` with this checkout's chip_smoke.py as its
    argument; returns the JSON of its last output line."""
    timer = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "chip_smoke.py")
    res = subprocess.run([sys.executable, "-c", child, timer], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"run in {tree} failed:\n{res.stdout}\n"
                         f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    here = os.getcwd()
    other = os.path.abspath(sys.argv[1])
    runs = []
    for label, tree in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        out = run(tree)
        out["tree"] = label
        runs.append(out)
        print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "quant_ab.json"), "w") as f:
        json.dump({"other": other, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
