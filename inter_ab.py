#!/usr/bin/env python3
"""Time the random-access encode of two checkouts of this repository on
one card, in turns.

    python3 inter_ab.py OTHER_CHECKOUT

from the root of a checkout, on a machine with one CUDA device. Runs
the other checkout, this one, this one, the other — each in its own
process whose working directory is that checkout, so it imports that
checkout's ``svt_av1_tpu_torch`` (``quant_ab.run``). Every process
measures with this checkout's ``chip_smoke.phase_inter``: the 9-frame
1080p random-access clip through ``encode_ivf`` on ``cuda``, checked
against the JAX golden, with its seconds per frame and stage spans.
Each process also counts the flip apply's steps (one step is one shape
class's lanes of one wave) and their lanes. Prints one JSON line per run
and writes ``chiprun_out/inter_ab.json``.
"""

from __future__ import annotations

import json
import os
import sys

from quant_ab import run

CHILD = r"""
import collections
import importlib.util
import json
import sys
import torch
spec = importlib.util.spec_from_file_location("ab_timer", sys.argv[1])
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
from svt_av1_tpu_torch.ops import device_tile as dt
flip = collections.Counter()
stage = dt._flip_stage


def counted_stage(shape, *a, **k):
    step = stage(shape, *a, **k)

    def counted(recon, src, lanes, modes):
        flip["steps"] += 1
        flip["lanes"] += len(lanes["xs"])
        return step(recon, src, lanes, modes)
    return counted


dt._flip_stage = counted_stage
res = chip_smoke.phase_inter(
    torch, check_keyframes=hasattr(dt, "run_tiles_fused"))[0]
keep = ("seconds", "keyframe_compute_s", "inter_s_per_frame",
        "inter_compute_s_per_frame", "sha256", "flipped_blocks")
out = {k: res[k] for k in keep}
out["spans_s"] = {k: res["spans"].get(k, {}).get("total_s")
                  for k in chip_smoke.INTER_SPANS}
out["flip_steps"], out["flip_lanes"] = flip["steps"], flip["lanes"]
print(json.dumps(out))
"""


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    here = os.getcwd()
    other = os.path.abspath(sys.argv[1])
    runs = []
    for label, tree in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        out = run(tree, CHILD)
        out["tree"] = label
        runs.append(out)
        print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "inter_ab.json"), "w") as f:
        json.dump({"other": other, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
