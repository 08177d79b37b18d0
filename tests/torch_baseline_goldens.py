"""The JAX package's goldens of ``chip_smoke.py``'s ``[baseline]`` phase:
each operating point of ``chip_smoke.BASELINE`` through the JAX package's
``encode_ivf`` on its host backend, its bytes, sha256, temporal units
and seconds; ``--frames N`` cuts each clip to its first N frames (the
on-card tests' depth).

    JAX_PLATFORMS=cpu python -m tests.torch_baseline_goldens
        [--frames N] [NAME ...]

The clips come from the JAX package's side (``tools/smoke_hires.py``,
``bench.py``); ``tests/test_torch_tools.py`` holds the port's clips equal
to them.
"""

import argparse
import hashlib
import importlib.util
import json
import struct
import sys
import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parents[1]
# the JAX CLI's option defaults that preset_config reads
JAX_CLI_DEFAULTS = dict(bit_depth=8, intra_period=-1, fps=30, film_grain=0,
                        hierarchical_levels=0, tbr=0, lad=0)


def load_by_path(name: str, path: Path):
    """A module from its file (the repo's scripts are not a package)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_frames(clip: str, args: tuple):
    if clip == "hires":
        return load_by_path("jax_smoke_hires",
                            REPO / "tools" / "smoke_hires.py").make_clip(*args)
    import bench
    w, h, n = args
    return bench.make_clip(w, h, frames=n)


def jax_config(options: dict):
    from svt_av1_tpu.app.cli import preset_config
    return preset_config(SimpleNamespace(**{**JAX_CLI_DEFAULTS, **options,
                                            "backend": "host"}))


def ivf_frame_count(ivf: bytes) -> int:
    """The temporal units an IVF stream holds (its header's count)."""
    return struct.unpack_from("<I", ivf, 24)[0]


def golden(point, frames_cut=None) -> dict:
    from svt_av1_tpu.pipeline.encoder import encode_ivf
    name, clip, args, options = point[:4]
    frames = jax_frames(clip, args)[:frames_cut]
    t0 = time.perf_counter()
    ivf = encode_ivf(frames, jax_config(options))
    return {"name": name, "frames": len(frames), "bytes": len(ivf),
            "sha256": hashlib.sha256(ivf).hexdigest(),
            "tus": ivf_frame_count(ivf),
            "seconds": round(time.perf_counter() - t0, 2)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--frames", type=int, default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import chip_smoke
    for point in chip_smoke.BASELINE:
        if not a.names or point[0] in a.names:
            print(json.dumps(golden(point, a.frames)), flush=True)


if __name__ == "__main__":
    main()
