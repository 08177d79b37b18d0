"""The port's twins of the repo's tools and bench against the JAX ones.

``svt_av1_tpu_torch/tools/`` (smoke_hires, trace_encode, quality_report,
rd_experiment) and ``bench_torch.py`` on ``device="cpu"`` against the JAX
package's scripts (``tools/*.py``, ``bench.py``, loaded by file path) on
its host backend, at small sizes: the same clips, the same bytes, the
same PSNR.
"""

import dataclasses
import hashlib
import io
import json
import re
import sys
import tempfile
from contextlib import redirect_stdout
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import bench
import bench_torch
from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu.utils.trace import TRACER as JAX_TRACER
from svt_av1_tpu_torch.app.cli import preset_config
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.tools import (quality_report, rd_experiment,
                                     smoke_hires, trace_encode)
from svt_av1_tpu_torch.utils import trace
from tests.torch_baseline_goldens import JAX_CLI_DEFAULTS, load_by_path
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JAX_TOOLS = {name: load_by_path(f"jax_{name}", REPO / "tools" / f"{name}.py")
             for name in ("smoke_hires", "trace_encode", "quality_report",
                          "rd_experiment")}


def _jax_cfg(**options):
    return jax_preset_config(SimpleNamespace(
        **{**JAX_CLI_DEFAULTS, **options, "backend": "host"}))


def _stdout(fn, *a, **k) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*a, **k)
    return buf.getvalue()


@pytest.mark.parametrize("bd", [8, 10])
def test_smoke_hires_clip_equals_the_jax_tool(bd):
    got = smoke_hires.make_clip(96, 48, 3, bd)
    want = JAX_TOOLS["smoke_hires"].make_clip(96, 48, 3, bd)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_smoke_hires_run_equals_the_jax_tool():
    """The 4K config's options at 256x144 (10-bit, flat, 2 frames)."""
    opts = dict(width=256, height=144, qp=40, bit_depth=10, preset=5)
    frames = smoke_hires.make_clip(256, 144, 2, 10)
    got = smoke_hires.run("port", preset_config(**opts, device="cpu"),
                          frames)
    want = JAX_TOOLS["smoke_hires"].run("jax", _jax_cfg(**opts), frames)
    for k in ("frames", "bytes", "min_psnr"):
        assert got[k] == want[k], k


def test_smoke_hires_configs_are_the_jax_tools():
    """The two operating points' configs equal the JAX tool's
    (``preset_config`` of its namespaces), the device apart."""
    cfgs = smoke_hires.configs("cpu")
    want = {"4k": _jax_cfg(width=3840, height=2160, qp=40, bit_depth=10,
                           preset=5),
            "vbr10": _jax_cfg(width=1920, height=1080, qp=40, bit_depth=10,
                              preset=5, hierarchical_levels=3, tbr=3000,
                              lad=17)}
    for key, (_, cfg, (w, h, bd), _) in cfgs.items():
        assert cfg == config_from_jax(dataclasses.asdict(want[key]),
                                      device="cpu"), key
        assert (cfg.width, cfg.height, cfg.bit_depth) == (w, h, bd)


@pytest.fixture(scope="module")
def small_ra():
    """bench's operating point cut to 128x64, 3 frames, hier 2."""
    frames = bench.make_clip(128, 64, frames=3)
    opts = dict(width=128, height=64, qp=40, preset=5, intra_period=-1,
                hierarchical_levels=2)
    return frames, opts, jax_encode_ivf(frames, _jax_cfg(**opts))


def test_bench_encode_once_equals_the_jax_bench(small_ra):
    frames, opts, jax_ivf = small_ra
    nbytes, ivf = bench_torch.encode_once(
        frames, preset_config(**opts, device="cpu"))
    assert nbytes == bench.encode_once(frames, _jax_cfg(**opts))
    assert ivf == jax_ivf


def test_bench_main_checks_its_stream(small_ra, monkeypatch):
    """main() at the small point prints one JSON line with bench.py's keys
    under its own metric name when the stream is the golden, and refuses
    a stream off it."""
    frames, opts, jax_ivf = small_ra
    monkeypatch.setattr(bench_torch, "WIDTH", 128)
    monkeypatch.setattr(bench_torch, "HEIGHT", 64)
    monkeypatch.setattr(bench_torch, "FRAMES", 3)
    # main's config is hier 3: the golden of that stream
    cfg = _jax_cfg(**{**opts, "hierarchical_levels": 3})
    want = jax_encode_ivf(frames, cfg)
    monkeypatch.setattr(bench_torch, "GOLDEN_RA_SHA256",
                        hashlib.sha256(want).hexdigest())
    monkeypatch.setattr(bench_torch, "GOLDEN_RA_BYTES", len(want))
    out = _stdout(bench_torch.main, ["--device", "cpu"])
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == {"metric", "value", "unit", "vs_baseline"}
    assert res["metric"] == "1080p_e2e_encode_fps_torch_cpu"
    assert res["value"] > 0 and res["unit"] == "frames/s"
    monkeypatch.setattr(bench_torch, "GOLDEN_RA_BYTES", len(want) + 1)
    with pytest.raises(SystemExit, match="differs from the JAX golden"):
        bench_torch.main(["--device", "cpu"])


def test_trace_encode_emits_the_jax_tools_bytes(monkeypatch):
    """Both tools at 128x64, 3 frames, preset 5, qp 45: the timed pass's
    byte count, and the port's span summary holds the key frame."""
    argv = ["128", "64", "3", "5"]
    monkeypatch.setattr(trace.TRACER, "enabled", False)
    port_out = _stdout(trace_encode.main, argv + ["cpu", "45"])
    monkeypatch.setattr(JAX_TRACER, "enabled", False)
    monkeypatch.setattr(sys, "argv", ["trace_encode.py"] + argv
                        + ["host", "45"])
    jax_out = _stdout(JAX_TOOLS["trace_encode"].main)
    timed = re.compile(r"^\[timed\] 3 frames in .* fps, (\d+) bytes$", re.M)
    assert timed.findall(port_out) == timed.findall(jax_out)
    assert len(timed.findall(port_out)) == 1
    assert '"keyframe"' in port_out and '"kernel_launches"' in port_out


@pytest.mark.parametrize("config", range(len(quality_report.CONFIGS)))
def test_quality_report_point_equals_the_jax_tool(config):
    """One point of each dashboard config on a 128x112, 2-frame suite:
    bytes and mean Y-PSNR, every TU decoded to the encoder's recon."""
    jq = JAX_TOOLS["quality_report"]
    frames = quality_report._suite(128, 112, 2)
    for a, b in zip(frames, jq._suite(128, 112, 2)):
        for p, q in zip(a, b):
            assert np.array_equal(p, q)
    name, kw = quality_report.CONFIGS[config]
    got = quality_report.run_point(frames, "cpu", qp=45, **kw)
    want = jq.run_point(frames, qp=45, **kw)
    assert got[:2] == want[:2], name


def test_rd_experiment_ours_only_equals_the_jax_tool(monkeypatch,
                                                     tmp_path):
    """--ours-only at 128x64, 2 frames, qp 40, lambda x4, AQ 0 and 1: the
    printed bytes and PSNR are the JAX tool's ``run_ours``'s."""
    monkeypatch.setenv("SVT_TPU_LAMBDA_SCALE", "1")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = _stdout(rd_experiment.main, [
        "--ours-only", "--w", "128", "--h", "64", "--n", "2", "--qps", "40",
        "--scales", "4", "--aq", "0,1", "--device", "cpu"])
    got = re.findall(r"^OURS  q=40 lam x4 +aq=(\d) bytes= *(\d+) "
                     r"ypsnr= *([\d.]+)", out, re.M)
    jr = JAX_TOOLS["rd_experiment"]
    frames = jr.make_clip(128, 64, 2)
    want = []
    for aq in (0, 1):
        b, p, _ = jr.run_ours(frames, 128, 64, 40, 4.0, aq)
        want.append((str(aq), str(b), f"{p:.2f}"))
    assert got == want
