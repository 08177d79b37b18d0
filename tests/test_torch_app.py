"""The port's entry points (svt_av1_tpu_torch) against the JAX package's.

The encoder CLI (``svt_av1_tpu_torch.app.cli.main --device cpu``) against
the JAX CLI (``svt_av1_tpu.app.cli.main --backend host``) on the same
input files: the IVF (and recon) bytes must be identical, for y4m and
raw yuv input, a config file, a qp file, two channels and parallel GOPs.
The CLI through ``python -m`` writing to stdout loads no JAX module. The
EbApi-shaped lifecycle (``api``) and its bad-parameter answers, the
parallel GOP encoder and the warmup tool run on the CPU; without
``--device``, on a machine with no GPU, the CLI raises.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svt_av1_tpu import api as japi
from svt_av1_tpu.app import cli as jcli
from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu.pipeline import parallel as jparallel
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.app import cli
from svt_av1_tpu_torch.app.warmup import warm
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.pipeline import parallel
from svt_av1_tpu_torch.utils.clip import make_clip, write_y4m
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
W, H = 128, 64


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A 4-frame 128x64 clip as y4m (30:1) and as raw yuv, and a second
    clip's y4m for a second channel."""
    d = tmp_path_factory.mktemp("clips")
    frames = make_clip(w=W, h=H, frames=4, seed=3)
    write_y4m(d / "a.y4m", frames)
    write_y4m(d / "b.y4m", make_clip(w=W, h=H, frames=3, seed=5))
    with open(d / "a.yuv", "wb") as fh:
        for planes in frames:
            for p in planes:
                fh.write(p.tobytes())
    (d / "qp.txt").write_text("30\n-1\n50\n")
    return d


# name: (argv with {d} for the inputs' directory and {o} for the outputs'
#        (the same for both CLIs), config-file lines or None, output files)
CASES = {
    "y4m": (["-i", "{d}/a.y4m", "-b", "{o}/a.ivf", "--preset", "5",
             "--hierarchical-levels", "2"], None, ["a.ivf"]),
    "yuv": (["-i", "{d}/a.yuv", "-w", str(W), "-h2", str(H), "-n", "3",
             "-b", "{o}/a.ivf", "--preset", "8", "-q", "33"], None,
            ["a.ivf"]),
    "config_file": (["--preset", "6"],
                    ["InputFile : {d}/a.y4m", "StreamFile : {o}/a.ivf",
                     "QP = 45", "EncoderMode : 8", "IntraPeriod : 1",
                     "# a comment line", "FrameToBeEncoded : 3"],
                    ["a.ivf"]),
    "qp_file": (["-i", "{d}/a.y4m", "-b", "{o}/a.ivf", "--preset", "7",
                 "--qp-file", "{d}/qp.txt"], None, ["a.ivf"]),
    "two_channels": (["-i", "{d}/a.y4m,{d}/b.y4m", "-b",
                      "{o}/a.ivf,{o}/b.ivf", "--nch", "2", "--preset", "7"],
                     None, ["a.ivf", "b.ivf"]),
    "parallel_gops": (["-i", "{d}/a.y4m", "-b", "{o}/a.ivf", "--jobs", "2",
                       "--intra-period", "1", "--preset", "7"], None,
                      ["a.ivf"]),
    "recon": (["-i", "{d}/a.y4m", "-b", "{o}/a.ivf", "-o", "{o}/r.yuv",
               "--preset", "7", "--tile-columns", "1", "--trace",
               "{o}/t.json"], None, ["a.ivf", "r.yuv"]),
}


def _run_cli(main, case, d, out, device_args, cfg_token):
    argv, cfg_lines, outs = CASES[case]
    out.mkdir()
    argv = [a.format(d=d, o=out) for a in argv] + ["--no-stats"]
    if cfg_lines is None:
        argv += device_args
    else:
        cfg = out / "enc.cfg"
        cfg.write_text("\n".join([ln.format(d=d, o=out) for ln in cfg_lines]
                                 + [cfg_token]) + "\n")
        argv += ["-c", str(cfg)]
    assert main(argv) == 0
    return {name: (out / name).read_bytes() for name in outs}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_equals_the_jax_cli(case, inputs, tmp_path):
    want = _run_cli(jcli.main, case, inputs, tmp_path / "jax",
                    ["--backend", "host"], "Backend : host")
    got = _run_cli(cli.main, case, inputs, tmp_path / "port",
                   ["--device", "cpu"], "Device : cpu")
    for name in want:
        assert len(got[name]) > 44, name
        assert got[name] == want[name], name
    if case == "recon":               # no kernel launches on the CPU
        trace = json.loads((tmp_path / "port" / "t.json").read_text())
        assert trace["spans"] and trace["kernel_launches"] == {}
        assert set(trace["clock"]) == {"time_ns", "perf_counter_ns"}
        assert "encoder_init" in {e["stage"] for e in trace["setup"]}
    if case == "parallel_gops":       # closed GOPs: the serial stream
        serial = _run_cli(cli.main, case, inputs, tmp_path / "serial",
                          ["--device", "cpu", "--jobs", "1"], None)
        assert serial["a.ivf"] == got["a.ivf"]


def test_cli_stream_equals_encode_ivf(tmp_path):
    """The CLI on a 30:1 y4m of ``make_clip`` writes ``encode_ivf``'s
    bytes for the same frames and options (so ``chip_smoke.py`` holds the
    CLI's 1080p stream to the RA golden of ``encode_ivf``)."""
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    frames = make_clip(w=256, h=128, frames=5, seed=3)
    write_y4m(tmp_path / "c.y4m", frames)
    assert cli.main(["-i", str(tmp_path / "c.y4m"), "-b",
                     str(tmp_path / "c.ivf"), "-q", "40", "--preset", "5",
                     "--hierarchical-levels", "3", "--no-stats",
                     "--device", "cpu"]) == 0
    cfg = cli.preset_config(width=256, height=128, qp=40, preset=5,
                            hierarchical_levels=3, device="cpu")
    assert (tmp_path / "c.ivf").read_bytes() == encode_ivf(frames, cfg)


def test_cli_writes_stdout_without_jax(inputs, tmp_path):
    """``python -m svt_av1_tpu_torch.app ... -b -``: the IVF on stdout
    equals the file the JAX CLI writes (its frame count patched in, which
    a pipe cannot take: the header keeps 0), and the process imports no
    module of JAX or of the JAX package (``-X importtime`` lists every
    import on stderr)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "svt_av1_tpu_torch.app",
         "-i", str(inputs / "a.y4m"), "-b", "-", "--preset", "8",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, timeout=300, check=True)
    imported = [ln.rsplit("|", 1)[-1].strip()
                for ln in res.stderr.decode().splitlines()
                if ln.startswith("import time:")]
    assert "svt_av1_tpu_torch.pipeline.encoder" in imported
    bad = [m for m in imported if m.split(".")[0] in ("jax", "svt_av1_tpu")]
    assert not bad, bad
    out = tmp_path / "jax.ivf"
    assert jcli.main(["-i", str(inputs / "a.y4m"), "-b", str(out),
                      "--preset", "8", "--no-stats"]) == 0
    want = bytearray(out.read_bytes())
    want[24:28] = bytes(4)
    assert res.stdout == bytes(want)
    assert b"fps encode speed" in res.stderr


def _lifecycle(mod, frames, **params):
    """Drive the EbApi lifecycle; returns (stream header, [(bytes, flags,
    pts, recon)])."""
    handle, p = mod.eb_init_handle()
    for k, v in params.items():
        setattr(p, k, v)
    assert mod.eb_svt_enc_set_parameter(handle, p) == mod.EB_ErrorNone
    assert mod.eb_init_encoder(handle) == mod.EB_ErrorNone
    hdr = mod.eb_svt_enc_stream_header(handle).p_buffer
    pkts = []
    for f in frames:
        assert mod.eb_svt_enc_send_picture(
            handle, mod.EbBufferHeaderType(pic=f)) == mod.EB_ErrorNone
    assert mod.eb_svt_enc_send_picture(handle, None) == mod.EB_ErrorNone
    while (buf := mod.eb_svt_get_packet(handle, done=True)) is not None:
        assert mod.eb_svt_get_recon(handle, buf) in (
            mod.EB_ErrorNone, mod.EB_ErrorBadParameter)
        pkts.append((buf.p_buffer, buf.flags, buf.pts, buf.recon))
        mod.eb_svt_release_out_buffer(buf)
        assert buf.p_buffer == b"" and buf.recon is None
    assert mod.eb_deinit_encoder(handle) == mod.EB_ErrorNone
    assert mod.eb_deinit_handle(handle) == mod.EB_ErrorNone
    return hdr, pkts


def test_api_lifecycle_equals_the_jax_api():
    frames = make_clip(w=W, h=H, frames=3, seed=7)
    params = dict(width=W, height=H, qp=38, enc_mode=5,
                  hierarchical_levels=1, tile_columns=1)
    want = _lifecycle(japi, frames, **params)
    got = _lifecycle(api, frames, device="cpu", **params)
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1]) == 4      # one show-existing TU
    assert got[1][-1][1] & api.EB_BUFFERFLAG_EOS
    for (gb, gf, gp, gr), (wb, wf, wp, wr) in zip(got[1], want[1]):
        assert (gb, gf, gp) == (wb, wf, wp)
        assert (gr is None) == (wr is None)
        for a, b in zip(gr or (), wr or ()):
            np.testing.assert_array_equal(a, b)


def test_api_bad_parameters_as_the_jax_api():
    for mod, extra in ((japi, {}), (api, {"device": "cpu"})):
        handle, p = mod.eb_init_handle()
        # before set_parameter / init_encoder: the lifecycle refuses
        assert mod.eb_init_encoder(handle) == mod.EB_ErrorBadParameter
        assert mod.eb_svt_enc_stream_header(handle) \
            == mod.EB_ErrorBadParameter
        assert mod.eb_svt_enc_send_picture(handle, None) \
            == mod.EB_ErrorBadParameter
        for k, v in extra.items():
            setattr(p, k, v)
        for field, value in (("width", 63), ("height", 8), ("qp", 64),
                             ("bit_depth", 12)):
            setattr(p, field, value)
            assert mod.eb_svt_enc_set_parameter(handle, p) \
                == mod.EB_ErrorBadParameter, field
            p = mod.eb_init_handle()[1]
            for k, v in extra.items():
                setattr(p, k, v)
    handle, p = api.eb_init_handle()
    p.device = "tpu"
    assert api.eb_svt_enc_set_parameter(handle, p) \
        == api.EB_ErrorBadParameter


def test_encode_parallel_equals_serial_and_jax():
    frames = make_clip(w=W, h=H, frames=5, seed=9)
    kw = dict(width=W, height=H, intra_period=1, intra_modes=(0, 1, 2, 12),
              scene_change_detection=False)
    cfg = EncoderConfig(device="cpu", **kw)
    assert parallel.gop_chunks(5, cfg) == [(0, 2), (2, 4), (4, 5)]
    got = parallel.encode_parallel(frames, cfg, jobs=2)
    serial = parallel.encode_parallel(frames, cfg, jobs=1)
    want = jparallel.encode_parallel(frames, JaxConfig(**kw), jobs=2)
    assert len(got) == len(serial) == len(want) == 5
    for g, s, w in zip(got, serial, want):
        assert g[0] == s[0] == w[0]
        for a, b, c in zip(g[1], s[1], w[1]):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
    with pytest.raises(ValueError, match="closed GOPs"):
        parallel.encode_parallel(frames, EncoderConfig(device="cpu"), 2)


def test_warmup_runs_on_the_cpu():
    assert warm(64, 64, preset=5, frames=2, device="cpu",
                verbose=False) > 0


def test_cli_without_device_needs_the_card(inputs, tmp_path):
    """No ``--device``: the CLI runs on the card or raises; it never
    encodes on the CPU behind the caller's back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-i", str(inputs / "a.y4m"), "-b",
                  str(tmp_path / "a.ivf"), "--no-stats"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm(64, 64, preset=5, frames=1, verbose=False)
