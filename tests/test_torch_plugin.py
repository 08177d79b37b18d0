"""The FFmpeg plugin twin (``ffmpeg_plugin/libsvt_av1_tpu_torch.c``)
against the JAX one (``libsvt_av1_tpu.c``): the encoder argv each plugin
``execlp``s differs only in the module name, and the two CLIs behind it,
fed the same y4m on stdin, write the same IVF bytes on stdout (the JAX
CLI on its host backend, the port's with ``--device cpu``). Neither C file
is compiled here: that needs an FFmpeg tree."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from svt_av1_tpu_torch.utils.clip import make_clip, write_y4m

REPO = Path(__file__).resolve().parents[1]
PLUGINS = {"jax": REPO / "ffmpeg_plugin" / "libsvt_av1_tpu.c",
           "port": REPO / "ffmpeg_plugin" / "libsvt_av1_tpu_torch.c"}
MODULES = {"jax": "svt_av1_tpu.app.cli", "port": "svt_av1_tpu_torch.app"}
# the plugin's option strings, as the tests fill them in
OPTIONS = {"arg_q": "40", "arg_preset": "5", "arg_n": "2"}


def execlp_argv(path: Path) -> list:
    """The argv (after the file argument) of the plugin's execlp call:
    its string literals, and its option variables by name."""
    src = path.read_text()
    calls = re.findall(r"execlp\((.*?)\(char \*\)NULL\)", src, re.S)
    assert len(calls) == 1, path
    args = [a.strip() for a in calls[0].split(",") if a.strip()]
    out = []
    for a in args[1:]:
        lit = re.fullmatch(r'"([^"]*)"', a)
        out.append(lit.group(1) if lit else a)
    return out


def test_plugin_argvs_differ_only_in_the_module():
    jax, port = (execlp_argv(PLUGINS[k]) for k in ("jax", "port"))
    assert jax[:2] == ["python3", "-m"] and port[:2] == jax[:2]
    assert (jax[2], port[2]) == (MODULES["jax"], MODULES["port"])
    assert jax[3:] == port[3:]
    assert jax[3:] == ["-i", "-", "-b", "-", "--no-stats", "-q", "arg_q",
                       "--preset", "arg_preset", "--hierarchical-levels",
                       "arg_n"]


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    path = tmp_path_factory.mktemp("plugin") / "in.y4m"
    write_y4m(path, make_clip(w=64, h=64, frames=3, seed=3))
    return path.read_bytes()


def _run_plugin_argv(which: str, data: bytes, extra=()) -> bytes:
    argv = [OPTIONS.get(a, a) for a in execlp_argv(PLUGINS[which])]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable] + argv[1:] + list(extra),
                         input=data, capture_output=True, cwd=REPO,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    return res.stdout


def test_port_cli_behind_the_twin_equals_the_jax_cli(y4m):
    want = _run_plugin_argv("jax", y4m)
    got = _run_plugin_argv("port", y4m, ["--device", "cpu"])
    assert want[:4] == b"DKIF" and len(want) > 44
    assert got == want
