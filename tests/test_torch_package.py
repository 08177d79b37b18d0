"""Boundaries of the PyTorch port (svt_av1_tpu_torch).

The port imports nothing of JAX and nothing of the JAX package (an
all-intra, an inter encode and one with the rate and analysis tools load
every module of the port's main path), keeps its own copies of the
constant tables (equal to the JAX package's), has a counterpart of every
module and function of the JAX package (ROADMAP.md's "Not yet ported"
list is empty, and NOT_PORTED with it), carries a JAX config across, the
unread ``mesh_shape`` included, accepts every tool, and never falls back
to the CPU when it was asked for the card.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.convert import TABLES, config_from_jax, load_tables

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "svt_av1_tpu_torch"
JAX_SRC = REPO / "svt_av1_tpu"
# what the port does not have yet, as ROADMAP.md's "Not yet ported" list
# names it: JAX package modules, and functions (module::name) of modules
# the port has
NOT_PORTED = set()
# the JAX package by name; svt_av1_tpu_torch shares its prefix
JAX_PKG = re.compile(r"\bsvt_av1_tpu\b(?!_torch)")
IMPORT = re.compile(r"^\s*(?:from\s+(\S+)\s+import|import\s+(\S+))")
INTRA = dict(intra_period=0, intra_modes=(0, 1, 2, 12), width=64,
             height=64)


def test_port_sources_import_no_jax():
    files = sorted(f for f in PORT.rglob("*.py")
                   if (PORT / "build") not in f.parents)
    files += [REPO / "chip_smoke.py", REPO / "quant_ab.py",
              REPO / "inter_ab.py", REPO / "bench_torch.py"]
    assert len(files) > 30
    bad = []
    for f in files:
        for ln, line in enumerate(f.read_text().splitlines(), 1):
            m = IMPORT.match(line)
            if not m:
                continue
            mod = m.group(1) or m.group(2)
            if mod.split(".")[0] == "jax" or JAX_PKG.search(mod):
                bad.append(f"{f.relative_to(REPO)}:{ln}: {line.strip()}")
    assert not bad, bad


def test_port_runs_without_jax_modules():
    """Importing the port and running a 64x64 CPU encode loads no jax and
    no module of the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "from svt_av1_tpu_torch.config import EncoderConfig\n"
        "from svt_av1_tpu_torch.pipeline.encoder import encode_ivf\n"
        "rng = np.random.default_rng(0)\n"
        "f = (rng.integers(0, 256, (64, 64), dtype=np.uint8),\n"
        "     rng.integers(0, 256, (32, 32), dtype=np.uint8),\n"
        "     rng.integers(0, 256, (32, 32), dtype=np.uint8))\n"
        "cfg = EncoderConfig(width=64, height=64, intra_period=0,\n"
        "                    intra_modes=(0, 1, 2, 12), device='cpu')\n"
        "ivf = encode_ivf([f], cfg)\n"
        "assert len(ivf) > 44\n"
        "cfg = EncoderConfig(width=64, height=64, intra_period=-1,\n"
        "                    hierarchical_levels=1,\n"
        "                    fixed_partition_size=None,\n"
        "                    intra_modes=(0, 1, 2, 12), device='cpu')\n"
        "g = tuple(np.ascontiguousarray(p[::-1]) for p in f)\n"
        "ivf = encode_ivf([f, g, f], cfg)\n"
        "assert len(ivf) > 44\n"
        "cfg = EncoderConfig(width=64, height=64, intra_period=-1,\n"
        "                    hierarchical_levels=1, intra_dp_satd=True,\n"
        "                    fixed_partition_size=None,\n"
        "                    adaptive_quantization=2, rate_control_mode=1,\n"
        "                    target_bit_rate=100000, look_ahead_distance=2,\n"
        "                    film_grain_strength=-1,\n"
        "                    enable_source_denoise=True,\n"
        "                    intra_modes=(0, 1, 2, 12), device='cpu')\n"
        "ivf = encode_ivf([f, g, f], cfg)\n"
        "assert len(ivf) > 44\n"
        "print(' '.join(sorted(sys.modules)))\n")
    # one torch thread: the suite's workers share few cores
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    for mod in ("pipeline.wavefront", "pipeline.inter", "pipeline.mvp",
                "ops.device_inter", "ops.device_tile", "entropy.inter_modes",
                "pipeline.analysis", "pipeline.rc", "ops.grain",
                "entropy.delta"):
        assert "svt_av1_tpu_torch." + mod in out, mod
    loaded = [m for m in out if m.split(".")[0] == "jax"
              or JAX_PKG.match(m)]
    assert not loaded, loaded


def _top_level_defs(path: Path) -> set:
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def test_every_jax_module_has_a_port_counterpart():
    """Each module of the JAX package has its namesake in the port, or
    stands in NOT_PORTED (a package's ``__init__.py`` goes with its
    modules); each function NOT_PORTED names is the JAX package's and not
    the port's."""
    modules = {f.relative_to(JAX_SRC).as_posix()
               for f in JAX_SRC.rglob("*.py")}
    not_ported = {e for e in NOT_PORTED if "::" not in e}
    missing = []
    for rel in sorted(modules):
        pkg_mods = {m for m in modules if m != rel
                    and os.path.dirname(m) == os.path.dirname(rel)}
        if rel.endswith("__init__.py") and pkg_mods \
                and pkg_mods <= not_ported:
            assert not (PORT / rel).exists(), rel
        elif rel in not_ported:
            assert not (PORT / rel).exists(), rel
        elif not (PORT / rel).exists():
            missing.append(rel)
    assert not missing, missing
    assert not_ported <= modules
    for entry in NOT_PORTED - not_ported:
        rel, name = entry.split("::")
        assert name in _top_level_defs(JAX_SRC / rel), entry
        assert name not in _top_level_defs(PORT / rel), entry


def test_not_ported_list_equals_the_roadmaps():
    """ROADMAP.md's "Not yet ported" section lists NOT_PORTED, one
    backticked ``svt_av1_tpu/...`` entry at the head of each bullet."""
    text = (REPO / "ROADMAP.md").read_text()
    section = text.split("\n### Not yet ported\n", 1)[1].split("\n#", 1)[0]
    listed = set(re.findall(r"^- `svt_av1_tpu/([^`]+)`", section, re.M))
    assert listed == NOT_PORTED


@pytest.mark.parametrize("rel", TABLES)
def test_tables_equal_jax_package(rel):
    mine = load_tables()[rel]
    with np.load(REPO / "svt_av1_tpu" / rel) as z:
        assert sorted(mine) == sorted(z.files)
        for k in z.files:
            assert mine[k].dtype == z[k].dtype, k
            assert np.array_equal(mine[k], z[k]), k


def test_config_from_jax_round_trips():
    jcfg = JaxConfig(width=200, height=120, qp=33, intra_period=0,
                     intra_modes=(0, 1, 2, 12), nfl=1, tile_cols_log2=1,
                     fixed_partition_size=None, qp_file=(30, -1, 41),
                     backend="device")
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    assert cfg.device == "cpu"
    d = dataclasses.asdict(cfg)
    d.pop("device")
    assert JaxConfig(backend="device", **d) == jcfg
    assert config_from_jax(dataclasses.asdict(jcfg)).device == "cuda"


@pytest.mark.parametrize("field,value", [("mesh_shape", (1, 2))])
def test_later_slices_raise_not_implemented(field, value):
    """``mesh_shape`` (once the tool of a later slice, refused) builds,
    carries across ``config_from_jax`` and is read by nothing: the stream
    equals the JAX host stream of the same config. (The name dates from
    when the field raised.)"""
    from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
    from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
    assert getattr(EncoderConfig(**{**INTRA, field: value}), field) == value
    jcfg = JaxConfig(**{**INTRA, field: value})
    cfg = config_from_jax(dataclasses.asdict(jcfg), device="cpu")
    assert getattr(cfg, field) == value
    rng = np.random.default_rng(5)
    frames = [(rng.integers(0, 256, (64, 64), dtype=np.uint8),
               rng.integers(0, 256, (32, 32), dtype=np.uint8),
               rng.integers(0, 256, (32, 32), dtype=np.uint8))]
    assert encode_ivf(frames, cfg) == jax_encode_ivf(frames, jcfg)


@pytest.mark.parametrize("field,value", [
    ("adaptive_quantization", 1), ("adaptive_quantization", 2),
    ("target_bit_rate", 1000000), ("rate_control_mode", 1),
    ("film_grain_strength", 10), ("film_grain_strength", -1),
    ("enable_source_denoise", True), ("intra_dp_satd", True),
    ("look_ahead_distance", 8),
    ("film_grain_params", {"grain_seed": 7, "num_y_points": 1,
                           "scaling_points_y": ((0, 20),)})])
def test_rate_and_analysis_tools_are_accepted(field, value):
    """The configs of the rate and analysis slice build, the CLI's
    mapping of ``--tbr``/``--lad``/``--film-grain``/``--enable-denoise``
    included."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.config import RateControlMode
    assert getattr(EncoderConfig(**{**INTRA, field: value}), field) == value
    cfg = preset_config(width=1920, height=1080, tbr=6_000_000, lad=8,
                        film_grain=-1, enable_denoise=True, device="cpu")
    assert cfg.rate_control_mode == RateControlMode.VBR
    assert (cfg.target_bit_rate, cfg.look_ahead_distance) == (6_000_000, 8)
    assert cfg.film_grain_strength == -1 and cfg.enable_source_denoise


def test_directional_configs_are_accepted():
    """The intra edge filter's configs run: EncoderConfig()'s defaults
    (13 modes, filter on) and preset 2, the CLI default."""
    from svt_av1_tpu_torch.app.cli import preset_config
    from svt_av1_tpu_torch.pipeline.common import edge_filter_active
    for cfg in (EncoderConfig(**{**INTRA, "intra_modes": tuple(range(13))}),
                EncoderConfig(),
                preset_config(width=1920, height=1080, device="cpu")):
        assert edge_filter_active(cfg)


@pytest.mark.parametrize("preset", [0, 1])
def test_postfilter_presets_run_all_intra(preset):
    """Presets 0 and 1 (CDEF, and LR at preset 0) are accepted all-intra,
    and so are both filters on any config."""
    from svt_av1_tpu_torch.app.cli import preset_config
    cfg = preset_config(width=1920, height=1080, preset=preset,
                        intra_period=0, device="cpu")
    assert cfg.enable_cdef and cfg.enable_restoration == (preset == 0)
    cfg = EncoderConfig(**{**INTRA, "intra_period": -1, "enable_cdef": True,
                           "enable_restoration": True})
    assert cfg.enable_cdef and cfg.enable_restoration


@pytest.mark.parametrize("preset", [0, 1])
@pytest.mark.parametrize("inter", [dict(intra_period=-1),
                                   dict(intra_period=-1,
                                        hierarchical_levels=3)])
def test_postfilter_presets_with_inter_frames_raise(preset, inter):
    """Presets 0 and 1 with inter frames build: they run the
    interpolation-filter search (and preset 0 the inter tx-type search)
    with CDEF on. (The name dates from when these configs raised.)"""
    from svt_av1_tpu_torch.app.cli import preset_config
    cfg = preset_config(width=1920, height=1080, preset=preset,
                        device="cpu", **inter)
    assert cfg.enable_interp_filter_search
    assert cfg.enable_tx_type_search == (preset == 0)
    assert cfg.intra_period == -1 and cfg.enable_cdef


@pytest.mark.parametrize("field,value", [("intra_period", -1),
                                         ("hierarchical_levels", 3)])
def test_inter_configs_are_accepted(field, value):
    cfg = EncoderConfig(**{**INTRA, field: value})
    assert getattr(cfg, field) == value


def test_default_device_entry_point_needs_the_card():
    """A default (cuda) config runs on the card or raises: never on the
    CPU behind the caller's back."""
    from svt_av1_tpu_torch.pipeline.encoder import Encoder, encode_ivf
    cfg = EncoderConfig(**INTRA)
    assert cfg.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(cfg)
    frame = (np.zeros((64, 64), np.uint8), np.zeros((32, 32), np.uint8),
             np.zeros((32, 32), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_ivf([frame], cfg)
