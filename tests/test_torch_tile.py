"""The port's fused keyframe tile programs against the JAX package.

Streams: key frames through ``svt_av1_tpu_torch``'s ``encode_ivf`` on the
CPU (the plain versions of every kernel) equal the JAX package's host
stream byte for byte, and spies show that the port ran the fused entry
point that the JAX package's device-backend gate (``wavefront.py``: the
defer list, then ``analyze_tile_fused``, then ``analyze_tile_fused_mixed``)
picks for the same tiles. Program: the fused program equals the port's
per-wave loop on the same tiles (decisions, eobs, coefficients, recon),
also where a class holds more lanes in one wave than the JAX package's
band bound allows, and equals the JAX package's own frame program. Every
config has ``edge_filter_active`` False. Tolerance 0 throughout.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                        _disable_current_modes)

from svt_av1_tpu.app.cli import preset_config as jax_preset_config
from svt_av1_tpu.ops import device_tile as jdt
from svt_av1_tpu.pipeline import common as jcommon
from svt_av1_tpu.pipeline import wavefront as jwf
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf
from svt_av1_tpu_torch.app.cli import preset_config
from svt_av1_tpu_torch.convert import config_from_jax
from svt_av1_tpu_torch.ops import device_tile as tdt
from svt_av1_tpu_torch.ops import intra as intra_ops
from svt_av1_tpu_torch.ops import step_graphs
from svt_av1_tpu_torch.pipeline import common
from svt_av1_tpu_torch.pipeline import wavefront as twf
from svt_av1_tpu_torch.pipeline.encoder import encode_ivf
from svt_av1_tpu_torch.utils.clip import make_clip
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_tile_cases import (assert_same_state, keyframe_state,
                                    mixed_content)

FUSED = ("run_tiles_fused", "analyze_tile_fused", "analyze_tile_fused_mixed")


def _jax_cfg(w, h, preset=5, **extra):
    args = SimpleNamespace(width=w, height=h, qp=40, bit_depth=8,
                           intra_period=0, fps=30, film_grain=0,
                           preset=preset, hierarchical_levels=0, tbr=0,
                           lad=0, backend="host")
    cfg = dataclasses.replace(jax_preset_config(args), **extra)
    assert not jcommon.edge_filter_active(cfg)
    return cfg


def _jax_pick(enc) -> str:
    """The fused entry point the JAX package's device backend picks for
    the tile ``enc`` is entered into (wavefront.py:276-281 and :392-404),
    from the JAX package's own metadata functions."""
    cands = jcommon.intra_candidates(enc.cfg)
    if enc._tile_count > 1 and enc.qmap is None \
            and jdt.tile_lane_meta(enc, cands) is not None:
        return "run_tiles_fused"
    if jdt.tile_metadata(enc, cands) is not None:
        return "analyze_tile_fused"
    if jdt.mixed_tile_metadata(enc, cands) is not None:
        return "analyze_tile_fused_mixed"
    return "per_wave"


def _port_picks(monkeypatch) -> list:
    """Per key frame tile, the port entry point that coded it."""
    picks = []
    orig = twf.WavefrontIntraEncoder._analyze_tile

    def analyze(self):
        defer = self._defer_tiles
        n0 = None if defer is None else len(defer)
        mark = len(picks)
        orig(self)
        if n0 is not None and len(defer) > n0:
            picks.append("run_tiles_fused")
        elif len(picks) == mark:
            picks.append("per_wave")

    def entry(nm, fn):
        def call(enc, *a):
            ok = fn(enc, *a)
            if ok:
                picks.append(nm)
            return ok
        return call

    monkeypatch.setattr(twf.WavefrontIntraEncoder, "_analyze_tile", analyze)
    for nm in FUSED[1:]:
        monkeypatch.setattr(tdt, nm, entry(nm, getattr(tdt, nm)))
    return picks


def _programs(monkeypatch) -> list:
    """Tiles per run of the frame program."""
    runs = []
    orig = tdt.run_tiles_fused

    def call(enc, metas, *a):
        runs.append(len(metas))
        return orig(enc, metas, *a)

    monkeypatch.setattr(tdt, "run_tiles_fused", call)
    return runs


# name: (w, h, preset, extra config, frames or None for make_clip, the
# entry point JAX picks for every tile)
STREAMS = {
    "uniform16_1tile": (128, 64, 5, dict(fixed_partition_size=16), None,
                        "analyze_tile_fused"),
    "preset5_mixed_1tile": (192, 128, 5, dict(qp=20), "mixed",
                            "analyze_tile_fused_mixed"),
    "preset4_rect_1tile": (192, 128, 4, dict(qp=20), "mixed",
                           "analyze_tile_fused_mixed"),
    "preset5_4tile_cols": (448, 128, 5, dict(tile_cols_log2=2), None,
                           "run_tiles_fused"),
    "preset5_2x2_tiles": (200, 120, 5, dict(tile_cols_log2=1,
                                            tile_rows_log2=1), None,
                          "run_tiles_fused"),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_keyframe_stream_takes_the_jax_fused_path(monkeypatch, name):
    w, h, preset, extra, content, pick = STREAMS[name]
    frames = [mixed_content()] if content == "mixed" \
        else make_clip(w=w, h=h, frames=1, seed=3)
    jcfg = _jax_cfg(w, h, preset, **extra)
    jax_picks, shapes = [], set()
    orig = jwf.WavefrontIntraEncoder._analyze_tile

    def spy(self):
        orig(self)
        jax_picks.append(_jax_pick(self))
        shapes.update(tuple(wh) for _, _, wh in self._leaves())

    with monkeypatch.context() as m:
        m.setattr(jwf.WavefrontIntraEncoder, "_analyze_tile", spy)
        want = jax_encode_ivf(frames, jcfg)
    picks = _port_picks(monkeypatch)
    runs = _programs(monkeypatch)
    waves = []
    monkeypatch.setattr(twf.WavefrontIntraEncoder, "_code_wave",
                        lambda *a: waves.append(1))
    got = encode_ivf(frames, config_from_jax(dataclasses.asdict(jcfg),
                                             device="cpu"))
    assert got == want
    assert picks == jax_picks == [pick] * len(jax_picks)
    assert not waves
    tiles = len(jax_picks)
    assert runs == ([tiles] if pick == "run_tiles_fused" else [])
    assert tiles == {"preset5_4tile_cols": 4, "preset5_2x2_tiles": 4}.get(
        name, 1)
    if content == "mixed":
        assert len(shapes) > 1
        assert any(bw != bh for bw, bh in shapes) == (preset == 4)


def _port_cfg(w, h, **extra):
    jcfg = _jax_cfg(w, h, **extra)
    return config_from_jax(dataclasses.asdict(jcfg), device="cpu")


@pytest.mark.parametrize("name,w,h,extra", [
    ("mixed_2x2_tiles_unaligned", 200, 120,
     dict(tile_cols_log2=1, tile_rows_log2=1, enable_dlf=False)),
    ("mixed_4tile_cols", 448, 128, dict(tile_cols_log2=2,
                                        enable_dlf=False)),
])
def test_fused_program_equals_per_wave_loop(name, w, h, extra):
    frame = make_clip(w=w, h=h, frames=1, seed=5)[0]
    cfg = _port_cfg(w, h, **extra)
    assert_same_state(keyframe_state(frame, cfg),
                      keyframe_state(frame, cfg, fused=False))


def test_fused_program_beyond_the_band_bound():
    """Every leaf of a uniform 16x16 tile in one wave: 32 lanes of one
    class against the 4 bands of 16 rows the JAX package's
    ``tile_lane_meta`` allows per wave, so it declines the tile; the
    port's program takes it, and equals the per-wave loop on the same
    wave assignment."""
    w, h = 128, 64
    frame = make_clip(w=w, h=h, frames=1, seed=2)[0]
    cfg = _port_cfg(w, h, fixed_partition_size=16, enable_dlf=False)

    def one_wave(leaves, mi_cols, mi_rows):
        return np.zeros(len(leaves), dtype=np.int64)

    fused = keyframe_state(frame, cfg, waves=one_wave)
    assert_same_state(fused, keyframe_state(frame, cfg, fused=False,
                                            waves=one_wave))
    enc = jwf.WavefrontIntraEncoder(_jax_cfg(w, h, fixed_partition_size=16))
    enc._dependency_waves = one_wave
    seen = []
    orig = jwf.WavefrontIntraEncoder._analyze_tile

    def spy(self):
        orig(self)
        cands = jcommon.intra_candidates(self.cfg)
        seen.append((jdt.tile_lane_meta(self, cands),
                     len(self._leaves())))

    jwf.WavefrontIntraEncoder._analyze_tile = spy
    try:
        enc.encode_compute(*frame)
    finally:
        jwf.WavefrontIntraEncoder._analyze_tile = orig
    assert seen == [(None, 32)]


@pytest.mark.parametrize("decline", ["defer", "every_program"])
def test_partly_deferred_frame(monkeypatch, decline):
    """One tile of four declines the frame program (``defer``: it runs its
    own program on host planes) or every fused program (the per-wave
    loop); the others still run as one frame program whose recon is
    copied into the host planes. Same integers as all four fused."""
    w, h = 448, 128
    frame = make_clip(w=w, h=h, frames=1, seed=4)[0]
    cfg = _port_cfg(w, h, tile_cols_log2=2, enable_dlf=False)
    want = keyframe_state(frame, cfg)
    orig = tdt.tile_lane_meta
    asked = []

    def meta(enc, cands):
        if enc._cur_rect[1] == 32:       # the second tile column
            asked.append(1)
            if decline == "every_program" or len(asked) == 1:
                return None
        return orig(enc, cands)

    monkeypatch.setattr(tdt, "tile_lane_meta", meta)
    runs = _programs(monkeypatch)
    assert_same_state(keyframe_state(frame, cfg), want)
    assert runs == [3]
    assert len(asked) == (3 if decline == "every_program" else 2)


@pytest.fixture(scope="module")
def jax_frame_program():
    """The JAX package's run_tiles_fused itself on the CPU: a 128x64 frame
    of 2 tile columns with two leaf shapes (64x64 and 32x32; its compile
    takes some 20 s on a CPU core), on the tile states of its host
    encoder. Returns (frame, config, (per-tile decisions and
    coefficients, recon planes))."""
    w, h = 128, 64
    frame = make_clip(w=w, h=h, frames=1, seed=3)[0]
    jcfg = _jax_cfg(w, h, tile_cols_log2=1)
    enc = jwf.WavefrontIntraEncoder(jcfg)
    metas = []
    orig = jwf.WavefrontIntraEncoder._analyze_tile

    def spy(self):
        orig(self)
        metas.append(jdt.tile_lane_meta(self, jcommon.intra_candidates(
            self.cfg)))

    jwf.WavefrontIntraEncoder._analyze_tile = spy
    try:
        enc.encode_compute(*frame)
    finally:
        jwf.WavefrontIntraEncoder._analyze_tile = orig
    assert len(metas) == 2 and all(metas)
    assert len({sh for m in metas for sh in m["classes"]}) >= 2
    src = jcommon.pad_frame_planes(*frame, dtype=np.int32)
    zeros = [np.zeros(p.shape, np.uint8) for p in src]
    recon = jdt.run_tiles_fused(enc, metas, src, zeros,
                                jcommon.intra_candidates(jcfg))
    tiles = []
    for m in metas:
        a = m["arrays"]
        t = {k: np.array(a[k]) for k in ("y_mode", "y_delta", "uv_mode",
                                         "uv_delta", "alpha_u", "alpha_v",
                                         "y_tx_type", "eobs")}
        for p in range(3):
            t[f"qc{p}"] = np.concatenate([jcommon.resolve_qc(q).ravel()
                                          for q in a["qcoeff"][p]])
        tiles.append(t)
    return frame, jcfg, (tiles, [np.asarray(p) for p in recon])


def test_frame_program_equals_jax_program(jax_frame_program):
    frame, jcfg, want = jax_frame_program
    cfg = config_from_jax(dataclasses.asdict(
        dataclasses.replace(jcfg, enable_dlf=False)), device="cpu")
    got = keyframe_state(frame, cfg)
    for a, b in zip(got[0], want[0]):
        for k in a:
            assert np.array_equal(a[k], b[k].astype(a[k].dtype)), k
    for a, b in zip(got[1], want[1]):
        assert np.array_equal(a, b)


def test_edges_clamp_at_tile_and_frame_bounds():
    """_edges_j at frame-global positions with per-lane tile bounds equals
    the host edge preparation lane by lane; rows and columns past the
    bounds hold a sentinel that no edge may read. 200x120: the mi-area
    ends at row 120 of a 128-row plane; a tile row boundary at 64."""
    rng = np.random.default_rng(9)
    plane = rng.integers(0, 200, (128, 256)).astype(np.int32)
    plane[120:, :] = 255
    plane[:, 200:] = 255
    bw, bh = 16, 8
    lanes = [  # x, y, max_w, max_h, ha, hl, htr, hbl
        (184, 112, 200, 120, True, True, True, True),
        (48, 48, 128, 64, True, True, True, True),
        (64, 64, 128, 120, False, False, True, True),
        (112, 96, 128, 120, True, True, True, True),
        (128, 104, 200, 120, True, False, False, True),
    ]
    arr = np.array(lanes, dtype=np.int64).T
    xs, ys, mw, mh = arr[:4]
    ha, hl, htr, hbl = (arr[i].astype(bool) for i in range(4, 8))
    t = [torch.as_tensor(a) for a in (xs, ys, ha, hl, htr, hbl, mw, mh)]
    a1, l1 = tdt._edges_j(torch.as_tensor(plane), t[0], t[1], bw, bh, t[2],
                          t[3], t[4], t[5], 8, t[6], t[7])
    for i in range(len(lanes)):
        wa, wl = intra_ops.prepare_edges_av1(
            plane, xs[i:i + 1], ys[i:i + 1], bw, bh, ha[i:i + 1],
            hl[i:i + 1], htr[i:i + 1], hbl[i:i + 1], bd=8,
            max_w=int(mw[i]), max_h=int(mh[i]))
        assert np.array_equal(a1[i].numpy(), wa[0])
        assert np.array_equal(l1[i].numpy(), wl[0])
        assert 255 not in a1[i].numpy() and 255 not in l1[i].numpy()


def test_syntax_resolves_pending_coefficients():
    """The keyframe syntax pass codes a tile whose coefficients are
    ``(PendingQC, lane)`` markers over a torch tensor exactly as the same
    coefficients held as arrays."""
    w, h = 128, 64
    frame = make_clip(w=w, h=h, frames=1, seed=3)[0]
    enc = twf.WavefrontIntraEncoder(_port_cfg(w, h,
                                              fixed_partition_size=16))
    enc._fused = False                   # coefficients stored as arrays
    enc.encode_compute(*frame)
    want, _ = enc.package_syntax()
    for st in enc._pkg["tile_states"]:
        for p in range(3):
            qcs = st["qcoeff"][p]
            assert all(isinstance(q, np.ndarray) for q in qcs)
            pend = common.PendingQC(torch.as_tensor(np.stack(qcs)))
            st["qcoeff"][p][:] = [(pend, i) for i in range(len(qcs))]
    got, _ = enc.package_syntax()
    assert got == want


# --- the class step on padded lanes (the card's CUDA-graph buckets) ----------
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 64, 65])
def test_lane_bucket_is_the_next_power_of_two(n):
    want = {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 7: 8, 8: 8, 9: 16, 64: 64,
            65: 128}[n]
    assert step_graphs.lane_bucket(n) == want


def _step_planes(rng, w=256, h=192):
    """int32 recon planes (Y, U, V) and source planes of a w x h frame."""
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    recon = [torch.as_tensor(rng.integers(0, 256, s).astype(np.int32))
             for s in shapes]
    src = [torch.as_tensor(rng.integers(0, 256, s).astype(np.uint8))
           for s in shapes]
    return recon, src


def _step_lanes(rng, shape, n, w=256, h=192):
    """Packed lanes [len(LANE_KEYS), n] of n disjoint blocks of ``shape``:
    per lane its own flags, tile bounds, qindex and lambda."""
    bw, bh = shape
    cells = rng.permutation((w // bw) * (h // bh))[:n]
    xs, ys = (cells % (w // bw)) * bw, (cells // (w // bw)) * bh
    mw = np.minimum(w, xs + bw + bw * rng.integers(0, 3, n))
    mh = np.minimum(h, ys + bh + bh * rng.integers(0, 3, n))
    qv = rng.integers(20, 240, n)
    lam = rng.integers(1 << 10, 1 << 20, n)
    return torch.as_tensor(np.stack([
        xs, ys, ys > 0, xs > 0, rng.integers(0, 2, n), rng.integers(0, 2, n),
        mw, mh, qv, lam]).astype(np.int64))


@pytest.mark.parametrize("preset,shape", [(5, (16, 16)), (5, (32, 32)),
                                          (5, (64, 64)), (3, (32, 16))])
def test_class_step_on_padded_lanes_equals_real_lanes(preset, shape):
    """``_class_stage``'s step on a wave's real lanes and on the same
    lanes padded to their bucket with copies of the last lane (as the
    card's graphs run them): the real lanes' outputs and all three recon
    planes are equal, and each pad lane's outputs are the last lane's.
    Preset 5's square classes and a rect class of preset 3."""
    cfg = preset_config(width=256, height=192, preset=preset,
                        intra_period=0, device="cpu")
    step = tdt._class_stage(shape, tuple(map(tuple, common.intra_candidates(
        cfg))), 8, cfg.nfl, False, bool(cfg.enable_rdoq))
    rng = np.random.default_rng(sum(shape) + preset)
    for n in (3, 5, 6):
        recon, src = _step_planes(rng)
        lanes = _step_lanes(rng, shape, n)
        nb = step_graphs.lane_bucket(n)
        padded = torch.cat([lanes, lanes[:, -1:].expand(-1, nb - n)], 1)
        want_recon = [p.clone() for p in recon]
        want = step(want_recon, src, lanes)
        got = step(recon, src, padded)
        for g, w_ in zip(got, want):
            cut = g[:, :n] if g.dim() == 2 else g[:n]
            assert torch.equal(cut, w_)
            pad = g[:, n:] if g.dim() == 2 else g[n:]
            last = w_[:, -1:] if w_.dim() == 2 else w_[-1:]
            assert torch.equal(pad, last.expand_as(pad))
        for g, w_ in zip(recon, want_recon):
            assert torch.equal(g, w_)


def test_lanes_of_pads_each_wave_with_its_last_lane():
    """``_lanes_of``: per class and wave, the real lanes in loop order at
    their offset, followed by copies of the wave's last lane up to its
    bucket; the real lanes' ranges cover the class in wave order."""
    mk = dict(n_waves=4, rect=(0, 0, 32, 64), arrays=None)
    wave = np.array([2, 0, 0, 0, 2, 3, 0, 3, 3, 3, 3])
    n = len(wave)
    ent = dict(wave=wave, r=np.arange(n) * 4, c=np.arange(n) * 4,
               li=np.arange(n), htr=np.arange(n) % 2 == 0,
               hbl=np.arange(n) % 3 == 0)
    metas = [dict(mk, classes={(16, 16): ent})]
    lanes, ranges, _, positions = tdt._lanes_of(metas, [(16, 16)], 90, 777,
                                                "cpu")
    lanes, rng_ = lanes[0], ranges[0]
    order = np.argsort(wave, kind="stable")
    assert np.array_equal(positions[0][order], np.arange(n))
    assert [(s, e) for s, e, _ in rng_] == [(0, 4), (4, 4), (4, 6), (6, 11)]
    for s, e, off in rng_:
        if e == s:
            continue
        nb = step_graphs.lane_bucket(e - s)
        real = lanes[:, off:off + e - s]
        assert torch.equal(real[0], torch.as_tensor(ent["c"][order[s:e]] * 4))
        assert torch.equal(real[1], torch.as_tensor(ent["r"][order[s:e]] * 4))
        assert torch.equal(lanes[:, off + e - s:off + nb],
                           real[:, -1:].expand(-1, nb - (e - s)))
    assert lanes.shape[1] == 4 + 2 + 8
    assert set(lanes[8].tolist()) == {90} and set(lanes[9].tolist()) == {777}


class _Reads(TorchDispatchMode):
    """The storages of the tensors that operations read and that no
    operation under the mode made."""

    def __init__(self):
        super().__init__()
        self.made, self.read = set(), {}

    def _see(self, t):
        if isinstance(t, torch.Tensor):
            p = t.untyped_storage().data_ptr()
            if p not in self.made and t.dim():    # 0-dim: wrapped scalars
                self.read.setdefault(p, t)
        elif isinstance(t, (list, tuple)):
            for x in t:
                self._see(x)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._see(args)
        self._see(tuple((kwargs or {}).values()))
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor):
                self.made.add(t.untyped_storage().data_ptr())
        return out


def _port_caches():
    """Every bounded functools.lru_cache of the port's modules."""
    import functools
    import importlib
    import pkgutil

    import svt_av1_tpu_torch
    out = []
    for m in pkgutil.walk_packages(svt_av1_tpu_torch.__path__,
                                   "svt_av1_tpu_torch."):
        if m.name.endswith("__main__"):
            continue
        mod = importlib.import_module(m.name)
        out += [f for f in vars(mod).values()
                if isinstance(f, functools._lru_cache_wrapper)
                and f.__module__ == m.name and f.cache_info().maxsize]
    return out


@pytest.mark.parametrize("preset,shape,tx_search,bd", [
    (5, (16, 16), False, 8), (5, (32, 32), True, 8), (5, (64, 64), False, 10),
    (3, (32, 16), False, 8)])
def test_class_step_reads_no_constant_a_cache_can_free(monkeypatch, preset,
                                                       shape, tx_search, bd):
    """The card's graphs read a class step's constants at the addresses
    they had at capture, and nothing else keeps them: every tensor the
    step reads besides its planes and lanes is one a step built later (as
    the next frame builds it) reads too, and clearing any bounded cache
    of the port changes none of them. The quantization call is left out,
    as on the card, where it runs between the graphs."""
    real = tdt.dmd.quant_stage_j
    mode = []

    def host_call(*a, **k):
        with _disable_current_modes():
            out = real(*a, **k)
        for t in out if mode else ():
            mode[0].made.add(t.untyped_storage().data_ptr())
        return out

    monkeypatch.setattr(tdt.dmd, "quant_stage_j", host_call)
    cfg = preset_config(width=256, height=192, preset=preset,
                        intra_period=0, device="cpu")
    key = (shape, tuple(map(tuple, common.intra_candidates(cfg))), bd,
           cfg.nfl, tx_search, bool(cfg.enable_rdoq))
    rng = np.random.default_rng(bd + preset)
    recon, src = _step_planes(rng)
    lanes = _step_lanes(rng, shape, 5)
    own = {t.untyped_storage().data_ptr() for t in (*recon, *src, lanes)}

    def reads():
        step = tdt._class_stage(*key)
        step(recon, src, lanes)
        with _Reads() as r:
            mode[:] = [r]
            step(recon, src, lanes)
        mode.clear()
        return {p: t for p, t in r.read.items() if p not in own}

    first = reads()
    assert first
    for cache in _port_caches():
        cache.cache_clear()
        # ``first`` holds its tensors, so a rebuilt one has a new address
        assert reads().keys() == first.keys(), \
            f"{cache.__module__}.{cache.__qualname__}"
