"""CDEF and loop restoration in the benchmark's frozen decoder
(``benchmark/avref``): the port's streams with both filters on, at 8 and
10 bits, decode to the encoder's reported reconstruction and to the
port's own decoder (``pipeline/decode.py``) sample for sample; the two
vectorised filters equal the port's host filters on random frames with
several units of every restoration type (the encoder's streams at these
sizes have one unit a plane and never pick the switchable type); film
grain is still refused."""

import collections

import numpy as np
import pytest

from benchmark import harness
from benchmark.avref.bitstream import obu as aobu
from benchmark.avref.entropy import lr as alr
from benchmark.avref.ops import cdef as acdef
from benchmark.avref.ops import restoration as arst
from benchmark.avref.pipeline.decode import StreamDecoder
from benchmark.tests.conftest import encode
from benchmark.traffic import Stream
from svt_av1_tpu_torch.bitstream import obu as pobu
from svt_av1_tpu_torch.ops import cdef as pcdef
from svt_av1_tpu_torch.ops import restoration as prst
from svt_av1_tpu_torch.pipeline.decode import StreamDecoder as PortDecoder

BOTH = {"enable_cdef": True, "enable_restoration": True}

# name: (width, height, bit depth, frames, encoder options)
STREAMS = {
    "8bit_64x64": (64, 64, 8, 4, dict(qp=30)),
    "8bit_128x64": (128, 64, 8, 4, dict(qp=40)),
    "10bit_64x64": (64, 64, 10, 4, dict(qp=40)),
    "10bit_128x64": (128, 64, 10, 4, dict(qp=30)),
    "10bit_128x64_vbr": (128, 64, 10, 6, dict(qp=40, tbr=200000, lad=2)),
}


def _encode(w, h, bd, n, options):
    """[(tu, recon)] of the port's stream on the CPU: random access with a
    3-level pyramid, both filters on."""
    config = {"encoder": dict(width=w, height=h, bit_depth=bd, preset=5,
                              intra_period=-1, hierarchical_levels=3,
                              tile_columns=0, **options),
              "encoder_fields": BOTH}
    cfg = harness.encoder_config(config, "cpu")
    assert cfg.enable_cdef and cfg.enable_restoration
    return encode(cfg, Stream(w, h, 21, bit_depth=bd), n)


@pytest.fixture(scope="module")
def decoded():
    """Per stream: (samples where avref differs from the recon, from the
    port's decoder, shown frames, {(frame type, unit type): units})."""
    seen = collections.Counter()
    orig = alr.read_lr_unit

    def spy(r, fc, ftype, ref, is_chroma):
        rui = orig(r, fc, ftype, ref, is_chroma)
        seen[(ftype, rui.restoration_type)] += 1
        return rui

    res = {}
    alr.read_lr_unit = spy
    try:
        for name, args in STREAMS.items():
            seen.clear()
            ours, port = StreamDecoder(), PortDecoder()
            vs_recon = vs_port = shown = 0
            for tu, recon in _encode(*args):
                a, b = ours.decode_tu(tu), port.decode_tu(tu)
                assert (a is None) == (b is None) == (recon is None)
                if recon is None:
                    continue
                assert ours.seq.enable_cdef and ours.seq.enable_restoration
                assert ours.seq.bit_depth == args[2]
                shown += 1
                vs_recon += sum(int(np.count_nonzero(x != y))
                                for x, y in zip(a, recon))
                vs_port += sum(int(np.count_nonzero(x != y))
                               for x, y in zip(a, b))
            res[name] = (vs_recon, vs_port, shown, dict(seen))
    finally:
        alr.read_lr_unit = orig
    return res


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_with_both_filters_decodes_exactly(decoded, name):
    vs_recon, vs_port, shown, _ = decoded[name]
    assert shown == STREAMS[name][3]
    assert vs_recon == 0 and vs_port == 0


@pytest.mark.parametrize("bd", [8, 10])
def test_streams_cover_the_restoration_types_the_encoder_picks(decoded, bd):
    units = collections.Counter()
    for name, (_, _, _, seen) in decoded.items():
        if STREAMS[name][2] == bd:
            units.update({t: k for (_, t), k in seen.items()})
    assert units[arst.RESTORE_WIENER] > 0 and units[arst.RESTORE_SGRPROJ] > 0


def _random_planes(rng, w, h, bd):
    hi = 1 << bd
    dt = np.uint8 if bd == 8 else np.uint16
    return [rng.integers(0, hi, (h, w)).astype(dt),
            rng.integers(0, hi, (h // 2, w // 2)).astype(dt),
            rng.integers(0, hi, (h // 2, w // 2)).astype(dt)]


@pytest.mark.parametrize("bd,seed", [(8, 1), (10, 2), (10, 3)])
def test_cdef_equals_the_port_filter(bd, seed):
    rng = np.random.default_rng(seed)
    mi_rows, mi_cols = 34, 50                  # 136 x 200 luma
    h, w = mi_rows * 4, mi_cols * 4
    # smooth content so that directions and variances spread
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 5.0 + yy / 7.0) * 60 + 128).astype(np.int64) \
        << (bd - 8)
    planes = _random_planes(rng, w, h, bd)
    planes[0] = np.clip(base + rng.integers(-8, 9, (h, w)), 0,
                        (1 << bd) - 1).astype(planes[0].dtype)
    skip8 = rng.random((mi_rows // 2, mi_cols // 2)) < 0.3
    cdef_idx = rng.integers(-1, 4, (3, 4)).astype(np.int32)
    y_str = (0, 1 * 4 + 3, 9 * 4 + 2, 15 * 4 + 1)
    uv_str = (0, 2 * 4 + 0, 0 * 4 + 3, 7 * 4 + 2)
    for damping in (3, 6):
        ours = [p.copy() for p in planes]
        port = [p.copy() for p in planes]
        acdef.cdef_frame(ours, skip8, cdef_idx, y_str, uv_str, damping,
                         mi_rows, mi_cols, bd)
        pcdef.cdef_frame(port, skip8, cdef_idx, y_str, uv_str, damping,
                         mi_rows, mi_cols, bd)
        assert not np.array_equal(ours[0], planes[0])
        for a, b in zip(ours, port):
            assert np.array_equal(a, b)


def _random_units(rng, n, rtype):
    """``n`` units of frame type ``rtype``, the first filtered."""
    units = []
    for i in range(n):
        if rtype == arst.RESTORE_SWITCHABLE:
            t = int(rng.integers(1, 3)) if i == 0 else int(rng.integers(0, 3))
        else:
            t = rtype if i == 0 or rng.random() < 0.8 else arst.RESTORE_NONE
        taps = [tuple(int(rng.integers(arst.WIENER_TAP_MIN[k],
                                       arst.WIENER_TAP_MAX[k] + 1))
                      for k in range(3)) for _ in range(2)]
        ep = int(rng.integers(0, 16))
        xqd = (int(rng.integers(arst.SGRPROJ_PRJ_MIN0,
                                arst.SGRPROJ_PRJ_MAX0 + 1)),
               int(rng.integers(arst.SGRPROJ_PRJ_MIN1,
                                arst.SGRPROJ_PRJ_MAX1 + 1)))
        units.append((t, taps, ep, xqd))
    return units


@pytest.mark.parametrize("bd,types,sizes", [
    (8, (3, 3, 3), (64, 32)),
    (10, (3, 1, 2), (64, 64)),
    (10, (1, 2, 3), (128, 64)),
    (8, (2, 0, 1), (256, 128))])
def test_restoration_equals_the_port_filter(bd, types, sizes):
    rng = np.random.default_rng(bd * 100 + sum(types) + sizes[0])
    w, h = 300, 212                           # not unit-aligned
    planes = _random_planes(rng, w, h, bd)
    deblocked = _random_planes(rng, w, h, bd)
    out = {}
    for name, mod in (("ours", arst), ("port", prst)):
        rinfos, bounds = [], []
        rng_u = np.random.default_rng(7)
        for p in range(3):
            ss = 1 if p else 0
            Wp, Hp = (w + ss) >> ss, (h + ss) >> ss
            lims, hn, vn = mod.unit_limits(Wp, Hp, sizes[p > 0], ss)
            units = [mod.RestorationUnitInfo(t, taps[0], taps[1], ep, xqd)
                     for t, taps, ep, xqd in
                     _random_units(rng_u, len(lims), types[p])]
            if p:
                # chroma Wiener's outer tap is not coded: it is 0
                for u in units:
                    u.wiener_v = (0,) + u.wiener_v[1:]
                    u.wiener_h = (0,) + u.wiener_h[1:]
            rinfos.append(mod.RestorationInfo(types[p], sizes[p > 0], units,
                                              hn, vn))
            bounds.append(mod.save_deblock_boundary_lines(
                deblocked[p][:Hp, :Wp], Hp, ss))
        got = [p.copy() for p in planes]
        mod.loop_restoration_filter_frame(got, rinfos, bounds, w, h, bd)
        out[name] = got
    for p in range(3):
        assert np.array_equal(out["ours"][p], out["port"][p]), p
        if types[p]:
            assert not np.array_equal(out["ours"][p], planes[p])


def test_film_grain_is_still_refused():
    seq = pobu.SequenceHeader(width=64, height=64, bit_depth=10,
                              enable_cdef=True, enable_restoration=True)
    payload = aobu.parse_obus(pobu.write_sequence_header_obu(seq))[0][1]
    got = aobu.parse_sequence_header_obu(payload)
    assert got.enable_cdef and got.enable_restoration and got.bit_depth == 10
    seq.film_grain_params_present = True
    payload = aobu.parse_obus(pobu.write_sequence_header_obu(seq))[0][1]
    with pytest.raises(NotImplementedError, match="film grain"):
        aobu.parse_sequence_header_obu(payload)
