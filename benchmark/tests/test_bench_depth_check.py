"""The check at the bit depth a configuration states, and the encoder
fields a configuration may set: PSNR at the depth's peak, a stream whose
sequence header states another depth judged wholly wrong, and
``encoder_fields`` that name no field stopping the run."""

import dataclasses
import json
import math

import numpy as np
import pytest

from benchmark import harness, reference
from benchmark.tests.conftest import encode, tiny_cell
from benchmark.traffic import Stream


def test_psnr_at_the_10bit_peak():
    a = np.full((64, 128), 500, dtype=np.uint16)
    b = a.copy()
    b[:, ::2] += 4                       # error 4 on half: MSE 8
    want = 10 * math.log10(1023 ** 2 / 8)
    assert reference.psnr_db(b, a, 1023) == pytest.approx(want, abs=1e-12)
    assert reference.psnr_db(b, a) == pytest.approx(
        10 * math.log10(255 ** 2 / 8), abs=1e-12)
    assert want - reference.psnr_db(b, a) == pytest.approx(
        20 * math.log10(1023 / 255), abs=1e-12)


def _stream(bd: int, frames: int = 3):
    """Packets [(tu, recon)] and sources of an all-intra 64x64 stream of
    the port on the CPU at depth ``bd``."""
    config, _ = tiny_cell("ai480", "intra", 64, 64)
    config["encoder"]["bit_depth"] = bd
    s = Stream(64, 64, 2**31 + 9, bit_depth=bd)
    packets = encode(harness.encoder_config(config, "cpu"), s, frames)
    return packets, {t: s.frame(t)[0] for t in range(frames)}


@pytest.mark.parametrize("bd", [8, 10])
def test_a_stream_at_the_stated_depth_passes(bd):
    packets, sources = _stream(bd)
    res = reference.check(packets, sources, 0, bd)
    assert res["error"] is None and res["mismatch"] == 0
    # noise of sigma 6 (24 at 10 bits) coded at qp 40: some 33-40 dB at
    # either depth, 12 dB lower if the 10-bit decode were read at 255
    assert all(30 < f[2] < 45 for f in res["frames"])


@pytest.mark.parametrize("bd,stated", [(8, 10), (10, 8)])
def test_a_stream_at_another_depth_is_wholly_wrong(bd, stated):
    packets, sources = _stream(bd)
    res = reference.check(packets, sources, 0, stated)
    assert f"states {bd} bits, the configuration {stated}" in res["error"]
    assert res["mismatch"] == sum(sum(p.size for p in r)
                                  for _, r in packets if r is not None)
    assert all(f[1] > 0 for f in res["frames"])


def test_a_run_whose_header_states_another_depth_is_not_correct(
        monkeypatch):
    from svt_av1_tpu_torch.bitstream import obu
    write = obu.write_sequence_header_obu
    monkeypatch.setattr(obu, "write_sequence_header_obu",
                        lambda seq: write(dataclasses.replace(
                            seq, bit_depth=10)))
    config, traffic = tiny_cell("ai480", "intra", 64, 64)
    _, checks, state = harness.run_cell(config, traffic, 21, 0.5,
                                        trace=False, device="cpu")
    assert state["decode_error"]
    assert checks["mismatch_samples"]["value"] > 0
    assert not harness.passes(checks)


def test_encoder_fields_set_named_fields():
    config, _ = tiny_cell("ra1080p", "longgop", 128, 64)
    plain = harness.encoder_config(config, "cpu")
    assert not plain.enable_cdef and not plain.enable_restoration
    config["encoder_fields"] = {"enable_cdef": True,
                                "enable_restoration": True,
                                "intra_modes": [0, 1, 2]}
    cfg = harness.encoder_config(config, "cpu")
    assert cfg == dataclasses.replace(plain, enable_cdef=True,
                                      enable_restoration=True,
                                      intra_modes=(0, 1, 2))


@pytest.mark.parametrize("fields", [{"enable_cdeff": True},
                                    {"enable_cdef": True, "lad": 17},
                                    {"device": "cpu"}])
def test_an_unknown_encoder_field_stops_the_run(fields):
    config, traffic = tiny_cell("ra1080p", "longgop", 128, 64)
    config["encoder_fields"] = fields
    with pytest.raises(harness.RunError, match="encoder_fields"):
        harness.encoder_config(config, "cpu")
    with pytest.raises(harness.RunError, match="encoder_fields"):
        harness.run_cell(config, traffic, 21, 0.5, trace=False,
                         device="cpu")


@pytest.mark.parametrize("config,traffic,w,h,frames",
                         [("ra1080p", "longgop", 128, 64, 9),
                          ("ai480", "intra", 64, 64, 2)])
def test_the_cells_encode_as_at_the_parent(config, traffic, w, h, frames):
    """The cells' encoder and frames as the harness built them before it
    took a depth and encoder fields: ``preset_config`` of the options,
    ``Stream`` without a depth; the same packets, byte for byte."""
    from svt_av1_tpu_torch.app.cli import preset_config
    conf, traf = tiny_cell(config, traffic, w, h)
    old = preset_config(**conf["encoder"], device="cpu")
    new = harness.encoder_config(conf, "cpu")
    assert new == old
    seed = 2**31 + 3
    before = encode(old, Stream(w, h, seed, **traf["stream"]), frames)
    after = encode(new, Stream(w, h, seed, bit_depth=new.bit_depth,
                               **traf["stream"]), frames)
    assert len(before) >= frames
    assert [p[0] for p in before] == [p[0] for p in after]


def test_the_existing_configurations_state_no_encoder_fields():
    for path in sorted((harness.BENCH / "configs").glob("*.json")):
        assert "encoder_fields" not in json.loads(path.read_text()), path
