"""A run with the timed path broken underneath, the harness's look for a
card skipped, must come out not correct: for the control, and for each
fault a cell can have (the state of a step left unchanged, half of the
frames left out, a packet's byte altered where it is produced). The run
without a fault must come out correct."""

import copy

import pytest

from benchmark import control, harness
from benchmark.tests.conftest import tiny_cell

# (configuration, traffic, width, height)
CELLS = {"ra1080p.longgop": ("ra1080p", "longgop", 128, 64),
         "ai480.intra": ("ai480", "intra", 64, 64)}
# a 10-bit VBR stream with a short lookahead and both post-filters, its
# files defined here: the key frame and the first mini-GOP come out in
# the 7 set-up frames (1 + the lookahead of 2 + 4)
VBR10 = ({"encoder": {"width": 128, "height": 64, "bit_depth": 10,
                      "qp": 40, "preset": 5, "intra_period": -1,
                      "hierarchical_levels": 2, "tile_columns": 0,
                      "tbr": 200000, "lad": 2},
          "encoder_fields": {"enable_cdef": True,
                             "enable_restoration": True},
          "limits": {"mismatch_samples": 0, "frames_lost": 0,
                     "min_psnr_y_db": 31.0}},
         {"stream": {"cut_every": 0, "first_cut": 0, "pan_px": [3, 2],
                     "noise_sigma": 6.0, "shot_luma_step": 60.0},
          "setup_frames": 7, "profile": "inter"})
WORKLOADS = sorted(CELLS) + ["vbr10.tiny"]


def _cell(workload):
    if workload == "vbr10.tiny":
        return copy.deepcopy(VBR10)
    return tiny_cell(*CELLS[workload])


def _run(workload, seed=21):
    config, traffic = _cell(workload)
    _, checks, state = harness.run_cell(config, traffic, seed, 0.5,
                                        trace=False, device="cpu")
    return harness.passes(checks) and not state["decode_error"], checks


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    ok, checks = _run(workload)
    assert ok, checks


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    with control.control():
        ok, checks = _run(workload)
    assert not ok
    # each half of the control moves a number of its own
    assert checks["mismatch_samples"]["value"] > 0
    assert checks["min_psnr_y_db"]["value"] \
        < checks["min_psnr_y_db"]["limit"]


FAULTS = [("ra1080p.longgop", "slots_unchanged"),
          ("ra1080p.longgop", "stale_source"),
          ("ra1080p.longgop", "half_frames_dropped"),
          ("ra1080p.longgop", "packet_byte_altered"),
          ("ra1080p.longgop", "recon_7bit"),
          ("ai480.intra", "stale_source"),
          ("ai480.intra", "half_frames_dropped"),
          ("ai480.intra", "packet_byte_altered"),
          ("vbr10.tiny", "recon_7bit"),
          ("vbr10.tiny", "stale_source"),
          ("vbr10.tiny", "packet_byte_altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    with control.FAULTS[fault]():
        ok, checks = _run(workload)
    assert not ok, checks
