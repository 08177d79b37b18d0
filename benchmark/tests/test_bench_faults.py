"""A run with the timed path broken underneath, the harness's look for a
card skipped, must come out not correct: for the control, and for each
fault a cell can have (the state of a step left unchanged, half of the
frames left out, a packet's byte altered where it is produced). The run
without a fault must come out correct."""

import pytest

from benchmark import control, harness
from benchmark.tests.conftest import tiny_cell

# (configuration, traffic, width, height)
CELLS = {"ra1080p.longgop": ("ra1080p", "longgop", 128, 64),
         "ai480.intra": ("ai480", "intra", 64, 64)}


def _run(workload, seed=21):
    config, traffic = tiny_cell(*CELLS[workload])
    _, checks, state = harness.run_cell(config, traffic, seed, 0.5,
                                        trace=False, device="cpu")
    return harness.passes(checks) and not state["decode_error"], checks


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    ok, checks = _run(workload)
    assert ok, checks


@pytest.mark.parametrize("workload", sorted(CELLS))
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
          ("ai480.intra", "packet_byte_altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    with control.FAULTS[fault]():
        ok, checks = _run(workload)
    assert not ok, checks
