"""Fixtures of the benchmark's CPU tests: a cell's files with the frame
size cut so that the plain PyTorch path on the CPU runs it in seconds."""

import json

import pytest
import torch

from benchmark import harness


@pytest.fixture(scope="session", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def load(config: str, traffic: str):
    """(configuration, traffic) files by name."""
    return (json.loads((harness.BENCH / "configs" / f"{config}.json")
                       .read_text()),
            json.loads((harness.BENCH / "traffic" / f"{traffic}.json")
                       .read_text()))


def tiny_cell(config: str, traffic: str, width: int, height: int):
    """(configuration, traffic) with the frame cut to ``width`` x
    ``height`` and one tile column."""
    conf, traf = load(config, traffic)
    conf["encoder"].update(width=width, height=height, tile_columns=0)
    return conf, traf


def encode(cfg, stream, frames: int):
    """[(tu, recon)] of ``frames`` frames of ``stream`` through the
    port's ``Encoder``, sent and drained as a run does, then flushed."""
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    enc = Encoder(cfg)
    out = []
    for t in range(frames):
        enc.send_picture(*stream.frame(t))
        while (p := enc.get_packet()) is not None:
            out.append(p)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        out.append(p)
    return out
