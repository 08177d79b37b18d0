"""The check's control and the faults it must catch, planted in the
program by patching its ``Encoder`` from here. The benchmark's own runs
never load this module.

The control breaks the two guarantees the configurations state:
- ``recon_7bit``: the reconstruction the encoder reports is computed to
  one bit below the stated depth (its lowest bit cleared: 7 bits of 8, 9
  of 10), so it no longer equals what the stream decodes to;
- ``stale_source``: each frame is coded from the previous frame's source,
  so a frame no longer carries its own picture (the encoder's state for
  the new frame left unchanged).

The further faults of a run: ``slots_unchanged`` (an inter frame's
compute leaves the reference slots as they were), ``half_frames_dropped``
(every second frame never reaches the encoder) and ``packet_byte_altered``
(a byte of a packet changed where it is produced).

    python3 benchmark/control.py --workload ra1080p.longgop \
        --seeds 101,102,103 --seconds 51

runs the control at the cell's own size, one run per seed in this
process, and prints each run's compared numbers as a JSON line.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _encoder():
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    return Encoder


def recon_7bit():
    def make(orig):
        def get_packet(self):
            pkt = orig(self)
            if pkt is None or pkt[1] is None:
                return pkt
            return pkt[0], [p - (p & 1) for p in pkt[1]]
        return get_packet
    return _patched(_encoder(), "get_packet", make)


def stale_source():
    def make(orig):
        def send_picture(self, y, u, v):
            prev = getattr(self, "_control_prev", (y, u, v))
            self._control_prev = (y, u, v)
            return orig(self, *prev)
        return send_picture
    return _patched(_encoder(), "send_picture", make)


def slots_unchanged():
    def make(orig):
        def encode_inter(self, *a, **k):
            slots = list(self._slots)
            out = orig(self, *a, **k)
            self._slots[:] = slots
            return out
        return encode_inter
    return _patched(_encoder(), "_encode_inter", make)


def half_frames_dropped():
    def make(orig):
        def send_picture(self, y, u, v):
            self._control_n = getattr(self, "_control_n", 0) + 1
            if self._control_n % 2 == 0:
                return None
            return orig(self, y, u, v)
        return send_picture
    return _patched(_encoder(), "send_picture", make)


def packet_byte_altered(which: int = 2):
    """Flip the bits of one byte in the middle of the ``which``-th packet
    of more than 16 bytes."""
    def make(orig):
        def get_packet(self):
            pkt = orig(self)
            if pkt is None or len(pkt[0]) <= 16:
                return pkt
            self._control_k = getattr(self, "_control_k", 0) + 1
            if self._control_k != which:
                return pkt
            tu = bytearray(pkt[0])
            tu[len(tu) // 2] ^= 0xFF
            return bytes(tu), pkt[1]
        return get_packet
    return _patched(_encoder(), "get_packet", make)


FAULTS = {"recon_7bit": recon_7bit, "stale_source": stale_source,
          "slots_unchanged": slots_unchanged,
          "half_frames_dropped": half_frames_dropped,
          "packet_byte_altered": packet_byte_altered}


@contextlib.contextmanager
def control():
    """The control: ``recon_7bit`` and ``stale_source`` together (each
    moves a number of its own: the mismatch, the worst frame's PSNR)."""
    with recon_7bit(), stale_source():
        yield


def main(argv=None) -> None:
    import argparse
    import json

    from benchmark import harness
    ap = argparse.ArgumentParser(description="the check's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    manifest = harness.load_manifest()
    cell, config, traffic = harness.load_cell(args.workload, manifest)
    for seed in (int(s) for s in args.seeds.split(",")):
        with control():
            _, checks, state = harness.run_cell(config, traffic, seed,
                                                args.seconds, trace=False)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "correct": harness.passes(checks)
                          and not state["decode_error"],
                          "checks": checks,
                          "decode_error": state["decode_error"]}),
              flush=True)


if __name__ == "__main__":
    main()
