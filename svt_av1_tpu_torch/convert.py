"""Carry the JAX package's encoder state across to the port.

The encoder has no learned weights: its state is its configuration, its
constant tables and, mid-stream, its checkpoint. ``config_from_jax`` maps
a JAX ``EncoderConfig`` (as ``dataclasses.asdict``) onto the port's,
``backend`` becoming ``device``; ``load_tables`` returns the port's copies
of the ``.npz`` tables, which the tests hold equal to the JAX package's;
``state_from_jax`` turns a JAX ``Encoder.save_state()`` dict into the
port's ``Encoder.load_state`` input, so a stream stopped in the JAX
package resumes in the port.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np

from svt_av1_tpu_torch.config import EncoderConfig

_PKG = Path(__file__).resolve().parent
# table file -> path inside the package (the same as in the JAX package)
TABLES = ("entropy/data/default_cdfs.npz", "ops/data/txfm_networks.npz",
          "pipeline/data/avail_tables.npz", "ops/data/grain_tables.npz",
          "verify/data/indep_tables.npz")


def config_from_jax(d: dict, device: str = "cuda") -> EncoderConfig:
    """The port's config from ``dataclasses.asdict`` of a JAX
    ``EncoderConfig``: every field carries over; ``backend`` (host or
    device, both the JAX package's own engines) becomes ``device``;
    ``mesh_shape`` carries over unread, as the JAX package leaves it."""
    kw = dict(d)
    kw.pop("backend", None)
    return EncoderConfig(device=device, **kw)


def state_from_jax(state: dict, device: str = "cuda") -> dict:
    """The port's ``Encoder.load_state`` input from a JAX
    ``Encoder.save_state()`` dict (version 3). The slots, GOP and
    lookahead buffers, TMVP stores and the rate-control and scene-detector
    dicts are numpy and plain values and carry over as they are (copied);
    the config gets ``device`` for ``backend``; the per-slot entropy stores
    (the JAX package's FrameContext / NmvContext objects, read by their
    attributes) become the port's classes."""
    from svt_av1_tpu_torch.entropy.cdf import FrameContext
    from svt_av1_tpu_torch.entropy.mv import NmvContext
    assert state.get("version") == 3, state.get("version")

    def frame_context(src):
        fc = object.__new__(FrameContext)
        for attr, _, _ in FrameContext._LAYOUT:
            setattr(fc, attr, np.array(getattr(src, attr), copy=True))
        return fc

    def nmv_context(src):
        nmv = object.__new__(NmvContext)
        nmv.joints = np.array(src.joints, copy=True)
        nmv.comps = [{k: np.array(v, copy=True) for k, v in c.items()}
                     for c in src.comps]
        return nmv

    out = copy.deepcopy({k: v for k, v in state.items()
                         if k != "entropy_uniq"})
    cfg = dict(out["cfg"])
    cfg.pop("backend", None)
    out["cfg"] = {**cfg, "device": device}
    out["entropy_uniq"] = [(frame_context(fc), nmv_context(nmv))
                           for fc, nmv in state["entropy_uniq"]]
    return out


def load_tables() -> dict:
    """{table file: {array name: numpy array}} of the port's tables."""
    out = {}
    for rel in TABLES:
        with np.load(_PKG / rel) as z:
            out[rel] = {k: z[k] for k in z.files}
    return out
