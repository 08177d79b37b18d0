"""GOP sharding across processes with the port: the twin of
``tests/test_distributed.py``. Two ``torch.distributed`` processes (gloo,
a file rendezvous under the test's own directory) each encode one closed
GOP with the port on the CPU; process 0 gathers the payloads with a
fixed-size all_gather and holds them equal to its own serial encode of
both GOPs, and the test holds them equal to the JAX package's host
encoder's payloads (exact)."""

import hashlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from svt_av1_tpu.bitstream.ivf import read_ivf
from svt_av1_tpu.config import EncoderConfig as JaxConfig
from svt_av1_tpu.pipeline.encoder import encode_ivf as jax_encode_ivf

REPO = Path(__file__).resolve().parents[1]

_WORKER = r"""
import datetime, hashlib, io, sys
import numpy as np
import torch
import torch.distributed as dist
from svt_av1_tpu_torch.bitstream.ivf import read_ivf
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.pipeline.encoder import encode_ivf

torch.set_num_threads(1)
pid = int(sys.argv[2])
dist.init_process_group("gloo", init_method=sys.argv[1], world_size=2,
                        rank=pid, timeout=datetime.timedelta(seconds=300))
w, h, n = 128, 96, 4
rng = np.random.default_rng(7)
base = rng.integers(0, 255, (h + 32, w + 32)).astype(np.uint8)
frames = [(base[2*t:2*t+h, 3*t:3*t+w],
           np.full((h//2, w//2), 100 + 3*t, np.uint8),
           np.full((h//2, w//2), 140, np.uint8)) for t in range(2*n)]
cfg = EncoderConfig(width=w, height=h, qp=40, device="cpu")


def payload(fr):
    _, pkts = read_ivf(io.BytesIO(encode_ivf(fr, cfg)))
    return b"".join(p for _, p in pkts)


# each process encodes ITS closed GOP (key frame first, independent)
mine = np.frombuffer(payload(frames[pid*n:(pid+1)*n]), np.uint8)
CAP = 1 << 20
assert len(mine) <= CAP
buf = torch.zeros(CAP, dtype=torch.uint8)
buf[:len(mine)] = torch.from_numpy(mine.copy())
bufs = [torch.zeros_like(buf) for _ in range(2)]
lens = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
dist.all_gather(bufs, buf)
dist.all_gather(lens, torch.tensor([len(mine)], dtype=torch.int64))
if pid == 0:
    out = b"".join(bytes(b[:int(k)].numpy()) for b, k in zip(bufs, lens))
    assert out == payload(frames[:n]) + payload(frames[n:]), \
        "distributed GOP payloads != serial"
    print("DIST_OK", len(out), hashlib.sha256(out).hexdigest())
dist.destroy_process_group()
"""


def _jax_payloads():
    w, h, n = 128, 96, 4
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (h + 32, w + 32)).astype(np.uint8)
    frames = [(base[2 * t:2 * t + h, 3 * t:3 * t + w],
               np.full((h // 2, w // 2), 100 + 3 * t, np.uint8),
               np.full((h // 2, w // 2), 140, np.uint8))
              for t in range(2 * n)]
    cfg = JaxConfig(width=w, height=h, qp=40)
    out = b""
    for half in (frames[:n], frames[n:]):
        _, pkts = read_ivf(io.BytesIO(jax_encode_ivf(half, cfg)))
        out += b"".join(p for _, p in pkts)
    return out


def test_two_process_gop_sharding(tmp_path):
    script = tmp_path / "dist_worker.py"
    script.write_text(_WORKER)
    init = (tmp_path / "rendezvous").as_uri()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), init, str(i)], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    line = [ln for ln in outs[0].splitlines() if ln.startswith("DIST_OK")]
    assert line, outs[0][-2000:]
    want = _jax_payloads()
    assert line[0].split()[1:] == [str(len(want)),
                                   hashlib.sha256(want).hexdigest()]
