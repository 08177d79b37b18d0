"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries go to
the package's git-ignored ``build/cuda`` under a name keyed by the source
and flag digest, so a changed source is rebuilt. Concurrent first uses
(threads of one process, or processes) build once and never load a
half-written file: the build runs under ``utils.buildlock.build_lock``,
compiles to a temporary name of its own thread and renames it into place.
Sources compile in parallel, one ``nvcc`` per source. Nothing is built at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from svt_av1_tpu_torch.utils.buildlock import build_lock, temp_path
from svt_av1_tpu_torch.utils.trace import setup_step

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build" / "cuda"
# kernel name -> source under csrc/
KERNELS = {"quant": "quant.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda. Raises FileNotFoundError where there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise FileNotFoundError("nvcc not found: the CUDA kernels are built "
                            "on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / KERNELS[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}.{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every stale kernel library (all of ``KERNELS`` by default)
    with one nvcc process per source, all started together. Returns
    {name: nvcc's output (ptxas register and shared-memory report)} for
    the sources it compiled; raises RuntimeError if one fails."""
    names = list(KERNELS) if names is None else list(names)
    if all(library_path(n).exists() for n in names):
        return {}
    with build_lock(BUILD):
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:            # another thread or process built them
            return {}
        exe = nvcc_path()
        procs = {}
        for n in todo:
            tmp = temp_path(library_path(n))
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n])]
            procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True))
        logs, failed = {}, []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            logs[n] = out
            if p.returncode != 0:
                failed.append(f"{n}: nvcc exit {p.returncode}\n{out}")
                continue
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if stale; recorded as the
    set-up step ``build_cuda``."""
    with setup_step("build_cuda") as rec:
        rec["built"] = bool(build_all([name]))
        return ctypes.CDLL(str(library_path(name)))
