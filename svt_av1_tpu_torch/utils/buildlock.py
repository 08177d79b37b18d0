"""Serialize the first-use builds of the port's native libraries.

The CUDA kernels (``cuda_build``) and the host range coder (``native``)
compile at first use into the package's git-ignored ``build/``. Several
encoders may reach that first use together: the threads of ``--jobs`` and
``--nch`` in one process, or test workers in several. A build therefore
runs under ``build_lock`` (a lock shared by this process's threads and an
``fcntl`` lock on the build directory's ``.lock`` file for other
processes; the kernel drops the latter when its process ends, so a stale
file blocks nothing), checks again whether the library is still stale
once it holds the lock, compiles to a name of its own thread
(``temp_path``) and renames it into place.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import threading
from pathlib import Path

_THREADS = threading.Lock()


@contextlib.contextmanager
def build_lock(directory: Path):
    """Hold the builds of ``directory`` (created if missing) against every
    other thread of this process and every other process."""
    directory.mkdir(parents=True, exist_ok=True)
    with _THREADS, open(directory / ".lock", "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def temp_path(path: Path) -> Path:
    """A temporary name beside ``path``, unique to this process and thread."""
    return path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
