"""What a run checks about its own process before it prints a result: one
run is one process. No child process may be alive, no Python thread but
the main one, and no module of JAX or of the JAX package may be loaded.
"""

from __future__ import annotations

import sys
import threading
from pathlib import Path

# top-level module names a run must never load, compared whole: the port's
# package name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "svt_av1_tpu")


def children(pid="self") -> list:
    """["pid comm"] of the live children of every thread of ``pid``."""
    out = []
    for f in sorted(Path(f"/proc/{pid}/task").glob("*/children")):
        for child in f.read_text().split():
            try:
                comm = Path(f"/proc/{child}/comm").read_text().strip()
            except OSError:
                comm = "?"
            out.append(f"{child} {comm}")
    return out


def threads() -> list:
    """Names of the live Python threads other than the main one."""
    main = threading.main_thread()
    return [t.name for t in threading.enumerate() if t is not main]


def survivors() -> list:
    """What the run left alive: child processes and threads."""
    return ([f"child process {c}" for c in children()]
            + [f"thread {t}" for t in threads()])


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def end_of_run() -> list:
    """Everything that keeps a run from printing its result: modules of
    JAX or the JAX package loaded, child processes and threads alive."""
    return ([f"module {m}" for m in forbidden_modules()] + survivors())
