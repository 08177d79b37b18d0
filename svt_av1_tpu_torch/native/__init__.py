"""Native library loader: compiles the package's ``native/svt_ec.c`` on demand.

The serial entropy stage runs as C (the equivalent of the reference's
hand-optimized bitstream path); everything batched runs as PyTorch. The
library is built with gcc into the package's git-ignored ``build/native``
and invalidated by source content hash (mtime is unreliable across
checkouts). The build runs under ``utils.buildlock.build_lock``, writes a
temporary file of its own thread and renames it into place, so concurrent
first uses (encoder threads, test workers) build once and never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

from svt_av1_tpu_torch.utils.buildlock import build_lock, temp_path
from svt_av1_tpu_torch.utils.trace import setup_step

_HERE = Path(__file__).resolve().parent
_SOURCES = [_HERE / "svt_ec.c", _HERE / "svt_txfm.c", _HERE / "svt_quant.c"]
_BUILD = _HERE.parent / "build" / "native"

c_i32p = ctypes.POINTER(ctypes.c_int32)
c_i16p = ctypes.POINTER(ctypes.c_int16)
c_u8p = ctypes.POINTER(ctypes.c_uint8)


def _build(rec: dict = None) -> Path:
    """The library, compiled first if stale; ``rec["built"]``, where
    ``rec`` is given, says whether gcc ran."""
    so = _BUILD / "libsvt_native.so"
    stamp = _BUILD / "sources.sha256"
    h = hashlib.sha256()
    for s in _SOURCES:
        h.update(s.read_bytes())
    digest = h.hexdigest()
    with build_lock(_BUILD):
        stale = (not so.exists() or not stamp.exists()
                 or stamp.read_text().strip() != digest)
        if stale:
            tmp = temp_path(so)
            cmd = ["gcc", "-O3", "-fPIC", "-shared", "-Wall", "-o", str(tmp)]
            cmd += [str(s) for s in _SOURCES]
            subprocess.check_call(cmd)
            os.replace(tmp, so)
            tmp_stamp = temp_path(stamp)
            tmp_stamp.write_text(digest)
            os.replace(tmp_stamp, stamp)
    if rec is not None:
        rec["built"] = stale
    return so


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    with setup_step("build_native") as rec:
        L = ctypes.CDLL(str(_build(rec)))
    L.svt_ec_create.restype = ctypes.c_void_p
    L.svt_ec_create.argtypes = [ctypes.c_int]
    L.svt_ec_free.argtypes = [ctypes.c_void_p]
    L.svt_ec_tell_bits.restype = ctypes.c_int
    L.svt_ec_tell_bits.argtypes = [ctypes.c_void_p]
    # hot entry points take raw address ints (arr.ctypes.data): the
    # data_as/cast pair costs ~1.5 us per call and the syntax pass makes
    # hundreds of thousands of them per frame
    L.svt_ec_symbol.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int]
    L.svt_ec_bool.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    L.svt_ec_literal.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    L.svt_ec_done.restype = ctypes.c_int
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_i8p = ctypes.POINTER(ctypes.c_int8)
    L.svt_txfm_exec.argtypes = [c_i64p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, c_i32p, c_i32p, c_i64p,
                                c_i64p, c_i8p, ctypes.c_int, ctypes.c_int]
    L.svt_ec_done.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_int]
    L.svt_write_coeffs_txb.restype = ctypes.c_int32
    vp = ctypes.c_void_p
    L.svt_write_coeffs_txb.argtypes = [
        vp, ctypes.c_int, vp, ctypes.c_int, ctypes.c_int,
        vp, ctypes.c_int, vp,
        vp,                           # txb_skip row
        vp, ctypes.c_int,             # eob_pt row, nsyms
        vp, vp, vp, vp, vp,
        vp, ctypes.c_int, ctypes.c_int,
    ]
    L.svt_quantize_b.restype = ctypes.c_int
    L.svt_quantize_b.argtypes = [
        c_i32p, ctypes.c_int, ctypes.c_int, c_i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_i32p, c_i32p, c_i32p,
    ]
    return L


def available() -> bool:
    try:
        lib()
        return True
    except Exception:
        return False
