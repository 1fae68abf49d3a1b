"""Host C code of the port, built with the host's C compiler at first use:
the counterpart of the JAX package's `native/` loader, of which the port
needs the PNG decode's inner loop (`png_unfilter.c`).

`png_unfilter.c` becomes `build/libpng_unfilter.so`, compiled by `cc` (or
`$CC`) into a temporary file that `os.replace` moves into place, and is
rebuilt when the source is newer. It is loaded with `ctypes.CDLL`, which
releases the interpreter lock for each call, so a decode in a prefetch
thread overlaps the caller's loop. A failed build raises with the
compiler's output: there is no fallback to the numpy decode, which stays
as the plain version the tests hold this code to (`data.io._unfilter`).

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "png_unfilter.c")
BUILD = os.path.join(os.path.dirname(HERE), "build")
CFLAGS = ["-O3", "-shared", "-fPIC", "-std=c99"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler() -> str:
    """The host C compiler: `$CC`, else `cc`, found on PATH."""
    cc = os.environ.get("CC", "cc")
    found = shutil.which(cc)
    if not found:
        raise RuntimeError(f"C compiler {cc!r} not found: the PNG decode "
                           f"needs one (set CC or put cc on PATH)")
    return found


def lib_path(build_dir: str = BUILD) -> str:
    return os.path.join(build_dir, "libpng_unfilter.so")


def build(build_dir: str = BUILD) -> str:
    """Compile `png_unfilter.c` into build_dir when missing or stale;
    returns the library's path. Raises if the compiler fails."""
    out = lib_path(build_dir)
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(SOURCE)):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    proc = subprocess.run([compiler(), *CFLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (rc "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64]
            lib.png_unfilter.restype = ctypes.c_int64
            _lib = lib
        return _lib


def png_unfilter(raw: np.ndarray, h: int, stride: int,
                 bpp: int) -> np.ndarray:
    """Undo the PNG row filters: raw (h * (1 + stride),) uint8 -> (h,
    stride) uint8, bpp the filter's byte distance (`png_unfilter.c`)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.ndim != 1 or raw.size != h * (1 + stride) or bpp < 1:
        raise ValueError(f"PNG rows of {raw.size} bytes, expected {h} x "
                         f"(1 + {stride}), bpp {bpp}")
    out = np.empty((h, stride), np.uint8)
    rc = _load().png_unfilter(raw.ctypes.data, out.ctypes.data, h, stride,
                              bpp)
    if rc:
        raise ValueError(f"bad PNG filter type {raw[(rc - 1) * (1 + stride)]}")
    return out
