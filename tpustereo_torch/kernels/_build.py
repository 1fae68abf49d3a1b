"""Build the CUDA sources under `tpustereo_torch/csrc/` and load them.

Each `csrc/<name>.cu` becomes `build/lib<name>.so`, compiled by `nvcc` for
Hopper (`sm_90a`) with a plain C interface and loaded with `ctypes`. A
library is built at first use and rebuilt when a source is newer than it.
A failed build raises with nvcc's stderr: there is no fallback.

Nothing here runs at import time: the CPU tests import every module, on
machines that may have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
NAMES = ("census_cost", "sgm_sweep", "bwd_wta", "lr_check", "cc_labels",
         "median3", "wta_lr", "sad_wta", "transpose", "sgm_bidir", "bitonic",
         "width_micro", "sgm_fused")

SMEM_MAX = 232448  # bytes of shared memory one block may use on Hopper

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def log_path(name: str) -> str:
    return os.path.join(BUILD, f"{name}.log")


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in (f"{name}.cu", "common.cuh"))
    return newest > os.path.getmtime(out)


def build(names=NAMES) -> float:
    """Compile every stale library of `names`, one nvcc each, all started
    together. Returns the wall seconds spent; raises if any build fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        tmp = lib_path(n) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for n, tmp, p in procs:
        out, err = p.communicate()
        with open(log_path(n), "w") as f:
            f.write(out + err)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {p.returncode}):\n"
                          f"{err}")
        else:
            os.replace(tmp, lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library `name`, built first if missing or stale.

    `signatures` maps each exported function to (argtypes, restype); every
    pointer and the stream are `c_void_p`, so ctypes never cuts them to a
    32-bit int."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(lib_path(name))
        sigs = dict(signatures, tps_error_string=([ctypes.c_int],
                                                  ctypes.c_char_p))
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (`cudaGetLastError`)."""
    if rc != 0:
        msg = lib.tps_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
