"""Build and load the port's CUDA kernels (`csrc/*.cu`).

The sources are compiled with `nvcc` for `sm_90a` at first use, one `nvcc -c`
per source started together, then linked into one shared library with a plain
C interface that ctypes loads. The library is cached under `_kernels_build/`
in the package (listed in `.gitignore`), in a directory named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once. Only the package's own sources are built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_kernels_build")
SOURCES = ("fsmn_conv.cu", "frame_window.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: every pointer and the stream are c_void_p, so ctypes never
# cuts a 64-bit address to a 32-bit int.
_FSMN = [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _I, _I, _I, _I, _I, _P]
SIGNATURES = {
    "fsmn_conv_f32": _FSMN,
    "fsmn_conv_bf16": _FSMN,
    "frame_window_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}   # path, seconds, cached, nvcc/ptxas log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    """Start every command at once, wait for all, raise on the first
    failure. No process outlives this call."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for cmd, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
            logs.append(out)
            if p.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed "
                                   f"({p.returncode}):\n{out}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return "".join(logs)


def build() -> str:
    """Compile the sources (unless cached) and return the library's path."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    so = os.path.join(out_dir, "libport_kernels.so")
    log_path = os.path.join(out_dir, "build.log")
    if os.path.exists(so):
        log = ""
        if os.path.exists(log_path):
            with open(log_path, encoding="utf-8") as f:
                log = f.read()
        build_info.update(path=so, seconds=0.0, cached=True, log=log)
        return so
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = [os.path.join(out_dir, f"{os.path.splitext(s)[0]}.{tag}.o")
            for s in SOURCES]
    log = _run_all([[nvcc, *CFLAGS, "-c", os.path.join(CSRC, s), "-o", o]
                    for s, o in zip(SOURCES, objs)])
    tmp = f"{so}.{tag}.tmp"
    log += _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]])
    with open(log_path, "w", encoding="utf-8") as f:
        f.write(log)
    os.replace(tmp, so)   # atomic: a concurrent build sees all or nothing
    for o in objs:
        os.remove(o)
    build_info.update(path=so, seconds=time.perf_counter() - t0,
                      cached=False, log=log)
    return so


def load() -> ctypes.CDLL:
    """The kernels' library, built at first use, with argtypes declared."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
