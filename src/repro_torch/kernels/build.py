"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``build/kernels/`` at the repository root
(git-ignored), named by a hash of the source and the flags, so a second run
loads it without rebuilding. Nothing here runs at import time: a machine
without ``nvcc`` can import the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID_P, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: argument types of the two C entry points (csrc/paged_attention.cu);
#: every pointer and the stream are c_void_p so no address is truncated.
_DECODE_ARGS = [_VOID_P] * 6 + [_INT] * 6 + [_I64] * 3 + [_INT, _INT, _VOID_P]
_PREFILL_ARGS = [_VOID_P] * 6 + [_INT] * 7 + [_I64] * 3 + [_INT, _INT, _VOID_P]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def build() -> Tuple[Path, str]:
    """Compile the kernels unless a build of this exact source exists.
    Returns (library path, ptxas report — "" when the build was cached)."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"paged_attention_{key}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.paged_attention_decode.argtypes = _DECODE_ARGS
        lib.paged_attention_decode.restype = ctypes.c_int
        lib.paged_attention_prefill.argtypes = _PREFILL_ARGS
        lib.paged_attention_prefill.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
