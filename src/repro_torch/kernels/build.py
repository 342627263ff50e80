"""Build and load the hand-written CUDA kernels.

Every source under ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` — one ``nvcc -c`` per source, all started together — and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library lands in ``build/kernels/`` at the
repository root (git-ignored), named by a hash of every source, header and
the flags, so a second run loads it without rebuilding. Nothing here runs at
import time: a machine without ``nvcc`` can import the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID_P, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: argument types of every C entry point; every pointer and the stream are
#: c_void_p so no address is truncated to 32 bits.
ARGTYPES = {
    # csrc/paged_attention.cu. Decode: q, k, v, tables, pos, out, part_acc,
    # part_ml, lse (NULL = none); B, Hq, Hkv, D, BS, the global block size
    # and the pool slice's offset, MB, cols_per_split; the pool strides;
    # window, dtype, stream
    "paged_attention_decode":
        [_VOID_P] * 9 + [_INT] * 9 + [_I64] * 3 + [_INT, _INT, _VOID_P],
    # prefill: q, k, v, tables, start, out, part_acc, part_ml, lse; B, C,
    # Hq, Hkv, D, BS, the global block size and offset, MB, cols_per_split;
    # the pool strides; window, dtype, stream
    "paged_attention_prefill":
        [_VOID_P] * 9 + [_INT] * 10 + [_I64] * 3 + [_INT, _INT, _VOID_P],
    # csrc/flash_attention.cu: q, k, v, out, lse (NULL = none); B, S, Hq,
    # Hkv, D; the three (batch, seq, head) strides of q, k and v; causal,
    # window, the key count Sk and the query offset, dtype, stream
    "flash_attention_forward":
        [_VOID_P] * 5 + [_INT] * 5 + [_I64] * 9 + [_INT] * 5 + [_VOID_P],
    # csrc/flash_attention_bwd.cu: q, k, v, out, dout, lse, dq, dk, dv,
    # dsum; B, S, Hq, Hkv, D; the strides of q, k and v; causal, window,
    # groups (the CTA shape: 0 by the kernel's rule, 4 or 2), dtype, stream
    "flash_attention_backward":
        [_VOID_P] * 10 + [_INT] * 5 + [_I64] * 9 + [_INT] * 4 + [_VOID_P],
    # csrc/grouped_matmul.cu: x, w, valid_rows (NULL = all), out; G, C, K,
    # N, dtype, stream
    "grouped_matmul_forward": [_VOID_P] * 4 + [_INT] * 5 + [_VOID_P],
    # csrc/ssd_scan.cu: x, a, B, C, y, chunk states, chunk decays; B, S, H,
    # P, N, Q, stream
    "ssd_scan_forward": [_VOID_P] * 7 + [_INT] * 6 + [_VOID_P],
    # csrc/ssd_scan_bwd.cu: x, a, B, C, dy, the forward's states, the
    # reversed states and chunk decays (scratch), dx, da, dB, dC; B, S, H,
    # P, N, Q, stream
    "ssd_scan_backward": [_VOID_P] * 12 + [_INT] * 6 + [_VOID_P],
}

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


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build() -> Tuple[Path, str]:
    """Compile the kernels unless a build of these exact sources exists.
    Returns (library path, ptxas report — "" when the build was cached)."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + headers():
        h.update(s.name.encode() + b"\0" + s.read_bytes())
    lib = BUILD_DIR / f"kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(srcs, objs)]
        reports = []
        for s, p in zip(srcs, procs):
            out, err = p.communicate()
            if p.returncode != 0:
                for q in procs:
                    q.kill()
                    q.wait()
                raise RuntimeError(f"nvcc failed ({p.returncode}) on {s}:\n"
                                   f"{out}\n{err}")
            reports.append(err)
        tmp_lib = Path(tmp) / lib.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp_lib, lib)
    return lib, "".join(reports)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def raise_on(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (0 = launched)."""
    if code != 0:
        msg = library().kernels_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
