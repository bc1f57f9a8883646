"""Build, load and launch the hand-written CUDA kernel ``csrc/int8_conv.cu``.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, from the sources in this package, into
``_build/`` beside them (listed in ``.gitignore``).  The library's name
carries a hash of the source and the flags, so an edited source is rebuilt
and never confused with an old build.  It is loaded with ``ctypes``; the C
function launches on PyTorch's current stream and returns
``cudaGetLastError()``, which :func:`int8_conv_gemm` turns into an exception.

Nothing here runs when the module is imported: building needs ``nvcc`` and
launching needs a card, and the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

SOURCE = pathlib.Path(__file__).parent / "csrc" / "int8_conv.cu"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lock = threading.Lock()
build_log = ""          # nvcc's output of the last build (ptxas register use)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the int8_conv CUDA kernel is "
                           "built on a machine with the CUDA toolkit")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libint8_conv-{h.hexdigest()[:12]}.so"


def build() -> pathlib.Path:
    """Compile the kernel library unless this source's build exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                           capture_output=True, text=True)
        build_log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{build_log}")
        os.replace(tmp, out)          # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.int8_conv_gemm
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def int8_conv_gemm(w: torch.Tensor, cols: torch.Tensor, bias: torch.Tensor,
                   words: torch.Tensor, relu: bool) -> torch.Tensor:
    """Launch the kernel: ``clip8(relu?(requant(w @ cols + bias[:, None])))``.

    w (M, K) int8, cols (K, N) int8, bias (M,) int32, words (M,) int32, all
    contiguous CUDA tensors on one device -> (M, N) int8.  The caller
    (``ops.py``) checks the arguments; this function only launches.
    """
    m, k = w.shape
    n = cols.shape[1]
    out = torch.empty((m, n), dtype=torch.int8, device=w.device)
    lib = _load()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.int8_conv_gemm(w.data_ptr(), cols.data_ptr(),
                                 bias.data_ptr(), words.data_ptr(),
                                 out.data_ptr(), m, n, k, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"int8_conv_gemm launch failed: CUDA error {err} "
                           f"(M={m}, N={n}, K={k})")
    return out
