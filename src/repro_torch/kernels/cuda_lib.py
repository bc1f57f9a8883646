"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel source (``<kernel>/csrc/<name>.cu``) is compiled with ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface, at first
use, into ``_build/`` beside the kernel packages (listed in ``.gitignore``).
The library's name carries a hash of the source, of the headers it may
include (``kernels/csrc/*.cuh``) and of the flags, so an edited source is
rebuilt and never confused with an old build.  It is loaded with ``ctypes``;
every C entry point launches on the stream it is given and returns
``cudaGetLastError()``, which :meth:`CudaLibrary.launch` turns into an
exception.

Nothing here runs when a module is imported: building needs ``nvcc`` and
launching needs a card, and the CPU tests import every module.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

INCLUDE_DIR = pathlib.Path(__file__).parent / "csrc"   # headers shared by kernels
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


class CudaLibrary:
    """One kernel source, its shared library and its C entry point.

    ``argtypes`` lists the entry point's ctypes argument types: pointers and
    the stream as ``c_void_p`` (ctypes would cut a bare int to 32 bits).
    """

    def __init__(self, source: pathlib.Path, symbol: str, argtypes: list):
        self.source = pathlib.Path(source)
        self.symbol = symbol
        self.argtypes = argtypes
        self.build_log = ""         # nvcc's output of this process's build
        self.build_seconds = None   # wall time of that build (None: cached)
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> pathlib.Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(INCLUDE_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:12]}.so"

    def build(self) -> pathlib.Path:
        """Compile the library unless this source's build exists."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, f"-I{INCLUDE_DIR}",
                                "-o", tmp, str(self.source)],
                               capture_output=True, text=True)
            self.build_log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n"
                                   f"{self.build_log}")
            os.replace(tmp, out)          # atomic: concurrent builders agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        return out

    def fn(self):
        """The loaded C entry point (built first if need be)."""
        with self._lock:
            if self._fn is None:
                fn = getattr(ctypes.CDLL(str(self.build())), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args, what: str = "") -> None:
        """Call the entry point on ``device``'s current stream (appended as
        the last argument); raise if the launch was refused."""
        fn = self.fn()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{err} ({what})")


def build_all(libs) -> None:
    """Build several libraries at once, one ``nvcc`` process each."""
    with concurrent.futures.ThreadPoolExecutor(max(len(libs), 1)) as pool:
        for f in [pool.submit(lib.build) for lib in libs]:
            f.result()
