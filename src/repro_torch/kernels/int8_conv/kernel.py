"""Build, load and launch the hand-written CUDA kernel ``csrc/int8_conv.cu``.

``LIB`` is built with ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes`` (``kernels/cuda_lib.py``).  Nothing here runs when the module is
imported: building needs ``nvcc`` and launching needs a card.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.cuda_lib import CudaLibrary

LIB = CudaLibrary(pathlib.Path(__file__).parent / "csrc" / "int8_conv.cu",
                  "int8_conv_gemm",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


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
    LIB.launch(w.device, w.data_ptr(), cols.data_ptr(), bias.data_ptr(),
               words.data_ptr(), out.data_ptr(), m, n, k, int(relu),
               what=f"M={m}, N={n}, K={k}")
    return out
