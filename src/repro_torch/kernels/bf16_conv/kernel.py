"""Build, load and launch the hand-written CUDA kernel ``csrc/bf16_conv.cu``.

``LIB`` is built with ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes`` (``kernels/cuda_lib.py``).  Nothing here runs when the module is
imported: building needs ``nvcc`` and launching needs a card.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.cuda_lib import CudaLibrary

LIB = CudaLibrary(pathlib.Path(__file__).parent / "csrc" / "bf16_conv.cu",
                  "bf16_conv_gemm",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def bf16_conv_gemm(w: torch.Tensor, cols: torch.Tensor, bias: torch.Tensor,
                   relu: bool) -> torch.Tensor:
    """Launch the kernel: ``bf16(relu?(w @ cols + bias[:, None]))``, f32
    accumulate.

    w (M, K) bfloat16, cols (K, N) bfloat16, bias (M,) float32, all
    contiguous CUDA tensors on one device -> (M, N) bfloat16.  The caller
    (``ops.py``) checks the arguments; this function only launches.
    """
    m, k = w.shape
    n = cols.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=w.device)
    LIB.launch(w.device, w.data_ptr(), cols.data_ptr(), bias.data_ptr(),
               out.data_ptr(), m, n, k, int(relu),
               what=f"M={m}, N={n}, K={k}")
    return out
