"""Public W8A8 matmul entry point: check the operands, launch the kernel.

``quantized_matmul`` has the semantics of the reference's
``repro.kernels.int8_gemm.ops.quantized_matmul``: x (M, K) int8 times
w (K, N) int8, the int32 bias and the packed scale words indexed by output
column, -> (M, N) int8.  On a CUDA tensor it launches the hand-written kernel
(``kernel.py``); on a CPU tensor it takes the plain version (``ref.py``).
There is no fallback between the two: a CUDA tensor the kernel does not take
raises.  No padding: the kernel masks ragged edges itself.

``launches`` counts kernel launches (never plain-version calls).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check_operands
from repro_torch.kernels.int8_gemm import kernel, ref

launches = 0


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     scale_words: torch.Tensor,
                     relu: bool = False) -> torch.Tensor:
    """W8A8 matmul with the fused per-column SDP epilogue -> (M, N) int8.

    x (M, K) int8, w (K, N) int8, bias (N,) int32, scale_words (N,) int32.
    """
    global launches
    dev = check_operands("quantized_matmul", (
        ("x", x, torch.int8, 2), ("w", w, torch.int8, 2),
        ("bias", bias, torch.int32, 1),
        ("scale_words", scale_words, torch.int32, 1)))
    k, n = w.shape
    if x.shape[1] != k or bias.shape[0] != n or scale_words.shape[0] != n:
        raise ValueError(f"quantized_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)}, "
                         f"scale_words {tuple(scale_words.shape)} do not agree")
    if dev.type == "cuda":
        launches += 1
        return kernel.int8_gemm(x, w, bias, scale_words, relu)
    return ref.int8_gemm_ref(x, w, bias, scale_words, relu)
