"""Plain PyTorch version of the W8A8 GEMM + per-column SDP epilogue.

The same function as ``csrc/int8_gemm.cu``: the GEMM in int64, exact for
every K, then the epilogue of ``core/intmath.py`` with the channel tables on
the column axis.  Torch has no int64 matmul on CUDA, so on the card the GEMM
runs in float64, which is exact too: every int8 x int8 product is at most
2^14 in magnitude, so any partial sum of K of them stays below
K * 2^14 < 2^53.  Runs on the CPU and on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.intmath import col_epilogue, wrap32


def _dot_i8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact, wrapping as int32."""
    if x.device.type == "cpu":
        acc = x.to(torch.int64) @ w.to(torch.int64)
    else:
        acc = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)
    return wrap32(acc).to(torch.int32)


def int8_gemm_ref(x, w, bias, words, relu: bool = False) -> torch.Tensor:
    """``clip8(relu?(requant(x @ w + bias[None, :])))`` -> (M, N) int8."""
    return col_epilogue(_dot_i8(x, w), bias, words, relu)
