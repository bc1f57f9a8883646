"""Plain PyTorch version of the fused int8 conv/FC kernel.

The same function as ``csrc/int8_conv.cu``, from ordinary torch ops: the GEMM
in float64, then the SDP epilogue of ``core/intmath.py``.  Torch has no
integer matmul on CUDA; float64 is exact here because every int8 x int8
product is at most 2^14 in magnitude, so any partial sum of K of them stays
below K * 2^14 < 2^53.  The TF32 flags (``torch.backends.cuda.matmul
.allow_tf32``, ``torch.backends.cudnn.allow_tf32``) apply to float32 only and
cannot round these products.  Runs on the CPU and on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.intmath import im2col, row_epilogue, wrap32


def _dot_i8(w: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact, wrapping as int32."""
    acc = w.to(torch.float64) @ cols.to(torch.float64)
    return wrap32(acc.to(torch.int64)).to(torch.int32)


def int8_conv_gemm_ref(w, cols, bias, words, relu: bool) -> torch.Tensor:
    """``clip8(relu?(requant(w @ cols + bias[:, None])))`` -> (M, N) int8."""
    return row_epilogue(_dot_i8(w, cols), bias, words, relu)


def conv2d_int8_ref(x, wq, bias, words, k, stride, pad, groups=1,
                    relu=False) -> torch.Tensor:
    """(C,H,W) int8 conv, one GEMM per group -> (K,P,Q) int8."""
    kk = wq.shape[0]
    c, h, w_in = x.shape
    p = (h + 2 * pad - k) // stride + 1
    q = (w_in + 2 * pad - k) // stride + 1
    cg, kg = c // groups, kk // groups
    outs = [int8_conv_gemm_ref(wq[g * kg:(g + 1) * kg],
                               im2col(x[g * cg:(g + 1) * cg], k, stride, pad),
                               bias[g * kg:(g + 1) * kg],
                               words[g * kg:(g + 1) * kg], relu)
            for g in range(groups)]
    return torch.cat(outs, 0).reshape(kk, p, q)


def fc_int8_ref(x, wq, bias, words, relu=False) -> torch.Tensor:
    """x flat int8, wq (K_out, Cin) -> (K_out, 1, 1) int8."""
    return int8_conv_gemm_ref(wq, x.reshape(-1, 1), bias, words,
                              relu).reshape(-1, 1, 1)
