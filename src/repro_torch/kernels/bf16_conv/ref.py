"""Plain PyTorch version of the fused bf16 conv/FC kernel.

The same function as ``csrc/bf16_conv.cu``: bfloat16 operands, the GEMM in
float64 and one rounding of its result to float32, then the float32 bias,
ReLU and ``.to(torch.bfloat16)`` (round to nearest even).  Products of two
bfloat16 values are exact in float64 and the float64 sum is far finer than
float32, so the result does not depend on how the columns are blocked: on
the CPU a lane folded into a bucket gives the bits of its single image.
Against the kernel's float32 accumulation it differs only by summation-order
drift, which ``tolerances.gemm_tolerance(K)`` budgets.  The TF32 flags apply
to float32 only and cannot touch this GEMM.  Runs on the CPU and on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.intmath import im2col


def bf16_conv_gemm_ref(w, cols, bias, relu: bool) -> torch.Tensor:
    """``bf16(relu?(w @ cols + bias[:, None]))`` -> (M, N) bfloat16."""
    acc = (w.to(torch.float64) @ cols.to(torch.float64)).to(torch.float32)
    acc = acc + bias[:, None]
    if relu:
        acc = acc.clamp(min=0.0)
    return acc.to(torch.bfloat16)


def conv2d_bf16_ref(x, wq, bias, k, stride, pad, groups=1,
                    relu=False) -> torch.Tensor:
    """(C,H,W) bf16 conv, one GEMM per group -> (K,P,Q) bf16."""
    kk = wq.shape[0]
    c, h, w_in = x.shape
    p = (h + 2 * pad - k) // stride + 1
    q = (w_in + 2 * pad - k) // stride + 1
    cg, kg = c // groups, kk // groups
    outs = [bf16_conv_gemm_ref(wq[g * kg:(g + 1) * kg],
                               im2col(x[g * cg:(g + 1) * cg], k, stride, pad),
                               bias[g * kg:(g + 1) * kg], relu)
            for g in range(groups)]
    return torch.cat(outs, 0).reshape(kk, p, q)


def fc_bf16_ref(x, wq, bias, relu=False) -> torch.Tensor:
    """x flat bf16, wq (K_out, Cin) -> (K_out, 1, 1) bf16."""
    return bf16_conv_gemm_ref(wq, x.reshape(-1, 1), bias,
                              relu).reshape(-1, 1, 1)
