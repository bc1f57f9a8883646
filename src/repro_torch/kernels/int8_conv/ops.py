"""Public fused-conv entry points: im2col, fold lanes, launch the kernel.

The executor routes every nv_small CONV/FC descriptor here.  On a CUDA tensor
each GEMM launches the hand-written kernel (``kernel.py``); on a CPU tensor it
takes the plain version (``ref.py``).  There is no fallback between the two:
a CUDA tensor the kernel does not take raises.

``conv2d_int8_batch`` / ``fc_int8_batch`` run a whole bucket as ONE launch per
group: each lane's im2col columns are stacked side by side on the GEMM N axis
(column = lane * P*Q + position), so the weights are read once per bucket.
Folding is byte-exact: GEMM columns are independent and the epilogue is per
row.  The single-image entry points are the one-lane case of the same fold.

``launches`` counts kernel launches (never plain-version calls), so a run can
show that its CONV/FC work went through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check_operands, conv_batch, fc_batch
from repro_torch.kernels.int8_conv import kernel, ref

launches = 0


def gemm(w, cols, bias, words, relu: bool) -> torch.Tensor:
    """(M, K) x (K, N) int8 with the fused SDP epilogue -> (M, N) int8."""
    global launches
    dev = check_operands("int8_conv_gemm", (
        ("w", w, torch.int8, 2), ("cols", cols, torch.int8, 2),
        ("bias", bias, torch.int32, 1), ("words", words, torch.int32, 1)))
    m, k = w.shape
    if cols.shape[0] != k or bias.shape[0] != m or words.shape[0] != m:
        raise ValueError(f"int8_conv_gemm: shapes w {tuple(w.shape)}, cols "
                         f"{tuple(cols.shape)}, bias {tuple(bias.shape)}, "
                         f"words {tuple(words.shape)} do not agree")
    if dev.type == "cuda":
        launches += 1
        return kernel.int8_conv_gemm(w, cols, bias, words, relu)
    return ref.int8_conv_gemm_ref(w, cols, bias, words, relu)


def conv2d_int8_batch(xs, wq, bias, words, k: int, stride: int, pad: int,
                      groups: int = 1, relu: bool = False) -> torch.Tensor:
    """Fused CONV+SDP over a bucket: (B,C,H,W) int8 -> (B,K,P,Q) int8.

    wq (K, C/g*k*k) int8; bias/words (K,) int32.  One launch per group.
    """
    return conv_batch(lambda w, cols, b, s: gemm(w, cols, b, s, relu), xs,
                      (wq, bias, words), k, stride, pad, groups)


def fc_int8_batch(xs, wq, bias, words, relu: bool = False) -> torch.Tensor:
    """Fused FC+SDP over a bucket: (B, Cin) int8 -> (B, K_out, 1, 1) int8."""
    return fc_batch(lambda w, cols, b, s: gemm(w, cols, b, s, relu), xs,
                    (wq, bias, words))


def conv2d_int8(x, wq, bias, words, k: int, stride: int, pad: int,
                groups: int = 1, relu: bool = False) -> torch.Tensor:
    """Fused CONV+SDP: (C,H,W) int8 -> (K,P,Q) int8, byte-exact vs refops."""
    return conv2d_int8_batch(x[None], wq, bias, words, k, stride, pad,
                             groups, relu)[0]


def fc_int8(x, wq, bias, words, relu: bool = False) -> torch.Tensor:
    """Fused FC+SDP: flat int8 input, wq (K_out, Cin) -> (K_out,1,1) int8."""
    return fc_int8_batch(x.reshape(1, -1), wq, bias, words, relu)[0]
