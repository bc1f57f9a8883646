"""Public fused bf16-conv entry points: im2col, fold lanes, launch the kernel.

The executor routes every nv_full CONV/FC descriptor here.  On a CUDA tensor
each GEMM launches the hand-written kernel (``kernel.py``); on a CPU tensor it
takes the plain version (``ref.py``).  There is no fallback between the two:
a CUDA tensor the kernel does not take raises.

``conv2d_bf16_batch`` / ``fc_bf16_batch`` run a whole bucket as ONE launch per
group: each lane's im2col columns are stacked side by side on the GEMM N axis
(column = lane * P*Q + position), so the weights are read once per bucket.
The kernel keeps one K order per output element whatever N is, so a folded
lane is bit-identical to its own single-image launch (as in the reference,
``repro/kernels/bf16_conv/ops.py``).  The single-image entry points are the
one-lane case of the same fold.

``launches`` counts kernel launches (never plain-version calls), so a run can
show that its CONV/FC work went through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check_operands, conv_batch, fc_batch
from repro_torch.kernels.bf16_conv import kernel, ref

launches = 0


def gemm(w, cols, bias, relu: bool) -> torch.Tensor:
    """(M, K) x (K, N) bf16, f32 accumulate, fused bias/ReLU -> (M, N) bf16."""
    global launches
    dev = check_operands("bf16_conv_gemm", (
        ("w", w, torch.bfloat16, 2), ("cols", cols, torch.bfloat16, 2),
        ("bias", bias, torch.float32, 1)))
    m, k = w.shape
    if cols.shape[0] != k or bias.shape[0] != m:
        raise ValueError(f"bf16_conv_gemm: shapes w {tuple(w.shape)}, cols "
                         f"{tuple(cols.shape)}, bias {tuple(bias.shape)} do "
                         f"not agree")
    if dev.type == "cuda":
        launches += 1
        return kernel.bf16_conv_gemm(w, cols, bias, relu)
    return ref.bf16_conv_gemm_ref(w, cols, bias, relu)


def conv2d_bf16_batch(xs, wq, bias, k: int, stride: int, pad: int,
                      groups: int = 1, relu: bool = False) -> torch.Tensor:
    """Fused CONV+SDP over a bucket: (B,C,H,W) bf16 -> (B,K,P,Q) bf16.

    wq (K, C/g*k*k) bf16; bias (K,) float32.  One launch per group.
    """
    return conv_batch(lambda w, cols, b: gemm(w, cols, b, relu), xs,
                      (wq, bias), k, stride, pad, groups)


def fc_bf16_batch(xs, wq, bias, relu: bool = False) -> torch.Tensor:
    """Fused FC+SDP over a bucket: (B, Cin) bf16 -> (B, K_out, 1, 1) bf16."""
    return fc_batch(lambda w, cols, b: gemm(w, cols, b, relu), xs, (wq, bias))


def conv2d_bf16(x, wq, bias, k: int, stride: int, pad: int, groups: int = 1,
                relu: bool = False) -> torch.Tensor:
    """Fused CONV+SDP: (C,H,W) bf16 -> (K,P,Q) bf16, f32 accumulate."""
    return conv2d_bf16_batch(x[None], wq, bias, k, stride, pad, groups,
                             relu)[0]


def fc_bf16(x, wq, bias, relu: bool = False) -> torch.Tensor:
    """Fused FC+SDP: flat bf16 input, wq (K_out, Cin) -> (K_out,1,1) bf16."""
    return fc_bf16_batch(x.reshape(1, -1), wq, bias, relu)[0]
