"""The part of ``repro.core.perfmodel`` this slice of the port uses.

Shape arithmetic of CONV/FC descriptors (contraction length, GEMM columns,
MACs), the coalescing bucket ladder, and the names of the port's kernels.
Kernel selection (``select_kernel``) and the whole-model cycle model
(``model_cost``) come with a later slice: on this slice every nv_small CONV/FC
runs through one kernel, so there is nothing to select.
"""

from __future__ import annotations

from repro_torch.core import engine

# The port's kernels.  On a CUDA tensor every CONV/FC runs through the hand
# written sm_90a kernel; on a CPU tensor through its plain PyTorch version.
KERNEL_CUDA_INT8 = "cuda_int8_conv"    # kernels/int8_conv/csrc/int8_conv.cu
KERNEL_TORCH_INT8 = "torch_int8_plain"  # kernels/int8_conv/ref.py
KERNEL_VPU = "vpu"                     # PDP / EW: no GEMM, plain torch ops

# Largest contraction K for which a single f32 GEMM of int8 operands is
# bit-exact (K * 128 * 128 <= 2^24).  The CUDA kernel accumulates in native
# int32 and needs no K tiling; the number is kept as the reference defines it.
EXACT_K = (1 << 24) // (128 * 128)     # = 1024


def bucket_ladder(max_batch: int) -> tuple:
    """The power-of-two coalescing bucket ladder for a ``max_batch`` ceiling:
    1, 2, 4, ... doubling below ``max_batch``, and ``max_batch`` itself as
    the top rung."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    rungs = []
    b = 1
    while b < max_batch:
        rungs.append(b)
        b *= 2
    rungs.append(int(max_batch))
    return tuple(rungs)


def contract_k(d: engine.Descriptor) -> int:
    """Contraction length K of a CONV/FC descriptor (0 for PDP/EW)."""
    _, c, h, w = d.src_dims
    if d.unit == "CONV":
        r, s = d.kernel
        return (c // d.groups) * r * s
    if d.unit == "FC":
        return c * h * w
    return 0


def gemm_cols(d: engine.Descriptor) -> int:
    """N dimension of the descriptor's GEMM: output positions P*Q (1 for FC)."""
    _, _, p, q = d.dst_dims
    return p * q if d.unit == "CONV" else 1


def descriptor_macs(d: engine.Descriptor) -> int:
    _, c, h, w = d.src_dims
    _, k, p, q = d.dst_dims
    if d.unit == "CONV":
        r, s = d.kernel
        return (c // d.groups) * r * s * k * p * q
    if d.unit == "FC":
        return c * h * w * k
    return 0
