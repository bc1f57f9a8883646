"""Fused BF16 convolution / FC (NVDLA nv_full CONV->SDP) for Hopper.

``csrc/bf16_conv.cu`` is the hand-written sm_90a kernel (bf16 operands, f32
accumulation, f32 bias, one rounding to bf16), ``kernel.py`` builds and
launches it, ``ops.py`` holds the entry points the executor calls, and
``ref.py`` the plain PyTorch version it is held against.
"""

from repro_torch.kernels.bf16_conv.ops import (conv2d_bf16, conv2d_bf16_batch,  # noqa: F401
                                               fc_bf16, fc_bf16_batch)
from repro_torch.kernels.bf16_conv.ref import conv2d_bf16_ref, fc_bf16_ref  # noqa: F401
