"""Fused INT8 convolution / FC (NVDLA CONV->SDP) for Hopper.

``csrc/int8_conv.cu`` is the hand-written sm_90a kernel, ``kernel.py`` builds
and launches it, ``ops.py`` holds the entry points the executor calls, and
``ref.py`` the plain PyTorch version it is held against.
"""

from repro_torch.kernels.int8_conv.ops import (conv2d_int8, conv2d_int8_batch,  # noqa: F401
                                               fc_int8, fc_int8_batch)
from repro_torch.kernels.int8_conv.ref import conv2d_int8_ref, fc_int8_ref  # noqa: F401
