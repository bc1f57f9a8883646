"""W8A8 INT8 GEMM with the fused per-column SDP epilogue, for Hopper.

``csrc/int8_gemm.cu`` is the hand-written sm_90a kernel, ``kernel.py`` builds
and launches it, ``ops.quantized_matmul`` is the entry point, and ``ref.py``
the plain PyTorch version it is held against.
"""

from repro_torch.kernels.int8_gemm.ops import quantized_matmul  # noqa: F401
from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref  # noqa: F401
