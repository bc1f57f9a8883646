// Fused INT8 conv-as-GEMM with the NVDLA CONV->SDP epilogue, for sm_90a.
//
//   out(M,N) int8 = clip8(relu?(apply_scale(W(M,K) . cols(K,N) + bias[M],
//                                           m[M], pre[M], post[M])))
//
// Replaces the Pallas TPU kernel repro/kernels/int8_conv/kernel.py
// (int8_conv_gemm, body _int8_conv_kernel).  Output channels sit on the M
// axis, so the SDP epilogue is per row: int32 bias add, the fixed-point
// requant ((acc >> pre) * m) >> post with round-half-away-from-zero shifts,
// optional ReLU and the int8 clip.  The int32 accumulator lives in registers
// and never goes to device memory: the epilogue runs in the same kernel.
//
// The tiled __dp4a GEMM, its masking and the wraparound arithmetic are in
// ../../csrc/int8_sdp.cuh (shared with the W8A8 kernel int8_gemm.cu, which
// indexes the same epilogue by column); that header states the design and
// the arithmetic's domain (pre, post in [0, 31]).
//
// Bound on the card at ResNet-18 (3x32x32, nv_small) shapes: at batch 1 the
// 21 CONV/FC GEMMs must read 11.2 MB of weights, 3.3 us at 3.35 TB/s, while
// their 37.0 M MACs take 0.04 us at the dense int8 tensor-core rate, so the
// weights bound the work.  At bucket 8 and above the MACs grow with the lanes
// while the weights are read once; __dp4a runs on the CUDA cores at roughly
// 1/30 of the tensor-core int8 rate, so there this design is bound by its
// own dp4a issue rate well before the card's.
//
// Left for later: mma.sync / wgmma s8 tensor-core tiles, cp.async or TMA
// pipelining of the K loop, implicit im2col (reading the activation surface
// directly instead of a materialised cols matrix), split-K for the narrow-N
// layers at batch 1 (few output tiles leave most SMs idle), CUDA graphs.

#include "int8_sdp.cuh"

// C entry point, bound with ctypes.  Row-major contiguous operands:
// w (M, K) int8, cols (K, N) int8, bias (M,) int32, words (M,) int32 packed
// (m << 16) | (pre << 8) | post, out (M, N) int8.  Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int int8_conv_gemm(const void* w, const void* cols,
                              const void* bias, const void* words, void* out,
                              int M, int N, int K, int relu, void* stream) {
  return int8_sdp::launch_gemm_sdp<false>(w, cols, bias, words, out, M, N, K,
                                          relu, stream);
}
