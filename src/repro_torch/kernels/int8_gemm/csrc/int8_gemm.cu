// W8A8 INT8 GEMM with the fused NVDLA SDP epilogue per output column, for
// sm_90a.
//
//   out(M,N) int8 = clip8(relu?(apply_scale(x(M,K) . w(K,N) + bias[N],
//                                           m[N], pre[N], post[N])))
//
// Replaces the Pallas TPU kernel repro/kernels/int8_gemm/kernel.py
// (int8_gemm, body _int8_gemm_kernel, epilogue _epilogue).  Output channels
// sit on the N axis, so the bias and the packed scale words are indexed by
// column: int32 bias add, the fixed-point requant ((acc >> pre) * m) >> post
// with round-half-away-from-zero shifts, optional ReLU, the int8 clip.  The
// int32 accumulator stays in registers; the epilogue runs in the same kernel.
//
// The GEMM is the int8 conv kernel's (../../csrc/int8_sdp.cuh, with the
// channel tables read per column): a tiled __dp4a loop with native int32
// accumulation, exact for every K below 131072, ragged M, N and K masked with
// zero fill, and every wrapping step done in uint32 (domain: pre, post in
// [0, 31]; quant.fixed_point writes pre <= 16, post <= 30).
//
// Bound on the card: the operands and the output are each touched once, so
// at the shapes the port runs (a transposed ResNet-18 nv_small pass at
// batch 1: M = positions, K up to 4608, N = channels up to 512) the work is
// bound by the 11.2 MB of weights, 3.3 us at 3.35 TB/s, far above the 0.04 us
// the 37 M MACs take at the dense int8 tensor-core rate.  __dp4a runs on the
// CUDA cores at about 1/30 of that rate, so at large M this design is bound
// by its own issue rate.
//
// Left for later: mma.sync / wgmma s8 tensor-core tiles, cp.async or TMA
// pipelining of the K loop, split-K for the shapes that give few tiles.

#include "int8_sdp.cuh"

// C entry point, bound with ctypes.  Row-major contiguous operands:
// x (M, K) int8, w (K, N) int8, bias (N,) int32, words (N,) int32 packed
// (m << 16) | (pre << 8) | post, out (M, N) int8.  Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int int8_gemm(const void* x, const void* w, const void* bias,
                         const void* words, void* out, int M, int N, int K,
                         int relu, void* stream) {
  return int8_sdp::launch_gemm_sdp<true>(x, w, bias, words, out, M, N, K,
                                         relu, stream);
}
