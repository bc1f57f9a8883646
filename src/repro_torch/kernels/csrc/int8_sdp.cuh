// Device code shared by the port's two int8 kernels (int8_conv.cu and
// int8_gemm.cu): the NVDLA SDP epilogue and the tiled __dp4a GEMM that feeds
// it.  Each .cu file is built into a library of its own and has its own entry
// point; this header only keeps one copy of the arithmetic.
//
//   out(M,N) int8 = clip8(relu?(apply_scale(A(M,K) . B(K,N) + bias, m, pre, post)))
//
// with the channel tables (bias, packed scale words) indexed by the output
// row (kPerCol = false: the conv GEMM, channels on M) or by the output
// column (kPerCol = true: the W8A8 GEMM, channels on N).
//
// Design (simple and right first):
//   * one (BM, BN) output tile per block of 256 threads; each thread owns a
//     (BM/16) x (BN/16) micro-tile of int32 accumulators;
//   * the K loop runs inside the block in steps of BK = 64 bytes, staging an
//     A tile (rows of K) and a B tile, transposed to [n][k], in shared
//     memory, so 4 consecutive k of either operand form one 32-bit word;
//   * __dp4a (four s8*s8 products summed into s32) does the multiply-add;
//   * ragged edges in M, N and K are masked on load (zero fill, which adds
//     nothing to a sum) and on store; nothing is padded in device memory;
//   * native int32 accumulation is exact for every K the engine produces
//     (|acc| <= K * 2^14, < 2^31 for K < 131072), so unlike the f32 GEMM the
//     reference uses off the TPU there is no EXACT_K tiling of K.
//
// Arithmetic.  The reference computes in jnp int32, whose add, multiply and
// abs wrap modulo 2^32.  Signed overflow is undefined in C++, so every step
// that can wrap (acc + bias, |x|, |x| + half, t * m, sign * shifted) is done
// in uint32 and reinterpreted.  Right shifts of a negative int32 are
// arithmetic in nvcc.  Shifts by 32 or more are undefined in C++: the domain
// is pre in [0, 31] and post in [0, 31], which quant.fixed_point guarantees
// for every table it writes (pre <= 16, post <= 30).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int8_sdp {

constexpr int kThreads = 256;
constexpr int kBK = 64;                 // K bytes staged per step
constexpr int kWords = kBK / 4;         // 32-bit words per staged row
constexpr int kRowWords = kWords + 1;   // +1 word: rows start on other banks

__device__ __forceinline__ int32_t rha_shift(int32_t x, int32_t k) {
  // round-half-away-from-zero x >> k, k in [0, 31]; wraps as jnp int32 does
  uint32_t ux = static_cast<uint32_t>(x);
  uint32_t mag = x < 0 ? 0u - ux : ux;                 // |INT32_MIN| wraps
  uint32_t half = k > 0 ? (1u << (k - 1)) : 0u;
  int32_t shifted = static_cast<int32_t>(mag + half) >> k;
  int32_t sign = (x > 0) - (x < 0);
  return static_cast<int32_t>(static_cast<uint32_t>(sign) *
                              static_cast<uint32_t>(shifted));
}

__device__ __forceinline__ int8_t sdp_epilogue(int32_t acc, int32_t bias,
                                               uint32_t word, int relu) {
  int32_t m = static_cast<int32_t>(static_cast<int16_t>(word >> 16));
  int32_t pre = static_cast<int32_t>((word >> 8) & 0xFFu);
  int32_t post = static_cast<int32_t>(word & 0xFFu);
  int32_t v = static_cast<int32_t>(static_cast<uint32_t>(acc) +
                                   static_cast<uint32_t>(bias));
  int32_t t = rha_shift(v, pre);
  int32_t y = rha_shift(static_cast<int32_t>(static_cast<uint32_t>(t) *
                                             static_cast<uint32_t>(m)),
                        post);
  if (relu && y < 0) y = 0;
  y = y < -128 ? -128 : (y > 127 ? 127 : y);
  return static_cast<int8_t>(y);
}

template <int BM, int BN, bool kPerCol>
__global__ void __launch_bounds__(kThreads)
gemm_sdp_kernel(const int8_t* __restrict__ a,
                const int8_t* __restrict__ b,
                const int32_t* __restrict__ bias,
                const int32_t* __restrict__ words,
                int8_t* __restrict__ out,
                int M, int N, int K, int relu) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  __shared__ int32_t a_s[BM * kRowWords];   // A tile, [m][k]
  __shared__ int32_t b_s[BN * kRowWords];   // B tile, transposed to [n][k]
  int8_t* a_b = reinterpret_cast<int8_t*>(a_s);
  int8_t* b_b = reinterpret_cast<int8_t*>(b_s);

  const int tid = threadIdx.x;
  const int tx = tid % 16;                  // column group
  const int ty = tid / 16;                  // row group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: consecutive threads read consecutive k of one row
    for (int idx = tid; idx < BM * kBK; idx += kThreads) {
      int r = idx / kBK, kk = idx % kBK;
      int gm = m0 + r, gk = k0 + kk;
      a_b[r * kRowWords * 4 + kk] =
          (gm < M && gk < K) ? a[static_cast<size_t>(gm) * K + gk] : 0;
    }
    // B tile: consecutive threads read consecutive n of one k row
    for (int idx = tid; idx < kBK * BN; idx += kThreads) {
      int kk = idx / BN, nn = idx % BN;
      int gk = k0 + kk, gn = n0 + nn;
      b_b[nn * kRowWords * 4 + kk] =
          (gk < K && gn < N) ? b[static_cast<size_t>(gk) * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      int32_t av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_s[(ty + 16 * i) * kRowWords + kw];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b_s[(tx + 16 * j) * kRowWords + kw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      int ch = kPerCol ? gn : gm;
      out[static_cast<size_t>(gm) * N + gn] = sdp_epilogue(
          acc[i][j], bias[ch], static_cast<uint32_t>(words[ch]), relu);
    }
  }
}

// 64x64 tiles while they give at least one block per SM (132 on H100);
// 32x32 tiles for the narrow shapes, so more SMs get work.  The result does
// not depend on the choice: integer sums are exact in any order.
template <bool kPerCol>
int launch_gemm_sdp(const void* a, const void* b, const void* bias,
                    const void* words, void* out, int M, int N, int K,
                    int relu, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto ap = static_cast<const int8_t*>(a);
  auto bp = static_cast<const int8_t*>(b);
  auto biasp = static_cast<const int32_t*>(bias);
  auto wp = static_cast<const int32_t*>(words);
  auto op = static_cast<int8_t*>(out);
  long tiles64 = static_cast<long>((M + 63) / 64) * ((N + 63) / 64);
  if (tiles64 >= 132) {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    gemm_sdp_kernel<64, 64, kPerCol><<<grid, kThreads, 0, s>>>(
        ap, bp, biasp, wp, op, M, N, K, relu);
  } else {
    dim3 grid((N + 31) / 32, (M + 31) / 32);
    gemm_sdp_kernel<32, 32, kPerCol><<<grid, kThreads, 0, s>>>(
        ap, bp, biasp, wp, op, M, N, K, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace int8_sdp
