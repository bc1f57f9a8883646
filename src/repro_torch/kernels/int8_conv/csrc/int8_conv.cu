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
// Design (simple and right first):
//   * one (BM, BN) output tile per block of 256 threads; each thread owns a
//     (BM/16) x (BN/16) micro-tile of int32 accumulators;
//   * the K loop runs inside the block in steps of BK = 64 bytes, staging a
//     W tile (rows of K) and a cols tile, transposed to [n][k], in shared
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
// arithmetic in nvcc.  Shifts by 32 or more are undefined in C++: the kernel's
// domain is pre in [0, 31] and post in [0, 31], which quant.fixed_point
// guarantees for every table it writes (pre <= 16, post <= 30).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
int8_conv_gemm_kernel(const int8_t* __restrict__ w,
                      const int8_t* __restrict__ cols,
                      const int32_t* __restrict__ bias,
                      const int32_t* __restrict__ words,
                      int8_t* __restrict__ out,
                      int M, int N, int K, int relu) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  __shared__ int32_t a_s[BM * kRowWords];   // W tile, [m][k]
  __shared__ int32_t b_s[BN * kRowWords];   // cols tile, transposed to [n][k]
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
    // W tile: consecutive threads read consecutive k of one row
    for (int idx = tid; idx < BM * kBK; idx += kThreads) {
      int r = idx / kBK, kk = idx % kBK;
      int gm = m0 + r, gk = k0 + kk;
      a_b[r * kRowWords * 4 + kk] =
          (gm < M && gk < K) ? w[static_cast<size_t>(gm) * K + gk] : 0;
    }
    // cols tile: consecutive threads read consecutive n of one k row
    for (int idx = tid; idx < kBK * BN; idx += kThreads) {
      int kk = idx / BN, nn = idx % BN;
      int gk = k0 + kk, gn = n0 + nn;
      b_b[nn * kRowWords * 4 + kk] =
          (gk < K && gn < N) ? cols[static_cast<size_t>(gk) * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      int32_t a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = a_s[(ty + 16 * i) * kRowWords + kw];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = b_s[(tx + 16 * j) * kRowWords + kw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    int32_t bv = bias[gm];
    uint32_t wv = static_cast<uint32_t>(words[gm]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int gn = n0 + tx + 16 * j;
      if (gn < N)
        out[static_cast<size_t>(gm) * N + gn] =
            sdp_epilogue(acc[i][j], bv, wv, relu);
    }
  }
}

template <int BM, int BN>
void launch(const int8_t* w, const int8_t* cols, const int32_t* bias,
            const int32_t* words, int8_t* out, int M, int N, int K, int relu,
            cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_conv_gemm_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(
      w, cols, bias, words, out, M, N, K, relu);
}

}  // namespace

// C entry point, bound with ctypes.  Row-major contiguous operands:
// w (M, K) int8, cols (K, N) int8, bias (M,) int32, words (M,) int32 packed
// (m << 16) | (pre << 8) | post, out (M, N) int8.  Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int int8_conv_gemm(const void* w, const void* cols,
                              const void* bias, const void* words, void* out,
                              int M, int N, int K, int relu, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto wp = static_cast<const int8_t*>(w);
  auto cp = static_cast<const int8_t*>(cols);
  auto bp = static_cast<const int32_t*>(bias);
  auto sp = static_cast<const int32_t*>(words);
  auto op = static_cast<int8_t*>(out);
  // 64x64 tiles while they give at least one block per SM (132 on H100);
  // 32x32 tiles for the narrow layers, so more SMs get work
  long tiles64 = static_cast<long>((M + 63) / 64) * ((N + 63) / 64);
  if (tiles64 >= 132)
    launch<64, 64>(wp, cp, bp, sp, op, M, N, K, relu, s);
  else
    launch<32, 32>(wp, cp, bp, sp, op, M, N, K, relu, s);
  return static_cast<int>(cudaGetLastError());
}
