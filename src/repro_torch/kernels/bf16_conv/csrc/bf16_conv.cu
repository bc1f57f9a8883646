// Fused BF16 conv-as-GEMM with the nv_full SDP epilogue, for sm_90a.
//
//   out(M,N) bf16 = bf16_rne(relu?(W(M,K) . cols(K,N) + bias[M]))
//
// bf16 operands, float32 accumulation, float32 bias.  Replaces the Pallas TPU
// kernel repro/kernels/bf16_conv/kernel.py (bf16_conv_gemm, body
// _bf16_conv_kernel).  Output channels sit on the M axis, so the epilogue is
// per row: f32 bias add, optional ReLU, one rounding to bfloat16 (round to
// nearest even, __float2bfloat16_rn).  The f32 accumulator lives in
// registers and never goes to device memory.
//
// Design (simple and right first):
//   * one 32 x 32 output tile per block of 128 threads (4 warps, 2 x 2, each
//     warp a 16 x 16 sub-tile);
//   * the K loop runs inside the block in steps of 64, staging a W tile
//     ([m][k]) and a cols tile transposed to [n][k] in shared memory, so two
//     consecutive k of either operand form one 32-bit word, as the tensor
//     core fragments want them;
//   * the products run on the tensor cores: mma.sync m16n8k16 with bf16
//     inputs and f32 accumulators (bf16 x bf16 products are exact in f32);
//   * ragged M, N and K are masked on load with zero fill (a zero product
//     adds nothing) and on store; nothing is padded in device memory.
//
// One K order per output element.  Every output accumulates its K in the
// same steps (16 at a time, in order, through the same mma instruction)
// whatever N is and wherever its column sits in its tile: there is no
// split-K and the tile shape is fixed, never chosen from N.  So a lane folded
// into a bucket (column = lane * P*Q + position) gets the very bits of its
// own single-image launch, the contract of the reference
// (repro/kernels/bf16_conv/ops.py, lane folding keeps each column's
// accumulation order).  Against other implementations (the plain version,
// the VP) the result agrees within tolerances.gemm_tolerance(K): only the
// f32 summation order differs.
//
// Bound on the card at ResNet-18 (3x32x32, nv_full) shapes: at batch 1 the
// 21 CONV/FC GEMMs must stream 22.4 MB of bf16 weights, 6.7 us at 3.35 TB/s,
// while their 37 M MACs take 0.08 us at the dense bf16 rate of 989 TFLOP/s:
// the weights bound the work.  This design reads each W tile once per
// 32-column strip of N, so at batch 1 (N <= 256) that is once or a few times.
// The narrow layers (N = 1..16) give only M/32 blocks, which leaves most of
// the 132 SMs idle, each walking K with a barrier per step.
//
// Left for later: wgmma with TMA loads into a multi-stage shared-memory ring,
// cp.async pipelining, implicit im2col (reading the activation surface
// directly instead of a materialised cols matrix), and split-K for narrow N
// (it would need a fixed reduction order to keep the lane contract).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 32;
constexpr int kBN = 32;
constexpr int kBK = 64;
constexpr int kLd = kBK + 8;   // smem row: 72 bf16 = 36 words, conflict-free
                               // fragment reads (g * 36 + t covers 32 banks)

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
bf16_conv_gemm_kernel(const uint16_t* __restrict__ w,
                      const uint16_t* __restrict__ cols,
                      const float* __restrict__ bias,
                      uint16_t* __restrict__ out,
                      int M, int N, int K, int relu) {
  __shared__ __align__(16) uint16_t a_s[kBM * kLd];   // W tile, [m][k]
  __shared__ __align__(16) uint16_t b_s[kBN * kLd];   // cols tile, [n][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // fragment row group
  const int t = lane & 3;                  // thread in the group
  const int wm = (warp >> 1) * 16;         // warp's rows in the tile
  const int wn = (warp & 1) * 16;          // warp's columns (two n8 tiles)
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // W tile: consecutive threads read consecutive k of one row
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      int r = idx / kBK, kk = idx % kBK;
      int gm = m0 + r, gk = k0 + kk;
      a_s[r * kLd + kk] =
          (gm < M && gk < K) ? w[static_cast<size_t>(gm) * K + gk] : 0;
    }
    // cols tile: consecutive threads read consecutive n of one k row
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      int kk = idx / kBN, nn = idx % kBN;
      int gk = k0 + kk, gn = n0 + nn;
      b_s[nn * kLd + kk] =
          (gk < K && gn < N) ? cols[static_cast<size_t>(gk) * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // A fragment (16 x 16, row major): rows g and g + 8, k pairs 2t and
      // 2t + 8 (PTX ISA, mma.m16n8k16 .bf16 fragment layout)
      const uint16_t* ap = a_s + (wm + g) * kLd + ks + 2 * t;
      uint32_t a[4] = {ld_pair(ap), ld_pair(ap + 8 * kLd), ld_pair(ap + 8),
                       ld_pair(ap + 8 * kLd + 8)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // B fragment (16 x 8, column major): column g, k pairs 2t and 2t + 8
        const uint16_t* bp = b_s + (wn + 8 * j + g) * kLd + ks + 2 * t;
        uint32_t b[2] = {ld_pair(bp), ld_pair(bp + 8)};
        mma_bf16_16816(acc[j], a, b);
      }
    }
    __syncthreads();
  }

  // C fragment: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int gm = m0 + wm + g + 8 * h;
      if (gm >= M) continue;
      float bv = bias[gm];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int gn = n0 + wn + 8 * j + 2 * t + e;
        if (gn >= N) continue;
        float v = acc[j][2 * h + e] + bv;
        if (relu && v < 0.f) v = 0.f;
        out[static_cast<size_t>(gm) * N + gn] =
            __bfloat16_as_ushort(__float2bfloat16_rn(v));
      }
    }
  }
}

}  // namespace

// C entry point, bound with ctypes.  Row-major contiguous operands:
// w (M, K) bf16, cols (K, N) bf16, bias (M,) f32, out (M, N) bf16.  Launches
// on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int bf16_conv_gemm(const void* w, const void* cols,
                              const void* bias, void* out, int M, int N,
                              int K, int relu, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  bf16_conv_gemm_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(w), static_cast<const uint16_t*>(cols),
      static_cast<const float*>(bias), static_cast<uint16_t*>(out), M, N, K,
      relu);
  return static_cast<int>(cudaGetLastError());
}
