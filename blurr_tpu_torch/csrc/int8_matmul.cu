// Int8 weight-only dequant-matmul for the int8 tier, written for Hopper (sm_90a).
//
// Replaces the TPU kernel blurr_tpu/ops/pallas_int8_matmul.py:_kernel
// (wrappers int8_matmul and int8_mm_nd). It computes the same function as
// that kernel and as the plain blurr_tpu_torch.ops.int8_matmul.int8_matmul_reference:
//
//   out[m, n] = T( (sum over k of bf16(x[m, k]) * q[k, n]) * s[n] )
//
// x is T [M, K] (T = float or bf16); q is int8 [K, N], row-major (the JAX
// layout); s is fp32 [N]; out is T [M, N]. Each product of a bf16 value and
// an int8 value has at most 16 significant bits, so it is exact in fp32 and
// an FMA into the fp32 sum rounds only the sum: the kernel and the plain
// version (which sums in float64) differ only by this kernel's fp32
// summation error. The scale is applied once, after the sum (__fmul_rn),
// then the cast, in the order of the TPU kernel.
//
// Shape of the design. A block of 256 threads (8 warps) owns TM rows of x
// (TM = 1, 2, 4, 8 or 16, the least power of two that covers M, at most 16)
// and 128 output columns; each lane owns 4 adjacent columns. The 8 warps
// split K: warp w takes the rows k = w, w + 8, ... of each chunk, so each
// warp reads whole 128-byte rows of q, coalesced along N, as one 32-bit word
// per lane (bytes one by one where N is not a multiple of 4 or q is not
// 4-byte aligned). The x tile is staged in shared memory in chunks of 256 K
// values, rounded to bf16 (__float2bfloat16_rn) and held as fp32, zero past
// M; every lane reads the same x value (a broadcast). At the end the 8
// per-warp partial sums of each row are added in warp order in shared
// memory, scaled and stored. The grid is (row tiles, column tiles), row
// tiles fastest, so blocks that share weight columns run together. There
// is no padding anywhere: any M >= 1, K >= 1 (7 at the action encoder's w1)
// and N >= 1, with bounds checks.
//
// What bounds it on the H100: at the Pi-0 int8 shapes q is at most
// 4096 x 1024 or 1024 x 4096 int8 (4 MB, ~1.3 us at 3.35 TB/s) and M is 1
// or 4. The kernel is bound by latency instead: N / 128 blocks (2 at
// N = 256, 32 at N = 4096) on 132 SMs, each warp walking K / 8 rows with
// one load per row. Tensor cores (mma / wgmma on bf16 x and dequantized
// bf16 q), TMA, and split-K across blocks for M = 1 and 4 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerLane = 4;
constexpr int kBlockCols = 32 * kColsPerLane;  // 128
constexpr int kChunk = 256;                    // K values of x staged at once

__device__ __forceinline__ float load_bf16_rounded(const float* p) {
  return __bfloat162float(__float2bfloat16_rn(*p));
}
__device__ __forceinline__ float load_bf16_rounded(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int TM, bool kWord, typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, T* __restrict__ out, int M, int K, int N) {
  __shared__ float x_s[TM * kChunk];
  __shared__ float part[kWarps * kBlockCols];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * kBlockCols;
  const int col = col0 + lane * kColsPerLane;

  float acc[TM][kColsPerLane];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) acc[r][t] = 0.f;

  for (int c0 = 0; c0 < K; c0 += kChunk) {
    const int len = min(kChunk, K - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < TM * len; e += kThreads) {
      const int r = e / len;
      const int c = e - r * len;
      x_s[r * kChunk + c] =
          row0 + r < M ? load_bf16_rounded(x + (int64_t)(row0 + r) * K + c0 + c) : 0.f;
    }
    __syncthreads();
    if (col >= N) continue;

#pragma unroll 4
    for (int c = warp; c < len; c += kWarps) {
      const int8_t* q_row = q + (int64_t)(c0 + c) * N + col;
      float w[kColsPerLane];
      if (kWord) {
        const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(q_row));
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t)
          w[t] = __int2float_rn((int)(int8_t)((word >> (8 * t)) & 0xFFu));
      } else {
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t)
          w[t] = col + t < N ? __int2float_rn((int)__ldg(q_row + t)) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float xv = x_s[r * kChunk + c];
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t) acc[r][t] = __fmaf_rn(xv, w[t], acc[r][t]);
      }
    }
  }

  // the 8 warps' partial sums of each row, added in warp order
  const int c_out = col0 + threadIdx.x;  // threads 0..127 each finish one column
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    __syncthreads();  // part is free (and, at r = 0, every warp is done)
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t)
      part[warp * kBlockCols + lane * kColsPerLane + t] = acc[r][t];
    __syncthreads();
    if (threadIdx.x < kBlockCols && c_out < N && row0 + r < M) {
      float sum = part[threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, part[w * kBlockCols + threadIdx.x]);
      store(out + (int64_t)(row0 + r) * N + c_out, __fmul_rn(sum, s[c_out]));
    }
  }
}

template <int TM, typename T>
cudaError_t launch(const void* x, const void* q, const void* s, void* out, int M, int K, int N,
                   cudaStream_t stream) {
  dim3 grid((M + TM - 1) / TM, (N + kBlockCols - 1) / kBlockCols);
  const bool word = N % 4 == 0 && (uintptr_t)q % 4 == 0;
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(s);
  T* ot = static_cast<T*>(out);
  if (word)
    int8_matmul_kernel<TM, true, T><<<grid, kThreads, 0, stream>>>(xt, qt, st, ot, M, K, N);
  else
    int8_matmul_kernel<TM, false, T><<<grid, kThreads, 0, stream>>>(xt, qt, st, ot, M, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* q, const void* s, void* out, int M, int K, int N,
                     cudaStream_t stream) {
  if (M <= 1) return launch<1, T>(x, q, s, out, M, K, N, stream);
  if (M <= 2) return launch<2, T>(x, q, s, out, M, K, N, stream);
  if (M <= 4) return launch<4, T>(x, q, s, out, M, K, N, stream);
  if (M <= 8) return launch<8, T>(x, q, s, out, M, K, N, stream);
  return launch<16, T>(x, q, s, out, M, K, N, stream);
}

}  // namespace

// x [M, K] (fp32 when x_bf16 is 0, bf16 otherwise), q int8 [K, N], s fp32
// [N], out [M, N] of x's type, all contiguous. Returns the launch's
// cudaError_t.
extern "C" int blurr_int8_matmul(const void* x, const void* q, const void* s, void* out, int M,
                                 int K, int N, int x_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return (int)dispatch<__nv_bfloat16>(x, q, s, out, M, K, N, st);
  return (int)dispatch<float>(x, q, s, out, M, K, N, st);
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
