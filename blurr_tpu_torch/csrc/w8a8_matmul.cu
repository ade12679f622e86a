// int8 x int8 matmul with one fp32 scale per column (the w8a8 product),
// written for Hopper (sm_90a).
//
// Replaces the TPU kernels of the w8a8 experiments:
// experiments/bench_pallas_int4.py:_int8_kernel (wrapper pallas_int8),
// experiments/bench_pallas_int4_tune.py:_int8_kernel (make_int8) and
// experiments/bench_pallas_int8_blockmajor.py:_kernel (pallas_int8_bm, the
// block-major weight). It computes their function, and that of the plain
// blurr_tpu_torch.ops.w8a8_matmul.w8a8_matmul_reference:
//
//   out[m, n] = float(int32 dot of x[m, :] and w[:, n]) * scale[n]
//
// x is int8 [M, K]; w is int8, row-major [K, N] or block-major [N/BN, K, BN]
// (row-major is block-major with BN = N, so the layout is the one argument
// BN); scale is fp32 [N]; out is fp32 [M, N]. The dot is exact in int32, its
// conversion is __int2float_rn (round to nearest even, as the plain
// version's float64 -> float32 cast) and the multiply __fmul_rn, so the
// result equals the plain version bit for bit.
//
// Shape of the design. A block of 64 threads owns a tile of TM rows of x
// (TM = 1, 2, 4, 8 or 16, the least power of two that covers M, at most 16)
// and 256 output columns; each thread owns 4 adjacent columns, whose bytes
// are one aligned 32-bit word per K row, read coalesced along BN. The grid is
// (row tiles, column tiles) with the row tiles fastest, so blocks that share
// weight columns run together and the weights come from device memory once.
// The x tile is staged in shared memory in chunks of 512 K values, zero-filled
// past K and past M. For each 16 rows of K a thread loads 16 words, transposes
// them with __byte_perm into one 4-row dp4a operand per column and quad, and
// accumulates int32 with __dp4a against 16 bytes of each x row read once from
// shared memory (a broadcast).
//
// What bounds it on the H100: each input read once and the output written
// once, (8, 4096, 11264) moves 46 MB, 14 us at 3.35 TB/s, and (276, 2048,
// 16384) 52 MB, 16 us; its 18.5 G int8 operations would take 9 us on the
// tensor cores (1,979 TOP/s). This kernel runs __dp4a on the CUDA cores,
// whose int8 rate is a small share of that, so at M 96 and 276 it is bound by
// the integer pipe; at M 5 and 8 by latency and the weight stream. Int8
// wgmma with TMA-fed tiles is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kColsPerThread = 4;                       // one 32-bit word
constexpr int kBlockCols = kThreads * kColsPerThread;  // 256
constexpr int kChunk = 512;                             // K values of x staged at once

// Transposes the 4x4 bytes of words w0..w3 (word i = row i, byte t = column
// t) into c[t] = column t, byte i = row i: the dp4a operand of column t.
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                           int c[4]) {
  const uint32_t a = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t b = __byte_perm(w2, w3, 0x5140);  // w2.b0 w3.b0 w2.b1 w3.b1
  const uint32_t d = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t e = __byte_perm(w2, w3, 0x7362);  // w2.b2 w3.b2 w2.b3 w3.b3
  c[0] = (int)__byte_perm(a, b, 0x5410);
  c[1] = (int)__byte_perm(a, b, 0x7632);
  c[2] = (int)__byte_perm(d, e, 0x5410);
  c[3] = (int)__byte_perm(d, e, 0x7632);
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
w8a8_matmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                   int N, int BN) {
  __shared__ __align__(16) int8_t x_s[TM * kChunk];

  const int row0 = blockIdx.x * TM;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * kColsPerThread;
  const bool active = col < N;
  const uint8_t* w_col = w;
  if (active) {
    const int j = col / BN;
    w_col = w + (int64_t)j * K * BN + (col - j * BN);
  }

  int dot[TM][kColsPerThread];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int t = 0; t < kColsPerThread; ++t) dot[r][t] = 0;

  for (int c0 = 0; c0 < K; c0 += kChunk) {
    const int len = min(kChunk, K - c0);
    const int len16 = (len + 15) & ~15;
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < TM * len16; e += kThreads) {
      const int r = e / len16;
      const int c = e - r * len16;
      int8_t v = 0;
      if (row0 + r < M && c < len) v = x[(int64_t)(row0 + r) * K + c0 + c];
      x_s[r * kChunk + c] = v;
    }
    __syncthreads();
    if (!active) continue;

    for (int c = 0; c < len; c += 16) {
      uint32_t wv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        wv[i] = c0 + c + i < K
                    ? __ldg(reinterpret_cast<const uint32_t*>(w_col + (int64_t)(c0 + c + i) * BN))
                    : 0u;
      int wq[4][kColsPerThread];  // [quad of K rows][column]
#pragma unroll
      for (int q = 0; q < 4; ++q)
        transpose4(wv[4 * q], wv[4 * q + 1], wv[4 * q + 2], wv[4 * q + 3], wq[q]);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int4 xv = *reinterpret_cast<const int4*>(x_s + r * kChunk + c);
        const int xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int t = 0; t < kColsPerThread; ++t)
#pragma unroll
          for (int q = 0; q < 4; ++q) dot[r][t] = __dp4a(xq[q], wq[q][t], dot[r][t]);
      }
    }
  }

  if (!active) return;
  float s[kColsPerThread];
#pragma unroll
  for (int t = 0; t < kColsPerThread; ++t) s[t] = scale[col + t];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    if (row0 + r >= M) break;
    float4 v = make_float4(__fmul_rn(__int2float_rn(dot[r][0]), s[0]),
                           __fmul_rn(__int2float_rn(dot[r][1]), s[1]),
                           __fmul_rn(__int2float_rn(dot[r][2]), s[2]),
                           __fmul_rn(__int2float_rn(dot[r][3]), s[3]));
    *reinterpret_cast<float4*>(out + (int64_t)(row0 + r) * N + col) = v;
  }
}

template <int TM>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int M, int K,
                   int N, int BN, cudaStream_t stream) {
  dim3 grid((M + TM - 1) / TM, (N + kBlockCols - 1) / kBlockCols);
  w8a8_matmul_kernel<TM><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N, BN);
  return cudaGetLastError();
}

}  // namespace

// x int8 [M, K], w int8 [N/BN, K, BN] (BN = N: row-major [K, N]), scale fp32
// [N], out fp32 [M, N], all contiguous; BN and N multiples of 4, w 4-byte
// aligned (word loads) and out 16-byte aligned (float4 stores). Returns the
// launch's cudaError_t.
extern "C" int blurr_w8a8_matmul(const void* x, const void* w, const void* scale, void* out,
                                 int M, int K, int N, int BN, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || BN <= 0 || BN % 4 || N % BN)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)w % 4 || (uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) return (int)launch<1>(x, w, scale, out, M, K, N, BN, s);
  if (M <= 2) return (int)launch<2>(x, w, scale, out, M, K, N, BN, s);
  if (M <= 4) return (int)launch<4>(x, w, scale, out, M, K, N, BN, s);
  if (M <= 8) return (int)launch<8>(x, w, scale, out, M, K, N, BN, s);
  return (int)launch<16>(x, w, scale, out, M, K, N, BN, s);
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
