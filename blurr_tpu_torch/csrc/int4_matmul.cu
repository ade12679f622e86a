// Group-wise int4 x int8 matmul for the w4a8 tier, written for Hopper (sm_90a).
//
// Replaces the TPU kernel blurr_tpu/ops/pallas_int4_matmul.py:_kernel
// (wrapper int4_matmul). It computes the same function as that kernel and as
// the plain blurr_tpu_torch.ops.int4_matmul.int4_matmul_reference:
//
//   out[m, n] = sum over groups g, in order, of
//               float(int32 dot of x[m, rows of g] and w[rows of g, n]) * scale[g, n]
//
// x is int8 [M, K]; w is int4 packed two rows to a byte (row 2k in the low
// nibble, row 2k+1 in the high one) and stored block-major [NB, K/2, BN];
// scale is fp32 [G, NB*BN]; out is fp32 [M, NB*BN]. The low nibble is
// sign-extended as ((b & 0xF) ^ 8) - 8 and the high nibble is the arithmetic
// shift of the signed byte, b >> 4. Each group's dot is exact in int32; the
// fp32 multiply and add of each group term are __fmul_rn / __fadd_rn, so nvcc
// does not contract them into an FMA and the result equals the plain version
// bit for bit.
//
// Shape of the design. A block of 64 threads owns a tile of TM rows of x
// (TM = 1, 2, 4, 8 or 16, the least power of two that covers M, at most 16)
// and 256 output columns; each thread owns 4 adjacent columns, whose packed
// bytes are one aligned 32-bit word per byte row, read coalesced along BN.
// The grid is (row tiles, column tiles) with the row tiles fastest, so blocks
// that share weight columns run together and the weights come from device
// memory once. The x tile is staged in shared memory in chunks of 512 K
// values, zero-filled past K and past M. For each 16 rows of K a thread loads
// 8 words (16 rows x 4 columns), unpacks them into 4-byte groups of 4 K rows,
// and accumulates int32 with __dp4a against 16 bytes of each x row read once
// from shared memory (a broadcast: every lane reads the same address). Rows
// past M are computed on zeros and not stored; columns come in whole words
// (BN is a multiple of 4), so a thread's 4 columns lie in one block.
//
// What bounds it on the H100: at the Pi-0 w4a8 shapes the weights are up to
// 2048 x 16384 int4 (17 MB at the vlm gate) and M is 96 (prefill) or 1-4
// (action mixture). The weight bytes alone would take 1-5 us at 3.35 TB/s.
// At M = 1 and 4 the kernel is bound by latency instead: few blocks (one at
// N = 256), and each thread walks all of K with 8 loads in flight, so a
// launch takes 35-80 us on an H100 at 700 W. At M = 96 it is bound by the
// integer pipe, since it runs __dp4a on the CUDA cores and no tensor cores
// (0.17 ms at the vlm gate, 1.09 ms at the vlm down projection, K = 16384).
// Int8 mma / wgmma with the nibbles unpacked in registers, TMA, and split-K
// across blocks for the M = 1 and 4 rows and the narrow N are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kColsPerThread = 4;                       // one 32-bit word
constexpr int kBlockCols = kThreads * kColsPerThread;  // 256
constexpr int kChunk = 512;                             // K values of x staged at once

// 4 K rows (4q .. 4q+3) of column t as a dp4a operand: byte r holds row 4q+r.
// w0 packs rows (4q, 4q+1) of 4 columns, one byte per column; w1 rows
// (4q+2, 4q+3).
__device__ __forceinline__ int unpack4(uint32_t w0, uint32_t w1, int t) {
  const int b0 = (int)(int8_t)((w0 >> (8 * t)) & 0xFFu);
  const int b1 = (int)(int8_t)((w1 >> (8 * t)) & 0xFFu);
  const int r0 = ((b0 & 0xF) ^ 8) - 8;
  const int r1 = b0 >> 4;
  const int r2 = ((b1 & 0xF) ^ 8) - 8;
  const int r3 = b1 >> 4;
  return (r0 & 0xFF) | ((r1 & 0xFF) << 8) | ((r2 & 0xFF) << 16) | ((r3 & 0xFF) << 24);
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                   int N, int BN, int groups) {
  __shared__ __align__(16) int8_t x_s[TM * kChunk];

  const int row0 = blockIdx.x * TM;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * kColsPerThread;
  const bool active = col < N;
  const int K2 = K / 2;
  const uint8_t* w_col = packed;
  if (active) {
    const int j = col / BN;
    w_col = packed + (int64_t)j * K2 * BN + (col - j * BN);
  }
  const int rows_per_group = K / groups;

  float acc[TM][kColsPerThread];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int t = 0; t < kColsPerThread; ++t) acc[r][t] = 0.f;

  for (int g = 0; g < groups; ++g) {
    int dot[TM][kColsPerThread];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int t = 0; t < kColsPerThread; ++t) dot[r][t] = 0;

    const int g_end = (g + 1) * rows_per_group;
    for (int c0 = g * rows_per_group; c0 < g_end; c0 += kChunk) {
      const int len = min(kChunk, g_end - c0);  // even: groups hold whole bytes
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

      const int kk_end = (c0 + len) / 2;  // past the chunk's last byte row
      for (int c = 0; c < len; c += 16) {
        const int kk0 = (c0 + c) / 2;
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[i] = kk0 + i < kk_end
                     ? __ldg(reinterpret_cast<const uint32_t*>(w_col + (int64_t)(kk0 + i) * BN))
                     : 0u;
        int wq[kColsPerThread][4];
#pragma unroll
        for (int t = 0; t < kColsPerThread; ++t)
#pragma unroll
          for (int q = 0; q < 4; ++q) wq[t][q] = unpack4(w[2 * q], w[2 * q + 1], t);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const int4 xv = *reinterpret_cast<const int4*>(x_s + r * kChunk + c);
          const int xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int t = 0; t < kColsPerThread; ++t)
#pragma unroll
            for (int q = 0; q < 4; ++q) dot[r][t] = __dp4a(xq[q], wq[t][q], dot[r][t]);
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int t = 0; t < kColsPerThread; ++t) {
      const float s = scale[(int64_t)g * N + col + t];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float term = __fmul_rn(__int2float_rn(dot[r][t]), s);
        acc[r][t] = g == 0 ? term : __fadd_rn(acc[r][t], term);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    if (row0 + r >= M) break;
    float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(out + (int64_t)(row0 + r) * N + col) = v;
  }
}

template <int TM>
cudaError_t launch(const void* x, const void* packed, const void* scale, void* out, int M,
                   int K, int N, int BN, int groups, cudaStream_t stream) {
  dim3 grid((M + TM - 1) / TM, (N + kBlockCols - 1) / kBlockCols);
  int4_matmul_kernel<TM><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N, BN, groups);
  return cudaGetLastError();
}

}  // namespace

// x int8 [M, K], packed int8 [N/BN, K/2, BN], scale fp32 [groups, N], out fp32
// [M, N], all contiguous; K/groups even, BN and N multiples of 4, packed
// 4-byte aligned (word loads) and out 16-byte aligned (float4 stores).
// Returns the launch's cudaError_t.
extern "C" int blurr_int4_matmul(const void* x, const void* packed, const void* scale,
                                 void* out, int M, int K, int N, int BN, int groups,
                                 void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || BN <= 0 || groups <= 0 || K % 2 || K % groups ||
      (K / groups) % 2 || BN % 4 || N % BN)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)packed % 4 || (uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) return (int)launch<1>(x, packed, scale, out, M, K, N, BN, groups, s);
  if (M <= 2) return (int)launch<2>(x, packed, scale, out, M, K, N, BN, groups, s);
  if (M <= 4) return (int)launch<4>(x, packed, scale, out, M, K, N, BN, groups, s);
  if (M <= 8) return (int)launch<8>(x, packed, scale, out, M, K, N, BN, groups, s);
  return (int)launch<16>(x, packed, scale, out, M, K, N, BN, groups, s);
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
