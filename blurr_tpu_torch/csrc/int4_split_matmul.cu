// int4 x int8 matmul over the "split-half" packing, one fp32 scale per
// column, written for Hopper (sm_90a).
//
// Replaces the TPU kernels of the split-half w4a8 experiments:
// experiments/bench_pallas_int4.py:_w4_kernel (wrapper pallas_w4),
// experiments/bench_pallas_int4_tune.py:_w4_kernel (make_w4),
// experiments/bench_pallas_int4_tune2.py:_w4_shift2 (run_shift2) and
// _w4_biased (run_biased). It computes their function, and that of the plain
// blurr_tpu_torch.ops.int4_split_matmul.int4_split_matmul_reference:
//
//   out[m, n] = float(int32 dot of x[m, :] and q[:, n]) * scale[n]
//
// x is int8 [M, K]; q is int4 [K, N], packed row-major [K/2, N]: byte [k, n]
// holds q[k, n] in its low nibble and q[k + K/2, n] in its high one. In the
// signed packing a nibble is q in two's complement; in the biased packing it
// is q + 8 (the harness subtracts 8 * rowsum(x) after its dots, which is the
// same integer). scale is fp32 [N]; out is fp32 [M, N]. The dot is exact in
// int32; __int2float_rn and __fmul_rn round as the plain version does, so the
// two agree bit for bit.
//
// Shape of the design: that of csrc/int4_matmul.cu (K2), with its
// adjacent-row nibble order swapped for the split halves. A block of 64
// threads owns TM rows of x (TM = 1 .. 16) and 256 columns; each thread owns
// 4 adjacent columns, one aligned 32-bit word per byte row, read coalesced.
// Both halves of the x tile (columns k and k + K/2 of each byte row k) are
// staged in shared memory in chunks of 256 byte rows, zero-filled past K/2
// and past M. For each 16 byte rows a thread loads 16 words, transposes them
// with __byte_perm into 4-row groups of each column, and unpacks both
// nibbles of 4 bytes at once: (b & 0x0F0F0F0F) and ((b >> 4) & 0x0F0F0F0F),
// then a bytewise (n ^ 8) - 8 (signed) or n - 8 (biased) with __vsub4. The
// two int8 operands go to __dp4a against 16 bytes of each x half.
//
// What bounds it on the H100: at (8, 4096, 11264) the inputs and output move
// 23 MB, 7 us at 3.35 TB/s; its 0.74 G int8 operations are far below the
// tensor cores' rate. At M 8 and 32 the kernel is bound by latency and the
// weight stream (one block column per 256 output columns, 44 of them, two
// per SM at most); split-K and int8 mma are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kColsPerThread = 4;                       // one 32-bit word
constexpr int kBlockCols = kThreads * kColsPerThread;  // 256
constexpr int kChunk = 256;                             // byte rows of x staged at once

__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                           uint32_t c[4]) {
  const uint32_t a = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t b = __byte_perm(w2, w3, 0x5140);
  const uint32_t d = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t e = __byte_perm(w2, w3, 0x7362);
  c[0] = __byte_perm(a, b, 0x5410);
  c[1] = __byte_perm(a, b, 0x7632);
  c[2] = __byte_perm(d, e, 0x5410);
  c[3] = __byte_perm(d, e, 0x7632);
}

// The 4 nibbles n (one in each byte, 0..15) as 4 signed int8 values.
template <bool kBiased>
__device__ __forceinline__ int nibbles_to_int8(uint32_t n) {
  return (int)__vsub4(kBiased ? n : (n ^ 0x08080808u), 0x08080808u);
}

template <int TM, bool kBiased>
__global__ void __launch_bounds__(kThreads)
int4_split_matmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ packed,
                         const float* __restrict__ scale, float* __restrict__ out, int M,
                         int K, int N) {
  __shared__ __align__(16) int8_t x_lo[TM * kChunk];
  __shared__ __align__(16) int8_t x_hi[TM * kChunk];

  const int K2 = K / 2;
  const int row0 = blockIdx.x * TM;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * kColsPerThread;
  const bool active = col < N;
  const uint8_t* w_col = packed + (active ? col : 0);

  int dot[TM][kColsPerThread];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int t = 0; t < kColsPerThread; ++t) dot[r][t] = 0;

  for (int c0 = 0; c0 < K2; c0 += kChunk) {
    const int len = min(kChunk, K2 - c0);
    const int len16 = (len + 15) & ~15;
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < TM * len16; e += kThreads) {
      const int r = e / len16;
      const int c = e - r * len16;
      int8_t lo = 0, hi = 0;
      if (row0 + r < M && c < len) {
        const int8_t* xr = x + (int64_t)(row0 + r) * K + c0 + c;
        lo = xr[0];
        hi = xr[K2];
      }
      x_lo[r * kChunk + c] = lo;
      x_hi[r * kChunk + c] = hi;
    }
    __syncthreads();
    if (!active) continue;

    for (int c = 0; c < len; c += 16) {
      uint32_t wv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        wv[i] = c0 + c + i < K2
                    ? __ldg(reinterpret_cast<const uint32_t*>(w_col + (int64_t)(c0 + c + i) * N))
                    : 0u;  // past K/2: x is 0 there, so any weight adds 0
      int lo[4][kColsPerThread], hi[4][kColsPerThread];  // [quad of byte rows][column]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t b[kColsPerThread];
        transpose4(wv[4 * q], wv[4 * q + 1], wv[4 * q + 2], wv[4 * q + 3], b);
#pragma unroll
        for (int t = 0; t < kColsPerThread; ++t) {
          lo[q][t] = nibbles_to_int8<kBiased>(b[t] & 0x0F0F0F0Fu);
          hi[q][t] = nibbles_to_int8<kBiased>((b[t] >> 4) & 0x0F0F0F0Fu);
        }
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int4 xl = *reinterpret_cast<const int4*>(x_lo + r * kChunk + c);
        const int4 xh = *reinterpret_cast<const int4*>(x_hi + r * kChunk + c);
        const int xlq[4] = {xl.x, xl.y, xl.z, xl.w};
        const int xhq[4] = {xh.x, xh.y, xh.z, xh.w};
#pragma unroll
        for (int t = 0; t < kColsPerThread; ++t)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dot[r][t] = __dp4a(xlq[q], lo[q][t], dot[r][t]);
            dot[r][t] = __dp4a(xhq[q], hi[q][t], dot[r][t]);
          }
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

template <int TM, bool kBiased>
cudaError_t launch(const void* x, const void* packed, const void* scale, void* out, int M,
                   int K, int N, cudaStream_t stream) {
  dim3 grid((M + TM - 1) / TM, (N + kBlockCols - 1) / kBlockCols);
  int4_split_matmul_kernel<TM, kBiased><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  return cudaGetLastError();
}

template <bool kBiased>
cudaError_t dispatch(const void* x, const void* packed, const void* scale, void* out, int M,
                     int K, int N, cudaStream_t s) {
  if (M <= 1) return launch<1, kBiased>(x, packed, scale, out, M, K, N, s);
  if (M <= 2) return launch<2, kBiased>(x, packed, scale, out, M, K, N, s);
  if (M <= 4) return launch<4, kBiased>(x, packed, scale, out, M, K, N, s);
  if (M <= 8) return launch<8, kBiased>(x, packed, scale, out, M, K, N, s);
  return launch<16, kBiased>(x, packed, scale, out, M, K, N, s);
}

}  // namespace

// x int8 [M, K], packed int8 [K/2, N] (split-half; biased != 0: nibbles hold
// q + 8), scale fp32 [N], out fp32 [M, N], all contiguous; K even, N a
// multiple of 4, packed 4-byte aligned (word loads) and out 16-byte aligned
// (float4 stores). Returns the launch's cudaError_t.
extern "C" int blurr_int4_split_matmul(const void* x, const void* packed, const void* scale,
                                       void* out, int M, int K, int N, int biased,
                                       void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 2 || N % 4) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)packed % 4 || (uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(biased ? dispatch<true>(x, packed, scale, out, M, K, N, s)
                      : dispatch<false>(x, packed, scale, out, M, K, N, s));
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
