// Fused GeGLU feed-forward block, bf16, written for Hopper (sm_90a).
//
// Replaces the TPU kernel experiments/bench_fused_ffn.py:_kernel (wrapper
// fused_ffn). It computes that kernel's function, and that of the plain
// blurr_tpu_torch.ops.fused_ffn.fused_ffn_reference:
//
//   a   = bf16(gelu_tanh(x @ Wg) * (x @ Wu))    dots and product in fp32
//   out = bf16(a @ Wd)                          accumulated in fp32
//
// x is bf16 [M, H]; Wg and Wu are bf16 [H, I]; Wd is bf16 [I, H]; out is bf16
// [M, H]. The [M, I] intermediate never goes to device memory.
//
// Shape of the design. The TPU kernel walks the I-blocks in order, one grid
// step after another, into one fp32 [M, H] scratch. Here blocks run in
// parallel, so the work is split two ways and summed in a second pass:
// - ffn_partial_kernel: a block of 8 warps owns 16 rows of x (one mma tile)
//   and one slice of I. It keeps the x rows in shared memory, and an fp32
//   partial [16, H] of its slice's down product in shared memory, in mma
//   fragment order (each lane reads and writes only its own float4s). For
//   each 64 columns of its slice it computes the gate and up dots with
//   bf16 mma.sync m16n8k16 (fp32 accumulators; warp w owns 8 columns of
//   both, so gelu_tanh(g) * u is formed in registers), rounds a to bf16 into
//   shared memory, then adds a [16, 64] @ Wd[64, H] into the partial, 16
//   columns of each 128 per warp. Weight tiles are staged in shared memory
//   with 16-byte loads. At the end it writes the partial to a workspace
//   [S, M, H] (fp32).
// - ffn_reduce_kernel sums the S partials of each output in slice order and
//   rounds once to bf16. No atomics: the result does not depend on the order
//   the blocks ran in.
//
// What bounds it on the H100: the three weights are 3 * H * I bf16, 201 MB
// at H 2048, I 16384, 60 us at 3.35 TB/s; the three products are 6 * M * H * I
// operations, 56 G at M 280, 57 us at 989 TFLOP/s. This kernel reads every
// weight once per 16-row tile of x (18 times at M 280, through L2), with one
// block of 8 warps on each SM and the loads not overlapped with the mma; it
// is bound by those loads and their latency. wgmma on 64-row tiles fed by
// TMA, with the weights read once, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // rows of x per block: one mma tile
constexpr int kSub = 64;       // columns of I per step: 8 per warp
constexpr int kKChunk = 64;    // rows of Wg and Wu staged at once
constexpr int kHChunk = 128;   // columns of Wd staged at once: 16 per warp
constexpr int kMaxH = 2048;    // the fp32 partial [16, H] fits in shared memory
constexpr int kPad = 8;        // bf16 of padding per shared row (bank spread)
constexpr int kGUStride = kSub + kPad;
constexpr int kDStride = kHChunk + kPad;
constexpr int kAStride = kSub + kPad;

typedef __nv_bfloat16 bf16;

size_t smem_bytes(int H) {
  const size_t x = (size_t)kRows * (H + kPad) * sizeof(bf16);
  const size_t p = (size_t)kRows * H * sizeof(float);
  const size_t a = (size_t)kRows * kAStride * sizeof(bf16);
  const size_t w_gu = (size_t)2 * kKChunk * kGUStride * sizeof(bf16);
  const size_t w_d = (size_t)kSub * kDStride * sizeof(bf16);
  return x + p + a + (w_gu > w_d ? w_gu : w_d);
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 of one column at rows k and k + 1 (p points at row k; rows are
// `stride` apart) as one mma operand register, row k in the low half.
__device__ __forceinline__ uint32_t column_pair(const bf16* p, int stride) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return lo | (hi << 16);
}

// The A operand of m16n8k16 from a row-major bf16 tile: p points at
// (row 0, column k0) of the 16-row tile, rows `stride` apart.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* p, int stride, int gid,
                                       int tig) {
  const bf16* q = p + gid * stride + 2 * tig;
  a[0] = *reinterpret_cast<const uint32_t*>(q);
  a[1] = *reinterpret_cast<const uint32_t*>(q + 8 * stride);
  a[2] = *reinterpret_cast<const uint32_t*>(q + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(q + 8 * stride + 8);
}

// The B operand from a row-major [k][n] bf16 tile: p points at (k0, n0).
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* p, int stride, int gid,
                                       int tig) {
  b[0] = column_pair(p + (2 * tig) * stride + gid, stride);
  b[1] = column_pair(p + (2 * tig + 8) * stride + gid, stride);
}

// PyTorch's tanh approximation of GELU (its CUDA formula), in fp32.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                   const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                   float* __restrict__ ws, int M, int H, int I, int slices) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs = H + kPad;
  bf16* x_s = reinterpret_cast<bf16*>(smem);
  float* p_s = reinterpret_cast<float*>(smem + (size_t)kRows * xs * sizeof(bf16));
  bf16* a_s = reinterpret_cast<bf16*>(p_s + (size_t)kRows * H);
  bf16* w_s = a_s + kRows * kAStride;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kRows;
  const int slice = blockIdx.y;
  const int n_sub = I / kSub;
  const int i_begin = (int)((int64_t)slice * n_sub / slices) * kSub;
  const int i_end = (int)((int64_t)(slice + 1) * n_sub / slices) * kSub;

  // the x rows (zero past M) and a zero partial
  const int vecs = H / 8;
  for (int e = threadIdx.x; e < kRows * vecs; e += kThreads) {
    const int r = e / vecs, v = e - r * vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) val = *reinterpret_cast<const uint4*>(x + (int64_t)(m0 + r) * H + v * 8);
    *reinterpret_cast<uint4*>(x_s + r * xs + v * 8) = val;
  }
  for (int e = threadIdx.x; e < kRows * H / 4; e += kThreads)
    reinterpret_cast<float4*>(p_s)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i0 = i_begin; i0 < i_end; i0 += kSub) {
    // gate and up of columns i0 .. i0 + 63; warp w owns 8 of them
    float g[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < H; k0 += kKChunk) {
      __syncthreads();  // w_s is free (and x_s, p_s, a_s written)
      constexpr int kVecs = kKChunk * kSub / 8;  // 16-byte loads per matrix
      for (int e = threadIdx.x; e < 2 * kVecs; e += kThreads) {
        const int mat = e / kVecs, rem = e - mat * kVecs;
        const int r = rem / (kSub / 8), v = rem - r * (kSub / 8);
        const bf16* src = (mat ? wu : wg) + (int64_t)(k0 + r) * I + i0 + v * 8;
        *reinterpret_cast<uint4*>(w_s + (mat * kKChunk + r) * kGUStride + v * 8) =
            *reinterpret_cast<const uint4*>(src);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKChunk; kk += 16) {
        uint32_t a[4], bg[2], bu[2];
        load_a(a, x_s + k0 + kk, xs, gid, tig);
        load_b(bg, w_s + kk * kGUStride + warp * 8, kGUStride, gid, tig);
        load_b(bu, w_s + (kKChunk + kk) * kGUStride + warp * 8, kGUStride, gid, tig);
        mma_bf16(g, a, bg);
        mma_bf16(u, a, bu);
      }
    }
    // a = bf16(gelu_tanh(g) * u): rows gid and gid + 8, columns 2 tig, 2 tig + 1
    {
      const int c = warp * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(a_s + gid * kAStride + c) =
          __floats2bfloat162_rn(gelu_tanh(g[0]) * u[0], gelu_tanh(g[1]) * u[1]);
      *reinterpret_cast<__nv_bfloat162*>(a_s + (gid + 8) * kAStride + c) =
          __floats2bfloat162_rn(gelu_tanh(g[2]) * u[2], gelu_tanh(g[3]) * u[3]);
    }
    // partial += a [16, 64] @ Wd[i0 .. i0 + 63, :]
    for (int h0 = 0; h0 < H; h0 += kHChunk) {
      __syncthreads();  // a_s written, w_s free
      constexpr int kVecs = kSub * kHChunk / 8;
      for (int e = threadIdx.x; e < kVecs; e += kThreads) {
        const int r = e / (kHChunk / 8), v = e - r * (kHChunk / 8);
        *reinterpret_cast<uint4*>(w_s + r * kDStride + v * 8) =
            *reinterpret_cast<const uint4*>(wd + (int64_t)(i0 + r) * H + h0 + v * 8);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float4* slot = reinterpret_cast<float4*>(p_s) +
                       (((h0 / kHChunk) * kWarps + warp) * 2 + j) * 32 + lane;
        const float4 acc = *slot;
        float d[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int kk = 0; kk < kSub; kk += 16) {
          uint32_t a[4], b[2];
          load_a(a, a_s + kk, kAStride, gid, tig);
          load_b(b, w_s + kk * kDStride + warp * 16 + j * 8, kDStride, gid, tig);
          mma_bf16(d, a, b);
        }
        *slot = make_float4(d[0], d[1], d[2], d[3]);
      }
    }
  }

  // each lane writes its own fragments of the partial: ws[slice, m, h]
  for (int c = 0; c < H / kHChunk; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 v = reinterpret_cast<const float4*>(p_s)[((c * kWarps + warp) * 2 + j) * 32 + lane];
      const int h = c * kHChunk + warp * 16 + j * 8 + 2 * tig;
      float* dst = ws + ((int64_t)slice * M + m0 + gid) * H + h;
      if (m0 + gid < M) *reinterpret_cast<float2*>(dst) = make_float2(v.x, v.y);
      if (m0 + gid + 8 < M) *reinterpret_cast<float2*>(dst + 8 * (int64_t)H) = make_float2(v.z, v.w);
    }
  }
}

// out[e] = bf16(sum over slices s, in order, of ws[s, e])
__global__ void ffn_reduce_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                                  int64_t n, int slices) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = ws[e];
  for (int s = 1; s < slices; ++s) acc = __fadd_rn(acc, ws[(int64_t)s * n + e]);
  out[e] = __float2bfloat16_rn(acc);
}

}  // namespace

// x bf16 [M, H], wg and wu bf16 [H, I], wd bf16 [I, H], ws fp32 [slices, M, H]
// (scratch), out bf16 [M, H], all contiguous and 16-byte aligned; H a
// multiple of 128 up to 2048, I a multiple of 64, 1 <= slices <= I / 64.
// Launches both passes on `stream`; returns the first cudaError_t.
extern "C" int blurr_fused_ffn(const void* x, const void* wg, const void* wu, const void* wd,
                               void* ws, void* out, int M, int H, int I, int slices,
                               void* stream) {
  if (M <= 0 || H <= 0 || H % kHChunk || H > kMaxH || I <= 0 || I % kSub || slices < 1 ||
      slices > I / kSub)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, wg, wu, wd, (const void*)ws, (const void*)out})
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(H);
  // raised once to the most shared memory the kernel can ask for, on the
  // first call: not again inside a CUDA graph capture
  static cudaError_t attr = cudaFuncSetAttribute(
      ffn_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(kMaxH));
  if (attr != cudaSuccess) return (int)attr;
  cudaError_t err;
  dim3 grid((M + kRows - 1) / kRows, slices);
  ffn_partial_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
      static_cast<const bf16*>(wd), static_cast<float*>(ws), M, H, I, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)M * H;
  ffn_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(out), n, slices);
  return (int)cudaGetLastError();
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
