// Flash attention for the Pi-0 joint prefill, written for Hopper (sm_90a).
//
// Replaces the TPU kernel blurr_tpu/ops/pallas_attention.py:_attn_kernel
// (wrapper flash_attention). It computes the same function as that kernel
// and as the plain blurr_tpu_torch.ops.attention.grouped_attention:
//
//   s   = fp32(q) . fp32(k) * scale
//   s   = tanh(s / softclamp) * softclamp          (when softclamp > 0)
//   s   = mask ? s : finfo(float32).min
//   out = softmax(s) @ fp32(v), cast to the input type
//
// with an online softmax (m, l, acc) in fp32, m starting at finfo.min (not
// -inf) and l floored at 1e-30. GQA: query head h reads KV head
// h / (NH / KVH).
//
// Shape of the design. One block of 128 threads (4 warps) owns one
// (batch, query head, 16-query tile); at the Pi-0 prefill, q [1,8,277,256]
// over k/v [1,1,277,256], that is 8 x 18 = 144 blocks, about one per SM.
// The block walks the keys in tiles of 32, staged in shared memory as fp32.
// Warp w owns query rows 4w..4w+3 of the tile. For S = Q K^T lane j holds
// the score of key j of the tile for each of its 4 rows, so a row's max and
// sum are warp shuffles. For P V lane j owns columns j, j+32, ... of the
// output for the same 4 rows, and the probabilities come from the owning
// lane by shuffle, so P never touches shared memory.
//
// Ragged edges are bounds checks, not padding: keys past Skv get p = 0 and
// never join the max, and query rows past Sq are computed on zeros and not
// stored. A fully masked row (a pad token of the prompt) sees every valid
// key at finfo.min, so its weights are uniform over the Skv keys and its
// output is finite, as in the plain version.
//
// What bounds it on the H100: one prefill layer is ~0.63 GFLOP over ~2.6 MB
// (near the bf16 ridge), but at batch 1 the 144 blocks give one block per SM
// and 4 warps per SM, so it is bound by latency and occupancy, and by the
// fp32 FMA pipe since it uses no tensor cores. What the design does about
// it: K/V tiles are read once per block from L2 (all 8 query heads share the
// single KV head), the K rows in shared memory are padded by one float so
// the 32 lanes reading 32 keys hit 32 banks, and P stays in registers.
// wgmma, TMA and a deeper pipeline are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <float.h>

namespace {

constexpr int kBlockQ = 16;   // query rows per block
constexpr int kBlockK = 32;   // keys per shared-memory tile (one per lane)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 4

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q [16][D], K [32][D + 1] (padded: conflict-free column reads), V [32][D]
  return sizeof(float) * (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ mask,
                       T* __restrict__ out, int NH, int KVH, int Sq, int Skv,
                       float scale, float softclamp) {
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                          // [kBlockQ][D]
  float* k_s = q_s + kBlockQ * D;             // [kBlockK][D + 1]
  float* v_s = k_s + kBlockK * (D + 1);       // [kBlockK][D]

  const int q_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (NH / KVH);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = q_tile * kBlockQ;

  const T* q_bh = q + ((int64_t)b * NH + h) * Sq * D;
  const T* k_bh = k + ((int64_t)b * KVH + kvh) * Skv * D;
  const T* v_bh = v + ((int64_t)b * KVH + kvh) * Skv * D;
  const uint8_t* mask_b = mask ? mask + (int64_t)b * Sq * Skv : nullptr;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D;
    const int qi = q0 + r;
    q_s[e] = qi < Sq ? to_float(q_bh[(int64_t)qi * D + (e - r * D)]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -FLT_MAX;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read (and Q is stored)
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const int kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < Skv) {
        kx = to_float(k_bh[(int64_t)kj * D + d]);
        vx = to_float(v_bh[(int64_t)kj * D + d]);
      }
      k_s[j * (D + 1) + d] = kx;
      v_s[e] = vx;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool in_range = kj < Skv;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const float* qr = q_s + row * D;
      const float* kr = k_s + lane * (D + 1);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softclamp > 0.f) s = tanhf(s / softclamp) * softclamp;
      const int qi = q0 + row;
      if (mask_b && in_range && qi < Sq && !mask_b[(int64_t)qi * Skv + kj]) s = -FLT_MAX;
      // out-of-range keys take no part in the max (they get p = 0 below)
      const float m_new = fmaxf(m[r], warp_max(in_range ? s : -FLT_MAX));
      p[r] = in_range ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }

    const int n_keys = min(kBlockK, Skv - k0);
    for (int j = 0; j < n_keys; ++j) {
      const float* vr = v_s + j * D;
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vj[c] = vr[lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* o_row = out + (((int64_t)b * NH + h) * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o_row[lane + 32 * c] = from_float<T>(acc[r][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* out, int B, int NH, int KVH, int Sq, int Skv, float scale,
                   float softclamp, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, NH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), NH, KVH, Sq, Skv, scale,
      softclamp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int D, const void* q, const void* k, const void* v,
                              const void* mask, void* out, int B, int NH, int KVH, int Sq,
                              int Skv, float scale, float softclamp, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale, softclamp, stream);
    case 64: return launch<T, 64>(q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale, softclamp, stream);
    case 128: return launch<T, 128>(q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale, softclamp, stream);
    case 256: return launch<T, 256>(q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale, softclamp, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softclamp <= 0 disables the clamp.
// mask may be null (every key valid). Returns the launch's cudaError_t.
extern "C" int blurr_flash_attention(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int B, int NH, int KVH,
                                     int Sq, int Skv, int D, int dtype, float scale,
                                     float softclamp, void* stream) {
  if (B <= 0 || NH <= 0 || KVH <= 0 || NH % KVH || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(D, q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale,
                                         softclamp, s);
  if (dtype == 1)
    return (int)dispatch_head_dim<__nv_bfloat16>(D, q, k, v, mask, out, B, NH, KVH, Sq, Skv,
                                                 scale, softclamp, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
