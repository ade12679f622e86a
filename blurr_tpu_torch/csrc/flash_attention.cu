// Flash attention for the Pi-0 joint prefill, written for Hopper (sm_90a).
//
// Replaces the TPU kernel blurr_tpu/ops/pallas_attention.py:_attn_kernel
// (wrapper flash_attention). It computes the same function as that kernel
// and as the plain blurr_tpu_torch.ops.attention.grouped_attention:
//
//   s   = fp32(q) . fp32(k) * scale
//   s   = tanh(s / softclamp) * softclamp          (when softclamp > 0)
//   s   = mask ? s : finfo(float32).min
//   out = softmax(s) @ v, cast to the input type
//
// with an online softmax (m, l, O) in fp32, m starting at finfo.min (not
// -inf) and l floored at 1e-30. GQA: query head h reads KV head
// h / (NH / KVH). Keys past Skv get p = 0 and take no part in the max, so a
// fully masked row (a pad token of the prompt) sees every valid key at
// finfo.min and averages V uniformly over the Skv keys, as the plain
// version does (the TPU kernel pads the keys to a multiple of 128 and
// averages over those too). No tile is skipped for its mask.
//
// Two kernels behind one entry point, chosen by the input type.
//
// bf16 (the served prefill): tensor cores.
// - Fold the query heads of one KV group into rows. Row r of group
//   (b, kvh) is query head kvh g + r / Sq at query r mod Sq (g = NH / KVH);
//   in the [B, NH, Sq, D] layout those rows are contiguous, so the fold is
//   free. Its mask row is r mod Sq. At the Pi-0 prefill (q [1,8,277,256]
//   over k/v [1,1,277,256]) that is 2,216 rows over one K/V, and a block
//   reads each K/V tile once for 64 rows of any head.
// - A block of 8 warps owns 64 rows; warp w owns rows 16 (w % 4) .. + 15.
//   S = Q K^T and O += P V are bf16 mma.sync.m16n8k16 with fp32
//   accumulators. For S the two warps of a row group split each 64-key
//   tile: warp w takes the 16-key steps h and h + 2 (h = w / 4), so a
//   short last tile still feeds both. They swap their clamped, masked
//   logits through shared memory (a 64-thread named barrier), so both hold
//   the tile's whole softmax in the same order and the same m and l. For
//   P V they split the head: warp w takes columns h D / 2 .. + D / 2 - 1
//   over all the tile's keys, so O is D / 4 fp32 registers a thread (64 at
//   head_dim 256) and the halves never need merging. Q (A) and K (B;
//   [key][d] is already the "col" operand) come by ldmatrix.x4 from shared
//   memory, the fragments of the next 16 head columns loading while the
//   current ones multiply; V by ldmatrix.x4.trans. P comes from the
//   logits in registers, packed to bf16: the C layout of two adjacent n8
//   tiles is the A layout of one k16 step. Steps that hold no key are
//   skipped (a compile-time count of steps, no predicated loads).
// - Loads: 16-byte cp.async of 64-key K and V tiles into a ring of two
//   stages (tile t + 1 lands while tile t is multiplied); neighbouring
//   threads load neighbouring 16 bytes of one row, each thread's column
//   fixed once. Staged rows are padded by 16 bytes, so the 8 row addresses
//   of an ldmatrix phase fall in 8 distinct bank groups. Keys past the
//   part land as zeros.
// - Fill the card: the keys are split into P parts of ceil(Skv / P) keys
//   (P <= 8, and at most one part per 32 keys), P the most that keeps the grid
//   (64-row tiles x P x B KVH) within one block per SM: at the Pi-0
//   prefill 35 x 3 = 105 blocks (parts of 93, 93 and 91 keys), at the
//   pool64 prefill (97 tokens) 13 x 4 (25, 25, 25, 22). Each part keeps its
//   own (m, l, O). The P blocks of a row tile form one thread block
//   cluster; rows p share .. of the tile belong to block p (share =
//   ceil(64 / P)). After a cluster barrier each block stores its O (fp32)
//   and (m, l) of every row into the row's owner's shared memory, in
//   16-byte stores through distributed shared memory (stores need no round
//   trip; loads were slower), and after a second barrier each owner adds
//   the parts in part order (m = max m_i, w_i = 2^(m_i - m), l = sum w_i
//   l_i, O = sum w_i O_i). Two calls give the same bits. One launch, no
//   workspace, no atomics.
// - Numerics: the logits are kept in the base-2 domain (z = log2(e) s, so
//   p = 2^(z - m): exp2f, one ex2.approx), and the clamp is tanh(y) =
//   1 - 2 / (1 + 2^(2 y log2 e)) with __fdividef: about 1e-7 of tanh, 1e-5
//   of a clamped logit, far below the bf16 rounding of P. The bf16 checks
//   hold with a margin of more than 10 against their 2e-2 tolerance at the
//   four shapes of chip_smoke.py, as they did with tanhf and expf. m
//   starts at -FLT_MAX, the row max is reduced over the 4 lanes that own a
//   row. The P V product rounds P to bf16, as the plain version rounds its
//   softmax weights before P V and as JAX's XLA route does; l sums the
//   fp32 p. (The fp32 kernel and the TPU kernel keep P in fp32.)
//
// fp32: the CUDA-core kernel of the first port, kept as it was: a tensor
// core fp32 path would be TF32 (about three digits), and fp32 callers
// (the small fp32 model held to 1e-4 against the CPU) need full fp32. One
// block of 128 threads owns one (batch, query head, 16-query tile), walks
// the keys in tiles of 32 staged in shared memory as fp32; lane j scores
// key j of the tile for the warp's 4 rows with fp32 FMAs, and for P V lane
// j owns columns j, j + 32, ... with the probabilities passed by shuffle.
//
// What bounds it on the H100: one Pi-0 prefill layer reads ~0.3 MB of K/V
// and 1.1 MB of Q and writes 1.1 MB (0.78 us at 3.35 TB/s) for ~0.63 GFLOP
// (0.64 us at 989 TFLOP/s bf16), so the bound is bytes, barely. At batch 1
// the launch is small and latency-bound: each block's chain is loading Q
// and its first K/V tile with cp.async, two tiles of mma.sync (whose
// 16-row warp tiles read every K and V fragment from shared memory once per
// 16 rows), and the cluster merge, whose distributed shared memory moves
// far fewer bytes a cycle than an SM's own. wgmma (64-row tiles from
// shared memory), TMA and its multicast of K/V to a cluster, warp
// specialisation and a persistent kernel are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

namespace fp32 {

constexpr int kBlockQ = 16;   // query rows per block
constexpr int kBlockK = 32;   // keys per shared-memory tile (one per lane)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 4

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

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
}  // namespace fp32

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kRowWarps = 4;               // warps along the rows: 16 rows each
constexpr int kHalves = 2;                 // warps along the keys (S) and the columns (P V)
constexpr int kWarps = kRowWarps * kHalves;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kRowWarps;      // folded query rows per block
constexpr int kKeys = 64;                  // keys per staged K/V tile: 4 steps of 16
constexpr int kPad = 8;                    // bf16 of padding per staged row (16 bytes)
constexpr int kKeysPerPart = 32;           // at most one part of the key split per 32 keys
constexpr int kMaxParts = 8;               // the largest portable cluster
constexpr int kRecvRows = kRows + kMaxParts - 1;  // rows of all parts an owner receives
constexpr float kLog2e = 1.4426950408889634f;

struct Geometry {
  int row_tiles, parts, part_keys;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The key split: P parts of part_keys keys (the last may hold fewer), P the
// most that keeps row_tiles x P x B KVH blocks within one wave of one block
// per SM, at most kMaxParts, and at most one part per kKeysPerPart keys.
Geometry geometry(int B, int NH, int KVH, int Sq, int Skv, int sms) {
  Geometry geo;
  geo.row_tiles = ceil_div(NH / KVH * Sq, kRows);
  const int tiles = geo.row_tiles * B * KVH;
  int parts = sms / tiles;
  parts = std::min(parts, kMaxParts);
  parts = std::min(parts, ceil_div(Skv, kKeysPerPart));
  parts = std::max(parts, 1);
  geo.part_keys = ceil_div(Skv, parts);
  geo.parts = ceil_div(Skv, geo.part_keys);  // no part is empty
  return geo;
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      return 132;
    counts[dev] = n;
  }
  return counts[dev];
}

// The region of the K/V stages; after the key loop it holds the part's O
// [kRows][D + kPad], then the O rows this block receives from every part
// [kRecvRows][D] (fp32).
template <int D>
__host__ __device__ constexpr size_t stage_bytes() {
  const size_t stages = sizeof(bf16) * 4 * kKeys * (D + kPad);
  const size_t merge = sizeof(float) * ((size_t)kRows * (D + kPad) + (size_t)kRecvRows * D);
  return stages > merge ? stages : merge;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // Q [kRows][D + kPad] (bf16); the stage region; each warp's logits for
  // its partner [kWarps][4][32 lanes][4] and m, l [kRows], the received m,
  // l and merge weights [kRecvRows] and 1 / l [kRows] (fp32)
  return sizeof(bf16) * (size_t)kRows * (D + kPad) + stage_bytes<D>() +
         sizeof(float) * (size_t)(kWarps * 4 * 32 * 4 + 3 * kRows + 3 * kRecvRows);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Barrier `id` (1 .. 15) of the `threads` threads that name it.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 to one bf16x2 register, lo in the low half (round to nearest).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S (4 n8 tiles) = Q K^T over N 16-key steps of K, whose ldmatrix row
// addresses are k0 and k1; the fragments of the next 16 columns of the head
// load while the current ones multiply.
template <int D, int N>
__device__ __forceinline__ void qk_steps(float (&s)[4][4], unsigned q_addr, unsigned k0,
                                         unsigned k1) {
  uint32_t a[2][4], b[2][N][4];
  ldmatrix_x4(a[0], q_addr);
  ldmatrix_x4(b[0][0], k0);
  if (N > 1) ldmatrix_x4(b[0][N - 1], k1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int cur = kk & 1;
    if (kk + 1 < D / 16) {
      ldmatrix_x4(a[cur ^ 1], q_addr + (kk + 1) * 32);
      ldmatrix_x4(b[cur ^ 1][0], k0 + (kk + 1) * 32);
      if (N > 1) ldmatrix_x4(b[cur ^ 1][N - 1], k1 + (kk + 1) * 32);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      mma_bf16(s[2 * n], a[cur], b[cur][n][0], b[cur][n][1]);
      mma_bf16(s[2 * n + 1], a[cur], b[cur][n][2], b[cur][n][3]);
    }
  }
}

// O (the warp's D / 2 columns) += P V over the first N 16-key steps of the
// tile; v is the ldmatrix.trans row address of step 0 at the first column.
template <int D, int N>
__device__ __forceinline__ void pv_steps(float (&o)[D / 16][4], uint32_t (&p)[4][4],
                                         unsigned v, unsigned step_bytes) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, v + u * step_bytes + c * 32);
      mma_bf16(o[2 * c], p[u], bv[0], bv[1]);
      mma_bf16(o[2 * c + 1], p[u], bv[2], bv[3]);
    }
  }
}

// One block: folded rows r0 .. r0 + 63 of group blockIdx.z (= b KVH + kvh),
// keys of part blockIdx.y (its rank in the cluster of the row tile's parts).
// Warp w owns rows 16 (w % 4) .. + 15. For S it takes the 16-key steps
// hk and hk + 2 of every 64-key tile (hk = w / 4); it hands its logits to
// the warp of the other half through shared memory and takes theirs, so
// both hold the whole tile's softmax; for P V it takes the columns
// hk D / 2 .. + D / 2 - 1 over all of the tile's keys.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                       bf16* __restrict__ out, int NH, int KVH, int Sq, int Skv,
                       int part_keys, float scale, float softclamp) {
  constexpr int S = D + kPad;            // bf16 per staged row; floats per row of O
  constexpr int kChunks = D / 8;         // 16-byte chunks of a row
  constexpr int kRowStep = kThreads / kChunks;
  constexpr int kStage = 2 * kKeys * S;  // bf16 of one stage: K rows, then V rows
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* kv_s = q_s + kRows * S;
  float* o_s = reinterpret_cast<float*>(kv_s);  // [kRows][S], after the key loop
  float* recv_s = o_s + kRows * S;               // [kRecvRows][D]
  float* z_s = reinterpret_cast<float*>(tc_smem + sizeof(bf16) * kRows * S + stage_bytes<D>());
  float* m_s = z_s + kWarps * 4 * 32 * 4;        // [kRows]
  float* l_s = m_s + kRows;                      // [kRows]
  float* inv_s = l_s + kRows;                    // [kRows]
  float* m_recv = inv_s + kRows;                 // [kRecvRows]
  float* l_recv = m_recv + kRecvRows;            // [kRecvRows]
  float* w_s = l_recv + kRecvRows;               // [kRecvRows]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int hk = warp / kRowWarps, row_warp = warp % kRowWarps;  // half, row warp
  const int g = NH / KVH;
  const int rows = g * Sq;  // folded rows of the group
  const int r0 = blockIdx.x * kRows;
  const int part = blockIdx.y, parts = gridDim.y;
  const int group = blockIdx.z, b = group / KVH;
  // the group's query heads are contiguous: folded row r is row r of q_g
  const int64_t head0 = (int64_t)b * NH + (int64_t)(group % KVH) * g;
  const bf16* q_g = q + head0 * Sq * D;
  bf16* out_g = out + head0 * Sq * D;
  const bf16* k_g = k + (int64_t)group * Skv * D;
  const bf16* v_g = v + (int64_t)group * Skv * D;
  const int kb = part * part_keys;
  const int ke = min(Skv, kb + part_keys);  // keys kb .. ke - 1 are this block's
  const int n_tiles = (ke - kb + kKeys - 1) / kKeys;

  // copies: thread tid moves chunk `ch` of rows crow, crow + kRowStep, ...
  const int ch = tid % kChunks, crow = tid / kChunks;
  for (int r = crow; r < kRows; r += kRowStep) {
    const bool in = r0 + r < rows;  // rows past the group are zero
    cp_async16(q_s + r * S + ch * 8, in ? q_g + (int64_t)(r0 + r) * D + ch * 8 : q_g,
               in ? 16 : 0);
  }
  auto load_tile = [&](int t, int stage) {
    bf16* ks = kv_s + stage * kStage;
    bf16* vs = ks + kKeys * S;
    const int k0 = kb + t * kKeys;
    for (int r = crow; r < kKeys; r += kRowStep) {
      const bool in = k0 + r < ke;  // keys past the part are zero
      const int64_t off = (int64_t)(k0 + r) * D + ch * 8;
      cp_async16(ks + r * S + ch * 8, in ? k_g + off : k_g, in ? 16 : 0);
      cp_async16(vs + r * S + ch * 8, in ? v_g + off : v_g, in ? 16 : 0);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // the thread's rows: ra = 16 row_warp + gid and rb = ra + 8 of the tile
  const int ra = row_warp * 16 + gid, rb = ra + 8;
  const uint8_t* mask_a = nullptr;
  const uint8_t* mask_b = nullptr;
  if (mask) {
    mask_a = mask + ((int64_t)b * Sq + (r0 + ra) % Sq) * Skv;
    mask_b = mask + ((int64_t)b * Sq + (r0 + rb) % Sq) * Skv;
  }

  // ldmatrix row addresses. Q (A of S): lane t gives row t % 16, column
  // 8 (t / 16). K (B of S, x4 = two n8 tiles of one k16 step): key
  // 8 (t / 16) + t % 8, column 8 ((t / 8) % 2). V (B of P V, .trans, x4 =
  // one k16 step of two n8 tiles): key 8 ((t / 8) % 2) + t % 8, column
  // 8 (t / 16), from the warp's first column.
  const unsigned q_addr = smem_addr(q_s + (row_warp * 16 + lane % 16) * S + (lane / 16) * 8);
  const unsigned k_addr =
      smem_addr(kv_s + ((lane / 16) * 8 + lane % 8) * S + ((lane / 8) % 2) * 8);
  const unsigned v_addr = smem_addr(kv_s + kKeys * S + (((lane / 8) % 2) * 8 + lane % 8) * S +
                                    (lane / 16) * 8 + hk * (D / 2));
  constexpr unsigned kStageBytes = kStage * sizeof(bf16);
  constexpr unsigned kStepBytes = 16 * S * sizeof(bf16);  // 16 staged rows
  // this warp's logits for its partner, and the partner's: [4 n8 tiles][lane]
  float4* z_mine = reinterpret_cast<float4*>(z_s) + warp * 4 * 32 + lane;
  const float4* z_theirs =
      reinterpret_cast<const float4*>(z_s) + (warp ^ kRowWarps) * 4 * 32 + lane;

  // logits in the base-2 domain: z = log2(e) s, so p = 2^(z - m)
  const bool clamp = softclamp > 0.f;
  const float pre = clamp ? 2.f * kLog2e * scale / softclamp : kLog2e * scale;
  const float post = kLog2e * softclamp;

  float o[D / 16][4];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = -FLT_MAX, m_b = -FLT_MAX, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile t (and Q) has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kb + t * kKeys;
    const int steps = (min(kKeys, ke - k0) + 15) / 16;  // 16-key steps holding a key
    const int mine = (steps > hk) + (steps > hk + 2);    // of them, this warp's (S)

    // the mask bits of the warp's 16 keys of each row, read before the
    // product so their latency hides behind it: bit 2 j + e is key
    // k0 + 16 (hk + 2 (j / 2)) + 8 (j % 2) + 2 tig + e
    uint32_t bits_a = 0xffffffffu, bits_b = 0xffffffffu;
    if (mask) {
      bits_a = bits_b = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 16 * (hk + 2 * (j / 2)) + 8 * (j % 2) + 2 * tig + e;
          if (key < ke) {
            bits_a |= (uint32_t)(mask_a[key] != 0) << (2 * j + e);
            bits_b |= (uint32_t)(mask_b[key] != 0) << (2 * j + e);
          }
        }
      }
    }

    // S = Q K^T over the warp's 16-key steps hk and hk + 2 (4 n8 tiles)
    // that hold a key; lane holds rows ra (s[j][0..1]) and rb (s[j][2..3])
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const unsigned ks = k_addr + stage * kStageBytes + hk * kStepBytes;
    if (mine == 2)
      qk_steps<D, 2>(s, q_addr, ks, ks + 2 * kStepBytes);
    else if (mine == 1)
      qk_steps<D, 1>(s, q_addr, ks, ks + 2 * kStepBytes);

    // scale, clamp, mask; keys past the part -> -inf (no part in the max, p 0)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 16 * (hk + 2 * (j / 2)) + 8 * (j % 2) + 2 * tig + (e & 1);
        // tanh(y) = 1 - 2 / (1 + e^(2 y))
        float z = clamp ? (1.f - __fdividef(2.f, 1.f + exp2f(s[j][e] * pre))) * post
                        : s[j][e] * pre;
        if (key >= ke)
          z = -INFINITY;
        else if (!((e < 2 ? bits_a : bits_b) >> (2 * j + (e & 1)) & 1u))
          z = -FLT_MAX;
        s[j][e] = z;
      }
      z_mine[j * 32] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
    named_barrier(1 + row_warp, 64);  // the two warps of these rows
    // the whole tile's logits in key order: step u is n8 tiles 2 u, 2 u + 1;
    // this warp's steps are hk, hk + 2
    float z[8][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 x4 = z_theirs[j * 32];
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // half 0's n8 tile j is step 2 (j / 2), half 1's step 2 (j / 2) + 1
        z[4 * (j / 2) + j % 2][e] = hk ? x[e] : s[j][e];
        z[4 * (j / 2) + 2 + j % 2][e] = hk ? s[j][e] : x[e];
      }
    }

    float mx_a = -FLT_MAX, mx_b = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(z[j][0], z[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(z[j][2], z[j][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // p in fp32 for l (the lane's partial row sums); bf16 for P V. The A
    // fragment of step u: n8 tile 2 u gives a0 (row ra), a1 (rb); tile
    // 2 u + 1 gives a2, a3.
    uint32_t p[4][4];
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(z[j][0] - mn_a), p1 = exp2f(z[j][1] - mn_a);
      const float p2 = exp2f(z[j][2] - mn_b), p3 = exp2f(z[j][3] - mn_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      p[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      p[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_a = alpha_a * l_a + sum_a;
    l_b = alpha_b * l_b + sum_b;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      o[j][0] *= alpha_a;
      o[j][1] *= alpha_a;
      o[j][2] *= alpha_b;
      o[j][3] *= alpha_b;
    }
    // O += P V: the warp's D / 16 n8 tiles of columns, two per ldmatrix.x4.trans
    const unsigned vs = v_addr + stage * kStageBytes;
    switch (steps) {
      case 4: pv_steps<D, 4>(o, p, vs, kStepBytes); break;
      case 3: pv_steps<D, 3>(o, p, vs, kStepBytes); break;
      case 2: pv_steps<D, 2>(o, p, vs, kStepBytes); break;
      default: pv_steps<D, 1>(o, p, vs, kStepBytes); break;
    }
    __syncthreads();  // this stage (and the logits) are no longer read
  }

  // this part's O (unnormalized; each warp its rows' half of the columns),
  // m and l (the same in both halves) into shared memory
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const int c = hk * (D / 2) + 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(o_s + ra * S + c) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(o_s + rb * S + c) = make_float2(o[j][2], o[j][3]);
  }
  if (hk == 0 && tig == 0) {
    m_s[ra] = m_a;
    m_s[rb] = m_b;
    l_s[ra] = l_a;
    l_s[rb] = l_b;
  }

  // the parts merge. Rows lo .. lo + share - 1 of the tile belong to block
  // lo / share: once every block of the cluster is past its key loop, each
  // block stores its rows' O, m and l into their owners' shared memory
  // (16-byte stores through distributed shared memory, no round trip); after
  // a second cluster barrier each owner adds the parts in part order.
  cg::cluster_group cluster = cg::this_cluster();
  auto at = [&](float* p, int rank) { return parts > 1 ? cluster.map_shared_rank(p, rank) : p; };
  const int share = (kRows + parts - 1) / parts;
  const int valid = min(kRows, rows - r0);  // rows of the tile inside the group
  constexpr int kQuads = D / 4;
  if (parts > 1)
    cluster.sync();
  else
    __syncthreads();
  for (int e = tid; e < valid * kQuads; e += kThreads) {
    const int r = e / kQuads, c = (e % kQuads) * 4;
    const int owner = r / share, i = part * share + r - owner * share;
    *reinterpret_cast<float4*>(at(recv_s, owner) + i * D + c) =
        *reinterpret_cast<const float4*>(o_s + r * S + c);
  }
  for (int r = tid; r < valid; r += kThreads) {
    const int owner = r / share, i = part * share + r - owner * share;
    *at(m_recv + i, owner) = m_s[r];
    *at(l_recv + i, owner) = l_s[r];
  }
  if (parts > 1)
    cluster.sync();
  else
    __syncthreads();
  const int lo = part * share;
  const int n = min(lo + share, valid) - lo;  // rows this block owns
  for (int i = tid; i < n; i += kThreads) {
    float m = -FLT_MAX;
    for (int p = 0; p < parts; ++p) m = fmaxf(m, m_recv[p * share + i]);
    float l = 0.f;
    for (int p = 0; p < parts; ++p) {
      const float w = exp2f(m_recv[p * share + i] - m);
      w_s[p * share + i] = w;
      l = __fadd_rn(l, __fmul_rn(w, l_recv[p * share + i]));
    }
    inv_s[i] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < n * kQuads; e += kThreads) {
    const int i = e / kQuads, c = (e % kQuads) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < parts; ++p) {
      const float w = w_s[p * share + i];
      const float4 x = *reinterpret_cast<const float4*>(recv_s + (p * share + i) * D + c);
      acc.x = __fadd_rn(acc.x, __fmul_rn(w, x.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w, x.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w, x.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w, x.w));
    }
    const float inv = inv_s[i];
    uint2 packed;
    packed.x = pack_bf16(acc.x * inv, acc.y * inv);
    packed.y = pack_bf16(acc.z * inv, acc.w * inv);
    *reinterpret_cast<uint2*>(out_g + (int64_t)(r0 + lo + i) * D + c) = packed;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int B, int NH, int KVH, int Sq, int Skv, float scale, float softclamp,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (allowed != cudaSuccess) return allowed;
  const Geometry geo = geometry(B, NH, KVH, Sq, Skv, sm_count());
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(geo.row_tiles, geo.parts, B * KVH);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = geo.parts;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, flash_attention_kernel<D>, static_cast<const bf16*>(q),
                            static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                            static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), NH,
                            KVH, Sq, Skv, geo.part_keys, scale, softclamp);
}

cudaError_t dispatch_head_dim(int D, const void* q, const void* k, const void* v,
                              const void* mask, void* out, int B, int NH, int KVH, int Sq,
                              int Skv, float scale, float softclamp, cudaStream_t stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return cudaErrorMisalignedAddress;  // 16-byte cp.async and stores
  switch (D) {
    case 32: return launch<32>(q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale, softclamp, stream);
    case 64: return launch<64>(q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale, softclamp, stream);
    case 128: return launch<128>(q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale, softclamp, stream);
    case 256: return launch<256>(q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale, softclamp, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

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
    return (int)fp32::dispatch_head_dim<float>(D, q, k, v, mask, out, B, NH, KVH, Sq, Skv,
                                               scale, softclamp, s);
  if (dtype == 1)
    return (int)tc::dispatch_head_dim(D, q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale,
                                      softclamp, s);
  return (int)cudaErrorInvalidValue;
}

// The launch geometry of a call: grid[0..2] the grid (x, y, z) and grid[3]
// the keys of a part (bf16; 0 for fp32, which does not split the keys).
// bf16: (64-row tiles of the folded rows, key parts = cluster size, B KVH);
// fp32: (16-query tiles, NH, B). Returns a cudaError_t.
extern "C" int blurr_flash_attention_grid(int B, int NH, int KVH, int Sq, int Skv, int dtype,
                                          int* grid) {
  if (B <= 0 || NH <= 0 || KVH <= 0 || NH % KVH || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    grid[0] = (Sq + fp32::kBlockQ - 1) / fp32::kBlockQ;
    grid[1] = NH;
    grid[2] = B;
    grid[3] = 0;
    return 0;
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const tc::Geometry geo = tc::geometry(B, NH, KVH, Sq, Skv, tc::sm_count());
  grid[0] = geo.row_tiles;
  grid[1] = geo.parts;
  grid[2] = B * KVH;
  grid[3] = geo.part_keys;
  return 0;
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
