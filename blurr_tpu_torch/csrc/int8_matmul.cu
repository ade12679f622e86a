// Int8 weight-only dequant-matmul for the int8 tier, written for Hopper (sm_90a).
//
// Replaces the TPU kernel blurr_tpu/ops/pallas_int8_matmul.py:_kernel
// (wrappers int8_matmul and int8_mm_nd). It computes the same function as
// that kernel and as the plain blurr_tpu_torch.ops.int8_matmul.int8_matmul_reference:
//
//   out[m, n] = T( (sum over k of bf16(x[m, k]) * q[k, n]) * s[n] )
//
// x is T [M, K] (T = float or bf16); q is int8 [K, N], row-major (the JAX
// layout); s is fp32 [N]; out is T [M, N]. Every int8 value is a bf16, and
// the product of two bf16 values is exact in fp32, so the kernel and the
// plain version (which sums in float64) differ only by the order and the
// rounding of the kernel's fp32 sums. The scale is applied once, after the
// whole sum (__fmul_rn), then the cast, in the order of the TPU kernel.
//
// What bounds it on the H100: on the Pi-0 int8 step M is 1 or 4 and q is at
// most 4 MB (4096 x 1024 or 1024 x 4096), 1.3 us at 3.35 TB/s; the products
// are 2 M K N operations, 33 M at M 4, nothing for the tensor cores. So it is
// bound by the bytes of q and by latency: in a CUDA graph a launch that does
// almost nothing takes 2-3 us here (this kernel at K 7, or cuBLAS), and every
// step of a block's chain (copy in, dequantize and multiply, add across
// blocks) adds to it. The design keeps all 132 SMs busy and that chain short:
// - Split K. The grid is (N / 64 column tiles) x (S slices of K) x (M / 16
//   row tiles); S is the least power of two, up to 16, that makes ~256
//   blocks, with slices of at least 64 rows (blurr_int8_matmul_slices): 64 x
//   4 at (4, 1024, 4096), 16 x 16 at (4, 4096, 1024). A slice's rows are a
//   multiple of 16; the last slices may be short or empty.
// - Copy in. A block of 4 warps walks its slice in chunks of up to 256 rows.
//   It starts every 16-byte cp.async of the chunk's q tile [rows, 64]
//   (neighbouring threads on neighbouring columns) and, for bf16 x in
//   16-byte vectors (the served case), of its x rows, in two groups of 128
//   rows, and multiplies each group as soon as it has landed. fp32 x is
//   rounded to bf16 (__float2bfloat16_rn, the TPU kernel's x.astype(bf16))
//   as it is staged, with a batch of loads in flight before the first store.
//   Rows past M and past the chunk are zero. Where N is not a multiple of
//   16 or q is not 16-byte aligned, q is loaded byte by byte (the ragged N
//   of the tests); K 7 at the action encoder's w1 is one short slice.
// - Multiply. Each warp owns 16 of the 64 columns. Per 16 rows of K, one
//   ldmatrix.x4 gives the A fragment of bf16(x), and one ldmatrix.x2.trans
//   gives each lane four int8 of q: two rows by the two columns 2 gid and
//   2 gid + 1. dequant4 turns them into bf16 pairs with byte permutes and an
//   exact fp32 add, no conversion instruction (int8 -> bf16 is exact), for
//   two bf16 mma.sync.m16n8k16 with fp32 accumulators: one for the even
//   columns, one for the odd. The next step's fragments load during this
//   step's multiply. At M 1 or 4, 12 to 15 of the 16 A rows are zero. The
//   staged rows of q are 80 bytes apart and those of x 528, so ldmatrix
//   reads without bank conflicts.
// - Add across blocks. Where S is 1 the block scales, casts and stores.
//   Otherwise the tile's S blocks are one thread block cluster (16 needs the
//   non-portable cluster size). Output e of the tile belongs to block e % S:
//   each block stores its fp32 sum of e into that block's shared memory
//   (distributed shared memory, no trip through device memory), and after
//   one cluster barrier each block adds its outputs' S sums in slice order
//   (__fadd_rn), scales (__fmul_rn) and casts. No atomics: the same bits on
//   every call. Two other forms were slower on the H100 (PERF.md): a
//   second kernel for the sum, and the last-arriving block summing through
//   device memory behind a fence and a counter.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16;             // rows of x per block: one mma tile
constexpr int kBN = 64;             // columns per block: 16 per warp
constexpr int kChunk = 256;         // rows of K staged at once
constexpr int kQStride = kBN + 16;  // bytes per staged q row (bank spread, 16-aligned)
constexpr int kXStride = kChunk + 8;  // bf16 per staged x row (bank spread, 16-aligned)
constexpr int kMinSlice = 64;       // fewest rows of K in a slice
constexpr int kMaxSlices = 16;      // the largest cluster Hopper takes (non-portable)
constexpr int kTargetBlocks = 256;  // about two blocks on each of the 132 SMs
constexpr int kBatch = 16;          // x loads in flight together before their first store
constexpr int kStageRows = 128;     // rows of a chunk waited for at once
constexpr int kStages = kChunk / kStageRows;
static_assert(kStages == 2, "cp_async_wait_groups waits for one group of two");

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

// Waits until at most n (0 or 1) of this thread's cp.async groups are in
// flight; the count is an immediate.
__device__ __forceinline__ void cp_async_wait_groups(int n) {
  if (n == 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else
    asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 of rows k, k + 1 and columns c, c + 1, as ldmatrix.trans hands
// them to a lane (bytes: (k, c), (k, c + 1), (k + 1, c), (k + 1, c + 1)), to
// two bf16x2 mma operands: column c and column c + 1, row k in the low half.
// Each byte b becomes the fp32 2^23 + (b + 128) by a byte permute, minus
// 2^23 + 128 in one exact add; an integer of 8 bits has its bf16 in the
// fp32's high half, which a second permute packs. No conversion instruction.
__device__ __forceinline__ void dequant4(uint32_t r, uint32_t& col_c, uint32_t& col_c1) {
  const uint32_t u = r ^ 0x80808080u;  // each byte + 128, as unsigned
  const float kBias = 8388736.f;       // 2^23 + 128
  const uint32_t k0c0 = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kBias);
  const uint32_t k0c1 = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kBias);
  const uint32_t k1c0 = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kBias);
  const uint32_t k1c1 = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kBias);
  col_c = __byte_perm(k0c0, k1c0, 0x7632);
  col_c1 = __byte_perm(k0c1, k1c1, 0x7632);
}

// The A fragment of x_s columns k .. k + 15 and the B fragment (raw int8) of
// q_s rows k .. k + 15, from the lane's row addresses (see the kernel).
__device__ __forceinline__ void load_fragments(unsigned a_addr, unsigned b_addr, int k,
                                               uint32_t a[4], uint32_t b[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(a_addr + k * (int)sizeof(bf16)));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(b_addr + k * kQStride));
}

// One block: rows m0 .. m0 + 15 of x, columns n0 .. n0 + 63 of q, rows
// k_begin .. k_end - 1 of K (its slice; blockIdx.y, the block's rank in a
// cluster of the tile's S slices).
template <bool kVec, typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, T* __restrict__ out, int M, int K, int N,
                   int slice_rows) {
  __shared__ __align__(16) int8_t q_s[kChunk * kQStride];
  __shared__ __align__(16) bf16 x_s[kBM * kXStride];
  __shared__ float recv_s[kBM * kBN];  // the sums of this block's outputs, from every slice

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int m0 = blockIdx.z * kBM;
  const int x_rows = min(kBM, M - m0);  // rows of x in this tile
  // bf16 x in 16-byte vectors: every slice and chunk starts on one
  const bool x_async = sizeof(T) == 2 && K % 8 == 0 && (uintptr_t)x % 16 == 0;
  const int k_begin = min(K, slice * slice_rows);
  const int k_end = min(K, k_begin + slice_rows);

  // rows of the A tile past M stay zero
  for (int e = threadIdx.x; e < (kBM - x_rows) * kXStride; e += kThreads)
    x_s[x_rows * kXStride + e] = __float2bfloat16_rn(0.f);

  // the sums of the warp's columns 4 tig + {0, 2} (even) and 4 tig + {1, 3}
  // (odd) of its 16, rows gid and gid + 8, in mma accumulator order
  float even[4] = {0.f, 0.f, 0.f, 0.f}, odd[4] = {0.f, 0.f, 0.f, 0.f};

  // A: lane t gives the address of x_s row t % 16, column 8 (t / 16)
  const unsigned a_addr = smem_addr(x_s + (lane % 16) * kXStride + (lane / 16) * 8);
  // B: lane t (< 16) gives the address of q_s row t, the warp's 16 bytes
  const unsigned b_addr = smem_addr(q_s + (lane % 16) * kQStride + warp * 16);

  for (int c0 = k_begin; c0 < k_end; c0 += kChunk) {
    const int rows = min(kChunk, k_end - c0);
    const int width = (rows + 15) / 16 * 16;  // rows of the chunk the mma reads
    __syncthreads();  // the previous chunk is no longer read
    // the chunk in kStages groups of kStageRows rows: all copies in flight
    // at once, each group multiplied as soon as it has landed
#pragma unroll
    for (int g = 0; g < kStages; ++g) {
      const int r0 = g * kStageRows, r1 = min(rows, r0 + kStageRows);
      if (kVec) {
        constexpr int kVecsPerRow = kBN / 16;
        for (int e = threadIdx.x; e < (r1 - r0) * kVecsPerRow; e += kThreads) {
          const int r = r0 + e / kVecsPerRow, v = e % kVecsPerRow;
          const int n = n0 + v * 16;
          const bool in = n < N;  // N is a multiple of 16: a vector is all in or all out
          cp_async16(q_s + r * kQStride + v * 16, in ? q + (int64_t)(c0 + r) * N + n : q,
                     in ? 16 : 0);
        }
      }
      if (x_async) {  // rows is a multiple of 8 here
        const int vecs = max(0, r1 - r0) / 8;
        for (int e = threadIdx.x; e < x_rows * vecs; e += kThreads) {
          const int r = e / vecs, c = r0 + (e - r * vecs) * 8;
          cp_async16(x_s + r * kXStride + c, x + (int64_t)(m0 + r) * K + c0 + c, 16);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
    if (!kVec) {
      for (int e = threadIdx.x; e < rows * kBN; e += kThreads) {
        const int r = e / kBN, c = e - r * kBN;
        q_s[r * kQStride + c] = n0 + c < N ? q[(int64_t)(c0 + r) * N + n0 + c] : (int8_t)0;
      }
    }
    if (x_async) {  // the columns past the chunk's rows
      for (int e = threadIdx.x; e < x_rows * (width - rows); e += kThreads) {
        const int r = e / (width - rows);
        x_s[r * kXStride + rows + e - r * (width - rows)] = __float2bfloat16_rn(0.f);
      }
    } else {
      // x rounded to bf16 (fp32 x, or bf16 not in 16-byte vectors), zero past
      // the chunk's rows: a batch of loads in flight before its first store
      const int n_x = x_rows * width;
      for (int e0 = threadIdx.x; e0 < n_x; e0 += kBatch * kThreads) {
        bf16 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads, r = e / width, c = e - r * width;
          v[u] = e < n_x && c < rows ? to_bf16(x[(int64_t)(m0 + r) * K + c0 + c])
                                     : __float2bfloat16_rn(0.f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads, r = e / width;
          if (e < n_x) x_s[r * kXStride + e - r * width] = v[u];
        }
      }
    }
    // q rows past `rows` in the last 16-row step are read: zero them
    for (int e = threadIdx.x; e < (width - rows) * kBN; e += kThreads)
      q_s[(rows + e / kBN) * kQStride + e % kBN] = 0;

#pragma unroll
    for (int g = 0; g < kStages; ++g) {
      if (g * kStageRows >= width) break;  // the groups left are empty
      cp_async_wait_groups(kStages - 1 - g);  // group g has landed
      __syncthreads();
      const int k_stop = min(width, (g + 1) * kStageRows);
      // the next step's fragments load while this step's multiply
      uint32_t a[4], b[2];
      load_fragments(a_addr, b_addr, g * kStageRows, a, b);
#pragma unroll
      for (int k = g * kStageRows; k < k_stop; k += 16) {
        uint32_t a_next[4], b_next[2];
        if (k + 16 < k_stop) load_fragments(a_addr, b_addr, k + 16, a_next, b_next);
        uint32_t b_even[2], b_odd[2];
        dequant4(b[0], b_even[0], b_odd[0]);  // rows k + 2 tig, + 1
        dequant4(b[1], b_even[1], b_odd[1]);  // rows k + 8 + 2 tig, + 1
        mma_bf16(even, a, b_even[0], b_even[1]);
        mma_bf16(odd, a, b_odd[0], b_odd[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_next[i];
        b[0] = b_next[0];
        b[1] = b_next[1];
      }
    }
  }

  // lane (gid, tig) holds columns 4 tig .. 4 tig + 3 of the warp's 16, rows
  // gid and gid + 8
  const int col = warp * 16 + 4 * tig;
  const float lo[4] = {even[0], odd[0], even[1], odd[1]};
  const float hi[4] = {even[2], odd[2], even[3], odd[3]};
  if (slices == 1) {  // the whole sum: scale, cast, store
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + col + i;
      if (n >= N) continue;
      if (m0 + gid < M) store(out + (int64_t)(m0 + gid) * N + n, __fmul_rn(lo[i], s[n]));
      if (m0 + gid + 8 < M) store(out + (int64_t)(m0 + gid + 8) * N + n, __fmul_rn(hi[i], s[n]));
    }
    return;
  }
  // the tile's S slices form one cluster. Output e of the tile (row-major
  // [16, 64]) belongs to block e % S: each block stores its sum of e into
  // that block's recv_s[slice][e / S] (distributed shared memory), and after
  // one cluster barrier each block adds its outputs' S sums in slice order
  cg::cluster_group cluster = cg::this_cluster();
  const int share = kBM * kBN / slices;  // outputs per block
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = gid + 8 * h;
    if (row >= x_rows) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = row * kBN + col + i;
      *cluster.map_shared_rank(recv_s + slice * share + e / slices, e % slices) =
          h ? hi[i] : lo[i];
    }
  }
  cluster.sync();
  for (int t = threadIdx.x; t < share; t += kThreads) {
    const int e = t * slices + slice, row = e / kBN, n = n0 + e % kBN;
    if (row >= x_rows || n >= N) continue;
    float sum = recv_s[t];
    for (int i = 1; i < slices; ++i) sum = __fadd_rn(sum, recv_s[i * share + t]);
    store(out + (int64_t)(m0 + row) * N + n, __fmul_rn(sum, s[n]));
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// S, the slices of K: the least power of two that gives kTargetBlocks blocks,
// at most kMaxSlices (the cluster), with slices of at least kMinSlice rows
int slices_for(int M, int K, int N) {
  const int tiles = ceil_div(N, kBN) * ceil_div(M, kBM);
  int slices = 1;
  while (slices < kMaxSlices && tiles * slices < kTargetBlocks && (slices * 2) * kMinSlice <= K)
    slices *= 2;
  return slices;
}

template <bool kVec, typename T>
cudaError_t launch(const T* x, const int8_t* q, const float* s, T* out, int M, int K, int N,
                   cudaStream_t stream) {
  // clusters of more than 8 blocks must be allowed, once per kernel
  static const cudaError_t allowed = cudaFuncSetAttribute(
      int8_matmul_kernel<kVec, T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (allowed != cudaSuccess) return allowed;
  const int slices = slices_for(M, K, N);
  const int slice_rows = ceil_div(ceil_div(K, slices), 16) * 16;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ceil_div(N, kBN), slices, ceil_div(M, kBM));
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = slices;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, int8_matmul_kernel<kVec, T>, x, q, s, out, M, K, N,
                            slice_rows);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* q, const void* s, void* out, int M, int K, int N,
                     cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(s);
  T* ot = static_cast<T*>(out);
  if (N % 16 == 0 && (uintptr_t)q % 16 == 0)
    return launch<true, T>(xt, qt, st, ot, M, K, N, stream);
  return launch<false, T>(xt, qt, st, ot, M, K, N, stream);
}

}  // namespace

// S, the slices of K (and the cluster size) of an (M, K, N) product; 0 for
// an empty shape. The grid is (N / 64 column tiles, S, M / 16 row tiles).
extern "C" int blurr_int8_matmul_slices(int M, int K, int N) {
  if (M <= 0 || K <= 0 || N <= 0) return 0;
  return slices_for(M, K, N);
}

// x [M, K] (fp32 when x_bf16 is 0, bf16 otherwise), q int8 [K, N], s fp32
// [N], out [M, N] of x's type, all contiguous. Launches the kernel on
// `stream`; returns its cudaError_t.
extern "C" int blurr_int8_matmul(const void* x, const void* q, const void* s, void* out, int M,
                                 int K, int N, int x_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return (int)dispatch<bf16>(x, q, s, out, M, K, N, st);
  return (int)dispatch<float>(x, q, s, out, M, K, N, st);
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
