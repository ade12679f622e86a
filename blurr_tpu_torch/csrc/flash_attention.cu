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
//
// fp32 (the baseline preset's naive step, 180 launches a control step at
// [1,8,281,256]; the fp32 prefix-cache prefill; a batched baseline server
// at [b,8,281,256]; every fp32 check against the CPU): the bf16 kernel's
// fold into 64-row tiles of 8 warps, cp.async ring and cluster merge, with
// both products in 3xTF32 on the tensor cores and P kept in fp32, as the
// TPU kernel keeps it. (It replaced the first port's CUDA-core kernel, one
// block per query head and 16 queries, 0.1402 ms at [1,8,281,256].)
// - Products: mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32. Each fp32
//   fragment is split in registers as it is loaded from shared memory:
//   hi = tf32(x), lo = tf32(x - hi), tf32 rounding as cvt.rna does (ties
//   away) by two integer operations on the bit pattern (with cvt.rna the
//   kernel takes 11-12% longer). The sum takes lo hi, hi lo and hi hi and
//   drops lo lo (below 2^-22 of a product); for S the hi hi sums apart
//   from the small ones. That holds the output within 1e-5 of the plain
//   fp32 version (2.9e-6 with logits of std 1, 4.8e-6 with the small
//   products in the hi hi accumulator); one TF32 product reads 8e-5 at the
//   test scale and 6e-4 with logits of std 1 on the card
//   (tests/test_torch_flash_attention.py mirrors both). Nothing is stored
//   split.
// - S: the two warps of a row group split the head dim, not the keys: warp
//   w sums columns h D / 2 .. + D / 2 - 1 (h = w / 4) for all 32 keys of the
//   tile (4 n8 tiles), so each split of a Q fragment feeds 4 n8 tiles. The
//   two swap the sums of each other's 16 keys through shared memory, and
//   each adds, scales, clamps and masks its own keys and swaps those
//   logits, so the clamp runs once a logit. P V as in bf16: warp w takes
//   the same D / 2 columns of O (D / 4 registers a thread) over all keys.
//   P's A fragment is S's C fragment: its columns tig and tig + 4 stand for
//   keys 2 tig and 2 tig + 1 of the k8 step, and V's B fragment is read at
//   those keys.
// - Loads: 16-byte cp.async of Q and of 32-key K and V tiles into a ring
//   of two stages (199,680 bytes with Q at head_dim 256; the merge reuses
//   them). Rows are padded by 4 floats, so the 32 lanes of each fragment
//   load hit 32 distinct banks. The mask comes a tile ahead as one
//   coalesced 32-byte load a row, made into a word of bits by a ballot.
// - Numerics: m, l and the merge weights in the natural base (expf), the
//   clamp tanh(z / softclamp) softclamp with a branch-free tanh (an odd
//   polynomial below 0.55, 1 - 2 / (e^2y + 1) above). The clamp costs
//   2-4% of the kernel's time; with tanhf and a division the kernel takes
//   5-6% longer.
// - The key split: the bf16 kernel's parts and merge, the number of parts
//   chosen to minimize waves of one block an SM times a block's tiles (at
//   [1,8,281,256] 36 tiles x 3 parts of 94 keys; at [4,8,281,256] 3 parts
//   too, 432 blocks, where one part ran 144 blocks in two waves of 9 tiles).
// - What bounds it on the H100: at [1,8,281,256], 4 x 8 x 281^2 x 256 =
//   0.647 GFLOP at 165 TFLOP/s (the 495 TFLOP/s of TF32 over the three
//   products) is 0.0039 ms; its 5.3 MB at 3.35 TB/s 0.0016 ms, so
//   operations bound it. Measured in a CUDA graph (chip_smoke.py, NVIDIA
//   H100 80GB HBM3, 700.00 W): 0.029 ms at [1,8,281,256] (13% of the
//   bound; plain version 0.053, SDPA fp32 0.065), 0.111 ms at
//   [4,8,281,256] (plain 0.133). Half of the time is the three products
//   (without any mma it takes 0.015 / 0.056 ms; one product 0.021 /
//   0.077); the rest is latency that 8 warps an SM do not hide (loading Q
//   and a block's K/V, about 250 KB a block from L2, the swaps and the
//   merge). The variants are timed by scripts/ablate_flash_fp32_torch.py.
//   wgmma and K/V shared in a cluster by TMA multicast are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

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

// fp32: the bf16 kernel's fold and cluster merge, with both products in
// 3xTF32 on the tensor cores (the header gives the design).
namespace fp32 {

using tc::ceil_div;
using tc::kMaxParts;
using tc::kRecvRows;
using tc::kRowWarps;
using tc::kRows;
using tc::kThreads;
using tc::kWarps;

constexpr int kKeys = 32;  // keys per staged K/V tile: 4 n8 tiles of S, 4 k8 steps of P V
constexpr int kPad = 4;    // floats of padding per staged row

// The key split: P parts of part_keys keys (the last may hold fewer), at
// most kMaxParts and at most one part per kKeys keys, P the one that
// minimizes the waves of one block per SM times a block's work in tiles
// (its 32-key tiles, and about one more for its loads of Q and its merge);
// the fewest parts on a tie.
tc::Geometry geometry(int B, int NH, int KVH, int Sq, int Skv, int sms) {
  tc::Geometry geo;
  geo.row_tiles = ceil_div(NH / KVH * Sq, kRows);
  const long tiles = (long)geo.row_tiles * B * KVH;
  const int most = std::max(1, std::min(kMaxParts, ceil_div(Skv, kKeys)));
  int parts = 1;
  long least = -1;
  for (int p = 1; p <= most; ++p) {
    const long waves = (tiles * p + sms - 1) / sms;
    const long cost = waves * (1 + ceil_div(ceil_div(Skv, p), kKeys));
    if (least < 0 || cost < least) {
      least = cost;
      parts = p;
    }
  }
  geo.part_keys = ceil_div(Skv, parts);
  geo.parts = ceil_div(Skv, geo.part_keys);  // no part is empty
  return geo;
}

// Floats of the region that holds Q and the two K/V stages during the key
// loop, and after it the part's O [kRows][D + kPad], then the O rows this
// block receives from every part [kRecvRows][D].
template <int D>
__host__ __device__ constexpr size_t region_floats() {
  const size_t loop = (size_t)(kRows + 4 * kKeys) * (D + kPad);
  const size_t merge = (size_t)kRows * (D + kPad) + (size_t)kRecvRows * D;
  return loop > merge ? loop : merge;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // the region; the two exchanges of logits between the warps of a row
  // group [2][kWarps][2 n8 tiles][32 lanes][4]; the mask bits of two tiles
  // [2][kRows]; m, l and 1 / l [kRows]; the received m, l and merge
  // weights [kRecvRows]
  return sizeof(float) * (region_floats<D>() + (size_t)(2 * kWarps * 2 * 32 * 4 + 2 * kRows +
                                                         3 * kRows + 3 * kRecvRows));
}

// x rounded to TF32 (10 mantissa bits, ties away from zero, as
// cvt.rna.tf32.f32 rounds it) with two integer operations: half of the 13
// dropped bits added to the bit pattern, then those bits cleared.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within 2^-22 of x: hi = tf32(x), lo = tf32(x - hi) (the
// difference is exact in fp32).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to about fp32 from the split operands (P V): lo hi and hi lo
// first, then hi hi, into one fp32 accumulator; lo lo (below 2^-22 of the
// product) is dropped.
__device__ __forceinline__ void mma_3xtf32(float d[4], const uint32_t ah[4],
                                           const uint32_t al[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// tanh(y) within a few ulp and without a branch, so the compiler
// interleaves a lane's logits: below |y| = 0.55 the odd polynomial
// |y| + |y|^3 P(y^2) (a least-squares fit, 0.7 ulp in fp32), above it
// 1 - 2 / (e^(2|y|) + 1) (the ulp of expf and __fdividef); the sign of y.
__device__ __forceinline__ float tanh_fp32(float y) {
  const float a = fabsf(y), t = a * a;
  float p = -6.264567840844393e-3f;
  p = fmaf(p, t, 2.106429450213909e-2f);
  p = fmaf(p, t, -5.385034158825874e-2f);
  p = fmaf(p, t, 1.3332565128803253e-1f);
  p = fmaf(p, t, -3.3333316445350647e-1f);
  const float small = fmaf(p * t, a, a);
  const float big = 1.f - __fdividef(2.f, expf(2.f * a) + 1.f);
  return copysignf(a < 0.55f ? small : big, y);
}

// One block: folded rows r0 .. r0 + 63 of group blockIdx.z (= b KVH + kvh),
// keys of part blockIdx.y (its rank in the cluster of the row tile's parts).
// Warp w owns rows 16 (w % 4) .. + 15 and half hk = w / 4. For S it sums
// the head columns hk D / 2 .. + D / 2 - 1 of all 32 keys of the tile; the
// two warps of a row group swap the sums of each other's keys (half hk owns
// keys 16 hk .. + 15), add them, scale, clamp and mask their own keys and
// swap those logits, so both hold the tile's logits, m and l. For P V it
// takes the same columns of O over all keys.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const uint8_t* __restrict__ mask,
                       float* __restrict__ out, int NH, int KVH, int Sq, int Skv,
                       int part_keys, float scale, float softclamp) {
  constexpr int S = D + kPad;            // floats per staged row
  constexpr int kChunks = D / 4;         // 16-byte chunks of a row
  constexpr int kRowStep = kThreads / kChunks;
  constexpr int kStage = 2 * kKeys * S;  // floats of one stage: K rows, then V rows
  constexpr int kSteps = D / 16;         // a half's k8 steps of S and n8 tiles of O
  extern __shared__ __align__(16) float f32_smem[];
  float* q_s = f32_smem;                 // [kRows][S]
  float* kv_s = q_s + kRows * S;         // [2][kStage]
  float* o_s = f32_smem;                 // [kRows][S], after the key loop
  float* recv_s = o_s + kRows * S;       // [kRecvRows][D]
  float* z_s = f32_smem + region_floats<D>();             // [2][kWarps][2][32][4]
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(z_s + 2 * kWarps * 2 * 32 * 4);  // [2][kRows]
  float* m_s = reinterpret_cast<float*>(bits_s + 2 * kRows);  // [kRows]
  float* l_s = m_s + kRows;                // [kRows]
  float* inv_s = l_s + kRows;              // [kRows]
  float* m_recv = inv_s + kRows;           // [kRecvRows]
  float* l_recv = m_recv + kRecvRows;      // [kRecvRows]
  float* w_s = l_recv + kRecvRows;         // [kRecvRows]

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
  const float* q_g = q + head0 * Sq * D;
  float* out_g = out + head0 * Sq * D;
  const float* k_g = k + (int64_t)group * Skv * D;
  const float* v_g = v + (int64_t)group * Skv * D;
  const int kb = part * part_keys;
  const int ke = min(Skv, kb + part_keys);  // keys kb .. ke - 1 are this block's
  const int n_tiles = (ke - kb + kKeys - 1) / kKeys;

  // copies: thread tid moves chunk `ch` of rows crow, crow + kRowStep, ...
  const int ch = tid % kChunks, crow = tid / kChunks;
  auto load_tile = [&](int t, int stage) {
    float* ks = kv_s + stage * kStage;
    float* vs = ks + kKeys * S;
    const int k0 = kb + t * kKeys;
    for (int r = crow; r < kKeys; r += kRowStep) {
      const bool in = k0 + r < ke;  // keys past the part are zero
      const int64_t off = (int64_t)(k0 + r) * D + ch * 4;
      tc::cp_async16(ks + r * S + ch * 4, in ? k_g + off : k_g, in ? 16 : 0);
      tc::cp_async16(vs + r * S + ch * 4, in ? v_g + off : v_g, in ? 16 : 0);
    }
  };

  // The mask as bits: warp w reads the mask rows of tile rows 8 w .. + 7,
  // lane i the byte of key k0 + i (one coalesced load a row), a tile ahead
  // of its use; a ballot makes each row's word (bit i: key k0 + i, 0 past
  // the part), stored in bits_s[stage][row] before the barrier that ends
  // the tile (tile 0's after tile 1's copies are issued, its loads ahead
  // of Q's).
  uint32_t mbytes[8];
  const uint8_t* mrows[8];  // the mask rows of tile rows 8 w .. + 7
#pragma unroll
  for (int i = 0; i < 8; ++i)
    mrows[i] = mask ? mask + ((int64_t)b * Sq + (r0 + 8 * warp + i) % Sq) * Skv : nullptr;
  auto load_mask = [&](int t) {
    const int key = kb + t * kKeys + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) mbytes[i] = key < ke ? mrows[i][key] : 0u;
  };
  auto store_bits = [&](int stage) {
    uint32_t mine = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t word = __ballot_sync(0xffffffffu, mbytes[i] != 0u);
      if (lane == i) mine = word;
    }
    if (lane < 8) bits_s[stage * kRows + 8 * warp + lane] = mine;
  };
  if (mask) load_mask(0);
  for (int r = crow; r < kRows; r += kRowStep) {
    const bool in = r0 + r < rows;  // rows past the group are zero
    tc::cp_async16(q_s + r * S + ch * 4, in ? q_g + (int64_t)(r0 + r) * D + ch * 4 : q_g,
                   in ? 16 : 0);
  }
  load_tile(0, 0);
  tc::cp_async_commit();

  // the thread's rows: ra = 16 row_warp + gid and rb = ra + 8 of the tile
  const int ra = row_warp * 16 + gid, rb = ra + 8;

  // Fragments (m16n8k8, gid = lane / 4, tig = lane % 4). S: A (Q) of the
  // k8 step at column c = hk D / 2 + 8 kk holds rows ra, rb at columns
  // c + tig and c + tig + 4; B (K^T) of n8 tile j holds key 8 j + gid at the
  // same columns. P V: A is P of k8 step u as S's C fragment of n8 tile u
  // gives it, so A's columns tig and tig + 4 stand for keys 8 u + 2 tig and
  // 8 u + 2 tig + 1; B (V) of n8 tile c holds those two keys at column
  // hk D / 2 + 8 c + gid. With rows of D + 4 floats the 32 lanes of every
  // such load hit 32 banks.
  const float* qa = q_s + ra * S + hk * (D / 2) + tig;
  const float* qb = qa + 8 * S;
  const int k_off = gid * S + hk * (D / 2) + tig;
  const int v_off = kKeys * S + 2 * tig * S + hk * (D / 2) + gid;
  // the two swaps: [2 n8 tiles][lane] of this warp's and of its partner's
  float4* sums_mine = reinterpret_cast<float4*>(z_s) + warp * 2 * 32 + lane;
  const float4* sums_theirs =
      reinterpret_cast<const float4*>(z_s) + (warp ^ kRowWarps) * 2 * 32 + lane;
  float4* logits_mine = sums_mine + kWarps * 2 * 32;
  const float4* logits_theirs = sums_theirs + kWarps * 2 * 32;
  const bool clamp = softclamp > 0.f;
  const float inv_clamp = clamp ? 1.f / softclamp : 0.f;

  float o[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = -FLT_MAX, m_b = -FLT_MAX, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const bool next = t + 1 < n_tiles;
    if (next) {
      load_tile(t + 1, stage ^ 1);
      tc::cp_async_commit();
    }
    if (mask) {
      if (t == 0) store_bits(0);
      if (next) load_mask(t + 1);
    }
    if (next)
      tc::cp_async_wait<1>();  // tile t (and Q) has landed
    else
      tc::cp_async_wait<0>();
    __syncthreads();
    const int k0 = kb + t * kKeys;
    const uint32_t bits_a = mask ? bits_s[stage * kRows + ra] : 0xffffffffu;
    const uint32_t bits_b = mask ? bits_s[stage * kRows + rb] : 0xffffffffu;

    // this half's sum of S = Q K^T over the tile's 32 keys (4 n8 tiles);
    // the lane holds rows ra (s[j][0..1]) and rb (s[j][2..3]) at keys
    // 8 j + 2 tig and + 1. hi hi sums apart from lo hi + hi lo (s_lo), added
    // at the end: shorter chains of dependent mma, and less of the small
    // terms lost to the accumulator's rounding (H100, q and k x1.0: 2.9e-6
    // from the plain version against 4.8e-6 in one accumulator)
    const float* ks = kv_s + stage * kStage + k_off;
    float s[4][4], s_lo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s_lo[j][0] = s_lo[j][1] = s_lo[j][2] = s_lo[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t ah[4], al[4];
      split(qa[8 * kk], ah[0], al[0]);
      split(qb[8 * kk], ah[1], al[1]);
      split(qa[8 * kk + 4], ah[2], al[2]);
      split(qb[8 * kk + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split(ks[8 * j * S + 8 * kk], bh0, bl0);
        split(ks[8 * j * S + 8 * kk + 4], bh1, bl1);
        mma_tf32(s_lo[j], al, bh0, bh1);
        mma_tf32(s_lo[j], ah, bl0, bl1);
        mma_tf32(s[j], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s_lo[j][e];
    // Swap the sums: this warp gives its partner the sums of the partner's
    // keys (n8 tiles 2 (1 - hk) + jj) and takes those of its own (2 hk + jj),
    // adds them, scales, clamps and masks them (keys past the part -inf: no
    // part in the max, p 0) and gives them to its partner for the tile's
    // softmax. Each logit is made by one warp; hk picks tiles by selects,
    // so s stays in registers.
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      sums_mine[jj * 32] = hk ? make_float4(s[jj][0], s[jj][1], s[jj][2], s[jj][3])
                              : make_float4(s[2 + jj][0], s[2 + jj][1], s[2 + jj][2], s[2 + jj][3]);
    tc::named_barrier(1 + row_warp, 64);  // the two warps of these rows
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float4 x4 = sums_theirs[jj * 32];
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      float own[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bit = 8 * (2 * hk + jj) + 2 * tig + (e & 1);
        float z = ((hk ? s[2 + jj][e] : s[jj][e]) + x[e]) * scale;
        if (clamp) z = tanh_fp32(z * inv_clamp) * softclamp;
        if (k0 + bit >= ke)
          z = -INFINITY;
        else if (!((e < 2 ? bits_a : bits_b) >> bit & 1u))
          z = -FLT_MAX;
        own[e] = z;
        s[jj][e] = hk ? s[jj][e] : z;
        s[2 + jj][e] = hk ? z : s[2 + jj][e];
      }
      logits_mine[jj * 32] = make_float4(own[0], own[1], own[2], own[3]);
    }
    tc::named_barrier(1 + row_warp, 64);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float4 x4 = logits_theirs[jj * 32];
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[jj][e] = hk ? x[e] : s[jj][e];
        s[2 + jj][e] = hk ? s[2 + jj][e] : x[e];
      }
    }

    float mx_a = -FLT_MAX, mx_b = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    const float mn_a = fmaxf(m_a, tc::quad_max(mx_a)), mn_b = fmaxf(m_b, tc::quad_max(mx_b));
    const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // p in fp32, in place of the logits (l sums the lane's part of each row)
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j][0] = expf(s[j][0] - mn_a);
      s[j][1] = expf(s[j][1] - mn_a);
      s[j][2] = expf(s[j][2] - mn_b);
      s[j][3] = expf(s[j][3] - mn_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = alpha_a * l_a + sum_a;
    l_b = alpha_b * l_b + sum_b;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      o[j][0] *= alpha_a;
      o[j][1] *= alpha_a;
      o[j][2] *= alpha_b;
      o[j][3] *= alpha_b;
    }

    // O += P V over the tile's 4 k8 steps, the warp's D / 16 n8 tiles of columns
    const float* vs = kv_s + stage * kStage + v_off;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t ph[4], pl[4];
      split(s[u][0], ph[0], pl[0]);  // row ra, key 8 u + 2 tig
      split(s[u][2], ph[1], pl[1]);  // row rb, key 8 u + 2 tig
      split(s[u][1], ph[2], pl[2]);  // row ra, key 8 u + 2 tig + 1
      split(s[u][3], ph[3], pl[3]);  // row rb, key 8 u + 2 tig + 1
#pragma unroll
      for (int c = 0; c < kSteps; ++c) {
        uint32_t bh0, bl0, bh1, bl1;
        split(vs[8 * u * S + 8 * c], bh0, bl0);
        split(vs[(8 * u + 1) * S + 8 * c], bh1, bl1);
        mma_3xtf32(o[c], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
    if (mask && next) store_bits(stage ^ 1);
    __syncthreads();  // this stage, Q (the last time) and the logits are no longer read
  }
  // this part's O (unnormalized; each warp its rows' half of the columns),
  // m and l (the same in both halves) into shared memory, over Q
  l_a = tc::quad_sum(l_a);
  l_b = tc::quad_sum(l_b);
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
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

  // the parts merge as the bf16 kernel's do: rows lo .. lo + share - 1 of
  // the tile belong to block lo / share; each block stores its rows' O, m
  // and l into their owners' shared memory after a cluster barrier, and
  // after a second one each owner adds the parts in part order.
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
      const float w = expf(m_recv[p * share + i] - m);
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
    *reinterpret_cast<float4*>(out_g + (int64_t)(r0 + lo + i) * D + c) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
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
  const tc::Geometry geo = geometry(B, NH, KVH, Sq, Skv, tc::sm_count());
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
  return cudaLaunchKernelEx(&config, flash_attention_kernel<D>, static_cast<const float*>(q),
                            static_cast<const float*>(k), static_cast<const float*>(v),
                            static_cast<const uint8_t*>(mask), static_cast<float*>(out), NH,
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

static_assert(smem_bytes<256>() <= 232448, "the fp32 kernel's shared memory exceeds 227 KB");

}  // namespace fp32

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
    return (int)fp32::dispatch_head_dim(D, q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale,
                                        softclamp, s);
  if (dtype == 1)
    return (int)tc::dispatch_head_dim(D, q, k, v, mask, out, B, NH, KVH, Sq, Skv, scale,
                                      softclamp, s);
  return (int)cudaErrorInvalidValue;
}

// The launch geometry of a call: grid[0..2] the grid (64-row tiles of the
// folded rows, key parts = cluster size, B KVH) and grid[3] the keys of a
// part; the two kernels choose the number of parts each its own way.
// Returns a cudaError_t.
extern "C" int blurr_flash_attention_grid(int B, int NH, int KVH, int Sq, int Skv, int dtype,
                                          int* grid) {
  if (B <= 0 || NH <= 0 || KVH <= 0 || NH % KVH || Sq <= 0 || Skv <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const tc::Geometry geo = dtype == 0 ? fp32::geometry(B, NH, KVH, Sq, Skv, tc::sm_count())
                                      : tc::geometry(B, NH, KVH, Sq, Skv, tc::sm_count());
  grid[0] = geo.row_tiles;
  grid[1] = geo.parts;
  grid[2] = B * KVH;
  grid[3] = geo.part_keys;
  return 0;
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
