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
// scale is fp32 [G, NB*BN]; out is fp32 [M, NB*BN]. Each group's dot is exact
// in int32 (at most 128 * 8 * K/G in magnitude), in any order of its terms;
// the fp32 epilogue is not order-free, so one thread per output converts each
// group's whole dot (__int2float_rn), scales it (__fmul_rn) and adds the
// terms in group order (__fadd_rn, no FMA): the result equals the plain
// version bit for bit, and every call gives the same bits.
//
// What bounds it on the H100: at the Pi-0 w4a8 shapes the weight is up to
// 17 MB (the vlm gate, 2048 x 16896 int4), 5 us at 3.35 TB/s, and M is 96
// (the vlm prefill) or 1 and 4 (the action mixture). At M 96 the products,
// 2 M K N = 6.6 G operations at the gate, take as long again at the int8
// tensor-core peak and more through mma.sync; at M 1 and 4 the weight is
// 0.5-2 MB and a launch is bound by latency. The design:
// - Tensor cores. mma.sync m16n8k32 s8 x s8 -> s32. A is x, staged in shared
//   memory and read by ldmatrix.x4. B is the packed weight: ldmatrix.trans
//   gives each lane 32-bit words of packed rows 2t, 2t + 1 by columns 2g,
//   2g + 1 (t = lane % 4, g = lane / 4), that is K rows 4t .. 4t + 3 of both
//   columns. unpack() sign-extends the low and the high nibble of every byte
//   of a word (((v ^ 8) + 0x78) ^ 0x80 bytewise, no carry between bytes) and
//   one byte permute each interleaves them into the k order of the even
//   column's and the odd column's B fragment: one mma for the even columns,
//   one for the odd. The bytes in memory keep the JAX layout.
// - Tiles (Tile). Up to 64 rows of x: 4 warps, 64 columns, each warp all the
//   rows by 16 columns. Above 64 rows: 8 warps, 96 rows by 128 columns, each
//   warp 48 rows by 32 columns, so at M 96 the weight is read from device
//   memory once and each unpacked fragment feeds 3 mma. Rows past M are
//   computed and not stored.
// - Split K, exactly. The grid is (column tiles) x (S slices of K) x (row
//   blocks). A slice is either whole groups (S divides G: G / S groups each)
//   or a part of one group (S = G P: part p of group s / P, ceil(K/G / P)
//   rows rounded up to 32; the last parts may be short or empty). S is the
//   least that fills the card (2 blocks to an SM for the 4-warp tiles, 1 for
//   the 8-warp one), at most 16, with slices of at least 64 rows and the
//   partial dots within 96 KB of shared memory (blurr_int4_matmul_grid):
//   132 x 1 at the vlm gate (96, 2048, 16896, G 4), 16 x 16 at the vlm down
//   projection (96, 16384, 2048, G 32: two groups a slice) and at
//   (96, 2048, 2048, G 4), 66 x 4 at (4, 1024, 4224, G 2).
// - Loads. A slice is walked in chunks of 256 rows of K that never straddle
//   a group, two stages deep: while one chunk is multiplied the next one's
//   16-byte cp.async are in flight. Each thread copies a fixed 16 columns of
//   the packed weight (its column pointer found once: an integer division
//   per copy, in the first form, cost more than the copies) and a fixed 16
//   bytes of x's rows. cp.async zero-fills x past a group's rows,
//   so a K/G that is not a multiple of 32 multiplies zeros there; where K or
//   K/G is not a multiple of 16, x is staged byte by byte. Staged rows are
//   80 or 144 (weight) and 272 (x) bytes apart: ldmatrix reads without bank
//   conflicts.
// - Add across blocks. Where S is 1 the block runs the group epilogue in
//   registers as each group ends. Otherwise the tile's S slice-blocks are
//   one thread block cluster (16 needs the non-portable size): the tile's
//   columns are cut into S runs, block s owns run s, and each block stores
//   its int32 partial dots of each run, four columns to a 16-byte store,
//   into the owner's shared memory (distributed shared memory; the first
//   form's scattered 4-byte stores were slower). The owner has meanwhile
//   staged its run's scales in shared memory. After one cluster barrier
//   each block adds the parts of each group (int32, exact) and runs the
//   group epilogue in order. No atomics, no workspace, one launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 256;             // rows of K staged at once
constexpr int kStages = 2;              // chunks in the ring
constexpr int kXStride = kChunk + 16;   // bytes per staged x row (bank spread)
constexpr int kMinSlice = 64;           // fewest rows of K in a slice
constexpr int kMaxSlices = 16;          // the largest cluster Hopper takes (non-portable)
constexpr int kSMs = 132;
constexpr int kRecvBytes = 96 * 1024;   // most shared memory for the partial dots
constexpr int kMaxSmemBytes = 227 * 1024;  // the most a block can have

// A block's tile: 4 WR warps, WR rows of 4; each warp owns TM row tiles of
// 16 and NP pairs of 8-column mma tiles (16 NP columns).
template <int TM, int WR, int NP>
struct Tile {
  static constexpr int kThreads = 128 * WR;
  static constexpr int kRows = 16 * TM * WR;     // rows of x
  static constexpr int kCols = 64 * NP;          // columns of the weight
  static constexpr int kWStride = kCols + 16;    // bytes per staged packed row (bank spread)
  static constexpr int kWStage = kChunk / 2 * kWStride;
  static constexpr int kStage = kWStage + kRows * kXStride;
  static constexpr int kBlocksPerSM = WR == 1 ? 2 : 1;  // by registers and shared memory
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem to smem; the bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::);
}

__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::); }

__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Each byte's nibble v (0 .. 15, in the low four bits) as the signed byte it
// encodes: ((v ^ 8) + 0x78) ^ 0x80; (v ^ 8) + 0x78 stays below 0x100, so no
// carry crosses a byte.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return ((v ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}

// The word ldmatrix.trans hands a lane, bytes (packed row 2t, column c),
// (2t, c + 1), (2t + 1, c), (2t + 1, c + 1), to the B fragments of column c
// (even) and c + 1 (odd): K rows 4t .. 4t + 3, the lowest in byte 0.
__device__ __forceinline__ void unpack(uint32_t r, uint32_t& even, uint32_t& odd) {
  const uint32_t lo = sext_nibbles(r & 0x0F0F0F0Fu);         // rows 4t, 4t + 2
  const uint32_t hi = sext_nibbles((r >> 4) & 0x0F0F0F0Fu);  // rows 4t + 1, 4t + 3
  even = __byte_perm(lo, hi, 0x6240);
  odd = __byte_perm(lo, hi, 0x7351);
}

struct Args {
  const int8_t* x;
  const uint8_t* packed;
  const float* scale;
  float* out;
  int M, K, N, BN, groups;
  int gps;         // groups per slice (whole-group slices), else 1
  int parts;       // P: parts of a group (part slices), else 1
  int part_rows;   // rows of a part (a multiple of 32), or K/G
  bool x_vec;      // x staged by 16-byte cp.async
};

// One block: columns n0 .. n0 + kCols - 1, rows m0 .. m0 + kRows - 1, slice
// blockIdx.y of K; its rank in the cluster of the tile's S slices is the
// slice.
template <int TM, int WR, int NP>
__global__ void __launch_bounds__(128 * WR)
int4_matmul_kernel(const Args args) {
  using T = Tile<TM, WR, NP>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int M = args.M, K = args.K, N = args.N, BN = args.BN, groups = args.groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp / 4, wc = warp % 4;
  const int n0 = blockIdx.x * T::kCols;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int m0 = blockIdx.z * T::kRows;
  const int x_rows = min(T::kRows, M - m0);
  const int group_rows = K / groups;
  const int K2 = K / 2;
  if (slices > 1) cluster_arrive_relaxed();  // waited for before the first remote store

  // this block's segments: gps whole groups from g0, or one part of a group
  int g0, seg_start, seg_len;
  if (args.parts > 1) {
    g0 = slice / args.parts;
    const int p = slice % args.parts;
    seg_start = g0 * group_rows + p * args.part_rows;
    seg_len = max(0, min(args.part_rows, group_rows - p * args.part_rows));
  } else {
    g0 = slice * args.gps;
    seg_start = g0 * group_rows;
    seg_len = group_rows;
  }
  const int nseg = args.parts > 1 ? 1 : args.gps;
  const int chunks_per_seg = (seg_len + kChunk - 1) / kChunk;
  const int total = nseg * chunks_per_seg;

  // a walk over the chunks in order (chunk w of segment j), so that no
  // division is needed: a chunk's first row of K and its rows, both even
  struct Walk {
    int j = 0, w = 0;
  };
  auto start_of = [&](const Walk& at) { return seg_start + at.j * group_rows + at.w * kChunk; };
  auto len_of = [&](const Walk& at) { return min(kChunk, seg_len - at.w * kChunk); };
  auto advance = [&](Walk& at) {
    if (++at.w == chunks_per_seg) {
      at.w = 0;
      ++at.j;
    }
  };

  // each thread's fixed share of a chunk's copies: weight vector wv of packed
  // rows wr0, wr0 + kWStep, ...; x vector xv of rows xr0, xr0 + kXStep, ...
  constexpr int kVecs = T::kCols / 16, kWStep = T::kThreads / kVecs;
  constexpr int kXVecs = kChunk / 16, kXStep = T::kThreads / kXVecs;
  const int wv = threadIdx.x % kVecs, wr0 = threadIdx.x / kVecs;
  const int xv = threadIdx.x % kXVecs, xr0 = threadIdx.x / kXVecs;
  const int wn = n0 + wv * 16;  // a vector lies in one block of BN columns
  const uint8_t* w_col =
      wn < N ? args.packed + (int64_t)(wn / BN) * K2 * BN + wn % BN : nullptr;

  Walk issued;
  auto issue = [&](int c) {
    if (c < total) {
      uint8_t* w_s = smem + (c % kStages) * T::kStage;
      int8_t* x_s = reinterpret_cast<int8_t*>(w_s + T::kWStage);
      const int start = start_of(issued), len = len_of(issued);
      advance(issued);
      if (w_col)
        for (int r = wr0; r < len / 2; r += kWStep)
          cp_async16(w_s + r * T::kWStride + wv * 16, w_col + (int64_t)(start / 2 + r) * BN, 16);
      const int width = (len + 31) / 32 * 32;  // columns the mma reads
      if (args.x_vec) {
        const int bytes = max(0, min(16, len - xv * 16));
        if (xv * 16 < width)
          for (int r = xr0; r < x_rows; r += kXStep)
            cp_async16(x_s + r * kXStride + xv * 16,
                       args.x + (int64_t)(m0 + r) * K + start + (bytes ? xv * 16 : 0), bytes);
      } else {
        for (int e = threadIdx.x; e < x_rows * kChunk; e += T::kThreads) {
          const int r = e / kChunk, k = e % kChunk;
          if (k < width)
            x_s[r * kXStride + k] = k < len ? args.x[(int64_t)(m0 + r) * K + start + k] : (int8_t)0;
        }
      }
    }
    cp_async_commit();  // possibly empty: keeps one group per chunk
  };

  // dots[t][2 p + o][v]: mma accumulators of row tile t, column pair p,
  // even (o = 0) or odd (o = 1) columns; dot(t, p, h, i) is the int32 dot of
  // row row_of(t, h) and column col_of(p) + i
  int dots[TM][2 * NP][4];
  float acc[TM][NP][2][4];
  auto zero_dots = [&]() {
#pragma unroll
    for (int t = 0; t < TM; ++t)
#pragma unroll
      for (int q = 0; q < 2 * NP; ++q)
#pragma unroll
        for (int v = 0; v < 4; ++v) dots[t][q][v] = 0;
  };
  zero_dots();
  auto dot = [&](int t, int p, int h, int i) { return dots[t][2 * p + (i & 1)][2 * h + i / 2]; };
  auto row_of = [&](int t, int h) { return wr * 16 * TM + 16 * t + gid + 8 * h; };
  auto col_of = [&](int p) { return wc * 16 * NP + 16 * p + 4 * tig; };

  // where S > 1: the tile's columns are cut into S runs of cpo; block s owns
  // run s, recv[(g P + p) share + r cpo + c] holds the partial dot of group
  // g, part p, at row r, column c of its run, and scale_s[g cpo + c] its scale
  const int cpo = T::kCols / slices, cpo_shift = __ffs(cpo) - 1;  // S is a power of two
  const int share = T::kRows * cpo;
  const int nc0 = n0 + slice * cpo;
  int* recv = reinterpret_cast<int*>(smem + kStages * T::kStage);
  float* scale_s = reinterpret_cast<float*>(recv + groups * args.parts * share);
  cg::cluster_group cluster = cg::this_cluster();
  bool joined = false;

  // the end of segment j (group g0 + j): the epilogue in registers (S = 1)
  // or the partial dots to their owners, four columns to a 16-byte store
  auto finish_segment = [&](int j) {
    if (slices == 1) {
      const int g = g0 + j;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + col_of(p) + i;
          const float s = n < N ? args.scale[(int64_t)g * N + n] : 0.f;
#pragma unroll
          for (int t = 0; t < TM; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float term = __fmul_rn(__int2float_rn(dot(t, p, h, i)), s);
              acc[t][p][h][i] = g == 0 ? term : __fadd_rn(acc[t][p][h][i], term);
            }
        }
    } else {
      if (!joined) {
        cluster_wait();  // every block of the cluster has started
        joined = true;
      }
      int* base = recv + (args.parts > 1 ? slice : g0 + j) * share;
#pragma unroll
      for (int t = 0; t < TM; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row_of(t, h);
          if (r >= x_rows) continue;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const int c = col_of(p);
            const int4 v = make_int4(dot(t, p, h, 0), dot(t, p, h, 1), dot(t, p, h, 2),
                                     dot(t, p, h, 3));
            *reinterpret_cast<int4*>(
                cluster.map_shared_rank(base + r * cpo + (c & (cpo - 1)), c >> cpo_shift)) = v;
          }
        }
    }
    zero_dots();
  };

  // A: lane l gives the address of x row 16 t + l % 16 (of the warp's
  // rows), bytes 16 (l / 16); B: lane l the address of packed row l % 16,
  // the warp's columns 16 (l / 16) onwards (lanes 16 .. 31 unused where NP is 1)
  const int a_off = (wr * 16 * TM + lane % 16) * kXStride + (lane / 16) * 16;
  const int b_off = (lane % 16) * T::kWStride + wc * 16 * NP + (lane / 16) * 16;

  Walk done;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  if (slices > 1)  // the owned run's scales, while the first chunks load
    for (int e = threadIdx.x; e < groups * cpo; e += T::kThreads) {
      const int n = nc0 + (e & (cpo - 1));
      scale_s[e] = n < N ? args.scale[(int64_t)(e >> cpo_shift) * N + n] : 0.f;
    }
  for (int c = 0; c < total; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();               // for every thread; chunk c - 1 is no longer read
    issue(c + kStages - 1);
    const uint8_t* w_s = smem + (c % kStages) * T::kStage;
    const unsigned a_base = smem_addr(w_s + T::kWStage + a_off);
    const unsigned b_base = smem_addr(w_s + b_off);
    const int len = len_of(done);
#pragma unroll
    for (int k = 0; k < kChunk; k += 32) {
      if (k >= len) break;
      uint32_t b[2 * NP], b_even[NP][2], b_odd[NP][2];
      if constexpr (NP == 1)
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b[0]), "=r"(b[1])
                     : "r"(b_base + (k / 2) * T::kWStride));
      else
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                     : "r"(b_base + (k / 2) * T::kWStride));
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        unpack(b[2 * p], b_even[p][0], b_odd[p][0]);          // K rows k + 4 tig .. + 3
        unpack(b[2 * p + 1], b_even[p][1], b_odd[p][1]);      // K rows k + 16 + 4 tig .. + 3
      }
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        uint32_t a[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                     : "r"(a_base + t * 16 * kXStride + k));
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          mma_s8(dots[t][2 * p], a, b_even[p][0], b_even[p][1]);
          mma_s8(dots[t][2 * p + 1], a, b_odd[p][0], b_odd[p][1]);
        }
      }
    }
    if (done.w == chunks_per_seg - 1) finish_segment(done.j);
    advance(done);
  }
  cp_async_wait<0>();
  if (total == 0) finish_segment(0);  // an empty part: its partial dots are 0

  if (slices == 1) {  // four adjacent columns to a 16-byte store (N is a multiple of 16)
#pragma unroll
    for (int t = 0; t < TM; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row_of(t, h);
        if (r >= x_rows) continue;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int n = n0 + col_of(p);
          if (n < N)
            *reinterpret_cast<float4*>(args.out + (int64_t)(m0 + r) * N + n) =
                make_float4(acc[t][p][h][0], acc[t][p][h][1], acc[t][p][h][2], acc[t][p][h][3]);
        }
      }
    return;
  }
  cluster.sync();  // every partial dot and scale has been stored
  // the owned run, all in shared memory: each output's group dots (their
  // parts added, exact), then the epilogue in group order
  for (int u = threadIdx.x; u < x_rows * cpo; u += T::kThreads) {
    const int r = u >> cpo_shift, c = u & (cpo - 1);
    if (nc0 + c >= N) continue;
    const int* mine = recv + u;
    float sum = 0.f;
#pragma unroll 4
    for (int g = 0; g < groups; ++g) {
      int d = 0;
      for (int p = 0; p < args.parts; ++p) d += mine[(g * args.parts + p) * share];
      const float term = __fmul_rn(__int2float_rn(d), scale_s[g * cpo + c]);
      sum = g == 0 ? term : __fadd_rn(sum, term);
    }
    args.out[(int64_t)(m0 + r) * N + nc0 + c] = sum;
  }
}

// The tile of an M: (TM, WR, NP) = (1, 1, 1), (2, 1, 1), (4, 1, 1) up to
// 16, 32, 64 rows (64 columns, 4 warps); (3, 2, 2) above (96 rows by 128
// columns, 8 warps).
int tile_kind(int M) { return M <= 16 ? 0 : M <= 32 ? 1 : M <= 64 ? 2 : 3; }

template <typename F>
auto with_tile(int M, F f) {
  switch (tile_kind(M)) {
    case 0: return f(Tile<1, 1, 1>{});
    case 1: return f(Tile<2, 1, 1>{});
    case 2: return f(Tile<4, 1, 1>{});
    default: return f(Tile<3, 2, 2>{});
  }
}

struct Split {
  int slices, gps, parts, part_rows;
};

// S, the slices of K: the least S in 1, 2, 4, 8, 16 that fills the card
// (kBlocksPerSM blocks on each SM), else the largest that is allowed. S is
// allowed where it divides G into whole groups of at least kMinSlice rows
// whose partial dots fit kRecvBytes, or where it is G P with parts of at
// least kMinSlice rows.
template <typename T>
Split split_for(T, int M, int K, int N, int groups) {
  const int tiles = ceil_div(N, T::kCols) * ceil_div(M, T::kRows);
  const int group_rows = K / groups;
  const int tile_bytes = T::kRows * T::kCols * 4;  // one int32 per output of the tile
  Split best = {1, groups, 1, group_rows};
  for (int s = 2; s <= kMaxSlices; s *= 2) {
    if (tiles * best.slices >= kSMs * T::kBlocksPerSM) break;
    if (groups % s == 0) {
      const int gps = groups / s;
      if (gps * group_rows >= kMinSlice && gps * tile_bytes <= kRecvBytes)
        best = {s, gps, 1, group_rows};
    } else if (s % groups == 0) {
      const int parts = s / groups;
      if (group_rows / parts >= kMinSlice)
        best = {s, 1, parts, ceil_div(ceil_div(group_rows, parts), 32) * 32};
    }
  }
  return best;
}

template <typename T>
int smem_bytes(const Split& sp) {
  const int groups = sp.parts > 1 ? sp.slices / sp.parts : sp.gps * sp.slices;
  const int cpo = T::kCols / sp.slices;
  const int recv = sp.slices > 1 ? (sp.slices * sp.gps * T::kRows + groups) * cpo * 4 : 0;
  return kStages * T::kStage + recv;
}

template <int TM, int WR, int NP>
cudaError_t launch(Tile<TM, WR, NP> tile, Args args, cudaStream_t stream) {
  using T = Tile<TM, WR, NP>;
  auto kernel = int4_matmul_kernel<TM, WR, NP>;
  // clusters of more than 8 blocks and more than 48 KB of shared memory must
  // be allowed, once per kernel
  static const cudaError_t allowed = [&] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxSmemBytes);
  }();
  if (allowed != cudaSuccess) return allowed;
  const Split sp = split_for(tile, args.M, args.K, args.N, args.groups);
  args.gps = sp.gps;
  args.parts = sp.parts;
  args.part_rows = sp.part_rows;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ceil_div(args.N, T::kCols), sp.slices, ceil_div(args.M, T::kRows));
  config.blockDim = dim3(T::kThreads);
  config.dynamicSmemBytes = smem_bytes<T>(sp);
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = sp.slices;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args);
}

bool valid(int M, int K, int N, int BN, int groups) {
  return M > 0 && K > 0 && N > 0 && BN > 0 && groups > 0 && K % 2 == 0 && K % groups == 0 &&
         (K / groups) % 2 == 0 && BN % 16 == 0 && N % BN == 0;
}

}  // namespace

// The grid of an (M, K, N, G) product into grid[0..2]: (column tiles, S
// slices of K, row blocks); S is also the cluster size. Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int blurr_int4_matmul_grid(int M, int K, int N, int groups, int* grid) {
  if (!valid(M, K, N, 16, groups)) return (int)cudaErrorInvalidValue;
  return with_tile(M, [&](auto tile) {
    using T = decltype(tile);
    grid[0] = ceil_div(N, T::kCols);
    grid[1] = split_for(tile, M, K, N, groups).slices;
    grid[2] = ceil_div(M, T::kRows);
    return 0;
  });
}

// x int8 [M, K], packed int8 [N/BN, K/2, BN], scale fp32 [groups, N], out fp32
// [M, N], all contiguous; K/groups even, BN a multiple of 16, packed and out
// 16-byte aligned (16-byte loads and stores). Launches the kernel on
// `stream`; returns its cudaError_t.
extern "C" int blurr_int4_matmul(const void* x, const void* packed, const void* scale,
                                 void* out, int M, int K, int N, int BN, int groups,
                                 void* stream) {
  if (!valid(M, K, N, BN, groups)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)packed % 16 || (uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  const int group_rows = K / groups;
  const Args args = {static_cast<const int8_t*>(x), static_cast<const uint8_t*>(packed),
                     static_cast<const float*>(scale), static_cast<float*>(out),
                     M, K, N, BN, groups, 0, 0, 0,
                     K % 16 == 0 && group_rows % 16 == 0 && (uintptr_t)x % 16 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_tile(M, [&](auto tile) { return launch(tile, args, s); });
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
