// int4 x int8 matmul over the "split-half" packing, one fp32 scale per
// column, written for Hopper (sm_90a).
//
// Replaces the TPU kernels of the split-half w4a8 experiments:
// experiments/bench_pallas_int4.py:67 pallas_w4 (body _w4_kernel :42),
// experiments/bench_pallas_int4_tune.py:65 make_w4 (body :30),
// experiments/bench_pallas_int4_tune2.py:62 run_shift2 (body _w4_shift2 :32)
// and :94 run_biased (body _w4_biased :50). It computes their function, and
// that of the plain blurr_tpu_torch.ops.int4_split_matmul.int4_split_matmul_reference:
//
//   out[m, n] = __fmul_rn(__int2float_rn(int32 dot of x[m, :] and q[:, n]), scale[n])
//
// x is int8 [M, K]; q is int4 [K, N], packed row-major [K/2, N]: byte [k, n]
// holds q[k, n] in its low nibble and q[k + K/2, n] in its high one. In the
// signed packing a nibble is q in two's complement; in the biased packing it
// is q + 8 (the harness subtracts 8 * rowsum(x) after its dots, which is the
// same integer). scale is fp32 [N]; out is fp32 [M, N]. The dot is exact in
// int32 (|dot| <= 1024 K) in any order of its terms, and is converted (round
// to nearest even, as the plain version's float64 -> float32 cast) and scaled
// once, after the whole sum: the result equals the plain version bit for
// bit, however K is cut and merged.
//
// What bounds it on the H100 (each input read once, the output written once,
// 3.35 TB/s; int8 tensor cores 1,979 TOP/s): at the harness shapes (M, K, N)
// (8, 4096, 11264) 23.5 MB, 7.0 us; (32, 4096, 11264) 24.6 MB, 7.4 us. Both
// are bound by bytes, the 23 MB packed weight; the 0.74 and 2.95 G
// operations take 0.4 and 1.5 us at the int8 peak. The design is K4's
// (csrc/w8a8_matmul.cu) on the packed bytes, with an in-register unpack:
// - The packed weight is a row-major int8 matrix of K/2 rows, byte for byte
//   the B operand K4 reads. Its rows are staged permuted within each 16
//   (staged_row: row 4t + j to staged row 2t + {0, 1, 8, 9}[j]), read by
//   ldmatrix.x4.trans, and __byte_perm 0x6420 / 0x7531 hand lane (g, t) =
//   (lane / 4, lane % 4) a word of packed rows k + 4t .. k + 4t + 3 of column
//   2g (even) or 2g + 1 (odd). Its low nibbles are q rows k + 4t .. + 3 in
//   order, its high nibbles q rows K/2 + k + 4t .. + 3. unpack16 moves each
//   nibble to the top of its byte, (w << 4) & 0xF0F0F0F0 and w & 0xF0F0F0F0
//   (after w ^ 0x88888888 in the biased packing): as int8 that byte is 16 q,
//   exactly. That gives two complete B fragments in 3 or 4 operations a word.
//   Each goes to one mma.sync m16n8k32 s8 x s8 -> s32, with the A fragment
//   of x's low half (columns k ..) or of its high half (columns K/2 + k ..),
//   both staged in shared memory and read by ldmatrix.x4. A chunk's products
//   add into fresh accumulators (at most 2^22 in magnitude), and at its end
//   each is shifted right by 4 (exact: a multiple of 16) into the dot, so the
//   dot is q's for any K. Each packed byte is fetched from memory once and
//   feeds two products.
// - Loads. K/2 is walked in chunks of 128 packed rows through a ring of
//   cp.async stages; a stage holds the weight chunk and the matching chunk
//   of both x halves. Each thread copies a fixed vector of V bytes of the
//   weight (V = 16 where N and the weight allow it, else 4; the 16-byte
//   copies ask L2 to fetch the whole 128-byte line) on rows r0, r0 + step,
//   ... and a fixed 16 bytes of x's rows of each half; its column pointer is
//   found once, with no division per copy. x past the chunk's rows is
//   zero-filled by cp.async (src_bytes), so a partial 32-row step multiplies
//   zeros; where K/2 or x is not 16-byte aligned (K 38: the high half starts
//   at byte 19), x is staged byte by byte. Staged rows are 80 or 144 bytes
//   apart: ldmatrix reads without bank conflicts.
// - Tiles (Tile), K4's set: up to 16, 32, 64 rows of x, 4 warps, 64
//   columns, each warp all the rows by 16 columns (4, 3 and 3 stages: three
//   blocks share an SM up to 32 rows, two up to 64); up to 96 rows, 8 warps,
//   96 x 128; above, 12 warps, 144 x 128 (3 stages each). The grid is (row
//   blocks, S slices, column tiles) with the row blocks fastest. Rows past M
//   are computed and not stored.
// - Split K, exactly. Where the tiles alone leave the card short of full
//   (2 blocks to an SM for the 4-warp tiles, 1 for the larger ones, within
//   1/16), K/2 is cut into S = 2, 4, 8 or 16 slices of ceil(K/2 / S) packed
//   rows rounded up to 32 (the last may be short or empty), each of at least
//   64 rows. The tile's S slice-blocks are one thread block cluster (16
//   needs the non-portable size): the tile's columns are cut into S runs,
//   block s owns run s. After a cluster barrier each block stores its int32
//   partial dots, four columns to a 16-byte store, into the owner's shared
//   memory over its ring (distributed shared memory); after a second one
//   each block adds the S parts of its run (int32, exact) and runs the
//   epilogue. No atomics, no workspace, one launch. Grids (column tiles x S
//   x row blocks): (8, 4096, 11264) and (32, 4096, 11264) 176 x 2 x 1.
// - Stores. Four adjacent fp32 columns to a 16-byte store, from registers
//   (S = 1) or from the owner's run in shared memory.
// The first form ran __dp4a on the CUDA cores, 64 threads and 256
// columns a block, no split over K (44 blocks at N 11264), 16 four-byte
// __ldg of the weight in flight a thread and x staged a byte at a time with
// a division per byte: 0.2227-0.2266 ms a layer at both shapes. Variants of
// this design on the H100, ms a layer over 4 weights in a CUDA graph at (8,
// 4096, 11264) / (32, 4096, 11264) signed (bench_lowbit_matmul with each
// source in its place, "NVIDIA H100 80GB HBM3, 700.00 W"):
// - the nibbles sign-extended to q bytewise (((v ^ 8) + 0x78) ^ 0x80, 5
//   operations a half), 4 stages at 32 rows: 0.0146-0.0147 / 0.0249-0.0250.
//   At 32 rows a block then took 78 KB, two to an SM: the 352 blocks ran in
//   two waves;
// - 3 stages at 32 rows (three blocks to an SM, one wave): 0.0146-0.0147 /
//   0.0178-0.0179, kept;
// - S from the blocks that fit an SM (3, so S 4): 0.0177-0.0178 /
//   0.0213-0.0214; no split (S 1): 0.0153-0.0155 / 0.0192-0.0193; 3 stages
//   at 16 rows: 0.0145-0.0146 / 0.0179. Not kept;
// - the L2::128B fetch hint on the weight copies: 0.0143-0.0144 / 0.0175,
//   kept; L2::256B: 0.0149 / 0.0183-0.0184, not kept;
// - unpack16 with the chunk's accumulators, in place of the sign extension
//   (the biased packing was ~3% faster than the signed one, which has one
//   more operation a half: the unpack was on the critical path):
//   0.0134-0.0136 / 0.0168-0.0169, kept. Signed and biased now take the
//   same time.
// ptxas spilled 4 bytes in the 16-row tile with 16-byte copies while the x
// copies kept one pointer to the block's first row; x's address is now
// found per copy, as K4 does, and nothing spills.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 128;            // packed rows (of K/2) staged at once
constexpr int kXStride = kChunk + 16;  // bytes per staged x row (bank spread)
constexpr int kMinSlice = 64;          // fewest packed rows in a slice
constexpr int kMaxSlices = 16;         // the largest cluster Hopper takes (non-portable)
constexpr int kSMs = 132;
constexpr int kMaxSmemBytes = 227 * 1024;  // the most a block can have

// A block's tile: 4 WR warps, WR rows of 4; each warp owns TM row tiles of
// 16 and NP column runs of 16 (an even and an odd 8-column mma tile each);
// ST chunks in the ring. A stage is the weight chunk, then x's low half,
// then its high half.
template <int TM, int WR, int NP, int ST>
struct Tile {
  static constexpr int kStages = ST;
  static constexpr int kThreads = 128 * WR;
  static constexpr int kRows = 16 * TM * WR;   // rows of x
  static constexpr int kCols = 64 * NP;        // columns of the weight
  static constexpr int kWStride = kCols + 16;  // bytes per staged weight row (bank spread)
  static constexpr int kWStage = kChunk * kWStride;
  static constexpr int kXHalf = kRows * kXStride;  // one half of x in a stage
  static constexpr int kStage = kWStage + 2 * kXHalf;
  static constexpr int kRecv = kRows * kCols * 4;  // the tile's partial dots (S > 1)
  static constexpr int kSmem = kStages * kStage;      // the ring; kRecv reuses it
  static constexpr int kBlocksPerSM = WR == 1 ? 2 : 1;  // counted on to fill the card
  static_assert(kRecv <= kSmem, "the partial dots reuse the ring");
  static_assert(kBlocksPerSM * kSmem <= kMaxSmemBytes, "kBlocksPerSM blocks fit an SM");
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

// V bytes (16 or 4) of the weight from gmem to smem; a 16-byte copy asks L2
// to fetch its whole 128-byte line, which the next column tile reads
template <int V>
__device__ __forceinline__ void cp_async_w(void* smem, const void* gmem) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem), "n"(V));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The staged row of packed row r of a chunk: within each 16 rows, row 4t + j
// goes to 2t + {0, 1, 8, 9}[j], so that ldmatrix.trans and one byte permute
// give each lane packed rows 4t .. 4t + 3 of a column in order.
__device__ __forceinline__ int staged_row(int r) {
  return (r & ~15) | ((r >> 1) & 6) | ((r & 2) << 2) | (r & 1);
}

// A fragment word of packed bytes to the B words of the low half (q rows
// k ..) and of the high half (q rows K/2 + k ..), each byte 16 q: a nibble
// moved to the top of its byte is 16 q as int8 (the biased packing's v = q +
// 8 becomes q's two's complement by v ^ 8). The mma then sums 16 q x.
template <bool kBiased>
__device__ __forceinline__ void unpack16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if (kBiased) w ^= 0x88888888u;
  lo = (w << 4) & 0xF0F0F0F0u;
  hi = w & 0xF0F0F0F0u;
}

struct Args {
  const int8_t* x;
  const int8_t* packed;
  const float* scale;
  float* out;
  int M, K, N;
  int part_rows;  // packed rows in a slice (a multiple of 32)
  bool x_vec;     // x staged by 16-byte cp.async
};

// One block: rows m0 .. m0 + kRows - 1, columns n0 .. n0 + kCols - 1, slice
// blockIdx.y of K/2; its rank in the cluster of the tile's S slices is the
// slice. V is the width in bytes of a weight copy.
template <int TM, int WR, int NP, int ST, int V, bool kBiased>
__global__ void __launch_bounds__(128 * WR)
int4_split_matmul_kernel(const Args args) {
  using T = Tile<TM, WR, NP, ST>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int M = args.M, K = args.K, N = args.N, K2 = args.K / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp / 4, wc = warp % 4;
  const int m0 = blockIdx.x * T::kRows;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int n0 = blockIdx.z * T::kCols;
  const int x_rows = min(T::kRows, M - m0);

  const int k0 = slice * args.part_rows;
  const int k_len = max(0, min(args.part_rows, K2 - k0));
  const int chunks = (k_len + kChunk - 1) / kChunk;

  // each thread's fixed share of a chunk's copies: weight vector wv of rows
  // wr0, wr0 + kWStep, ...; x vector xv of rows xr0, xr0 + kXStep, ... of
  // each half
  constexpr int kVecs = T::kCols / V, kWStep = T::kThreads / kVecs;
  constexpr int kXVecs = kChunk / 16, kXStep = T::kThreads / kXVecs;
  const int wv = threadIdx.x % kVecs, wr0 = threadIdx.x / kVecs;
  const int xv = threadIdx.x % kXVecs, xr0 = threadIdx.x / kXVecs;
  const int wn = n0 + wv * V;
  const int8_t* w_col = wn < N ? args.packed + wn : nullptr;
  const int8_t* x_row = args.x + (int64_t)m0 * K;  // the block's first row, low half

  auto issue = [&](int c) {
    if (c < chunks) {
      uint8_t* w_s = smem + (c % T::kStages) * T::kStage;
      int8_t* x_s = reinterpret_cast<int8_t*>(w_s + T::kWStage);  // low half, then high
      const int start = k0 + c * kChunk, len = min(kChunk, k_len - c * kChunk);
      if (w_col)
        for (int r = wr0; r < len; r += kWStep)
          cp_async_w<V>(w_s + staged_row(r) * T::kWStride + wv * V,
                        w_col + (int64_t)(start + r) * N);
      const int width = (len + 31) & ~31;  // columns the mma reads
      if (args.x_vec) {
        const int bytes = max(0, min(16, len - xv * 16));
        if (xv * 16 < width)
          for (int r = xr0; r < x_rows; r += kXStep) {
            int8_t* dst = x_s + r * kXStride + xv * 16;
            const int8_t* src = args.x + (int64_t)(m0 + r) * K + start + (bytes ? xv * 16 : 0);
            cp_async16(dst, src, bytes);
            cp_async16(dst + T::kXHalf, src + K2, bytes);
          }
      } else {
        for (int e = threadIdx.x; e < x_rows * kChunk; e += T::kThreads) {
          const int r = e / kChunk, k = e % kChunk;  // kChunk is a power of two
          if (k < width) {
            const int8_t* src = x_row + (int64_t)r * K + start + k;
            const bool in = k < len;
            x_s[r * kXStride + k] = in ? src[0] : (int8_t)0;
            x_s[T::kXHalf + r * kXStride + k] = in ? src[K2] : (int8_t)0;
          }
        }
      }
    }
    cp_async_commit();  // possibly empty: keeps one group per chunk
  };

  // dots[t][2 p + o][v]: mma accumulators of row tile t, column run p, even
  // (o = 0) or odd (o = 1) columns; dot(t, p, h, i) is the int32 dot of row
  // row_of(t, h) and column col_of(p) + i
  int dots[TM][2 * NP][4];
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int q = 0; q < 2 * NP; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) dots[t][q][v] = 0;
  auto dot = [&](int t, int p, int h, int i) { return dots[t][2 * p + (i & 1)][2 * h + i / 2]; };
  auto row_of = [&](int t, int h) { return wr * 16 * TM + 16 * t + gid + 8 * h; };
  auto col_of = [&](int p) { return wc * 16 * NP + 16 * p + 4 * tig; };

  // A: lane l gives the address of x row 16 t + l % 16 (of the warp's rows),
  // bytes 16 (l / 16), in the low half (+ kXHalf: the high half); B: lane l
  // the address of staged row l of a 32-row step, at the warp's columns
  const int a_off = (wr * 16 * TM + lane % 16) * kXStride + (lane / 16) * 16;
  const int b_off = lane * T::kWStride + wc * 16 * NP;

#pragma unroll
  for (int c = 0; c < T::kStages - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<T::kStages - 2>();  // chunk c has landed
    __syncthreads();               // for every thread; chunk c - 1 is no longer read
    issue(c + T::kStages - 1);
    const uint8_t* w_s = smem + (c % T::kStages) * T::kStage;
    const unsigned a_base = smem_addr(w_s + T::kWStage + a_off);
    const unsigned b_base = smem_addr(w_s + b_off);
    const int len = min(kChunk, k_len - c * kChunk);
    // the chunk's dots of x and 16 q: at most 128 * 128 * 256 = 2^22 in magnitude
    int part[TM][2 * NP][4];
#pragma unroll
    for (int t = 0; t < TM; ++t)
#pragma unroll
      for (int q = 0; q < 2 * NP; ++q)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[t][q][v] = 0;
#pragma unroll
    for (int k = 0; k < kChunk; k += 32) {
      if (k >= len) break;
      // [p][o][half of the step]: the B words of the low and the high q rows
      uint32_t b_lo[NP][2][2], b_hi[NP][2][2];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t b[4];  // staged rows 0-7, 8-15, 16-23, 24-31 of the step
        ldmatrix_x4_trans(b, b_base + k * T::kWStride + 16 * p);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // packed rows k + 16 h + 4 tig .. + 3
          unpack16<kBiased>(__byte_perm(b[2 * h], b[2 * h + 1], 0x6420), b_lo[p][0][h],
                            b_hi[p][0][h]);
          unpack16<kBiased>(__byte_perm(b[2 * h], b[2 * h + 1], 0x7531), b_lo[p][1][h],
                            b_hi[p][1][h]);
        }
      }
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        uint32_t a_lo[4], a_hi[4];
        ldmatrix_x4(a_lo, a_base + t * 16 * kXStride + k);
        ldmatrix_x4(a_hi, a_base + T::kXHalf + t * 16 * kXStride + k);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int o = 0; o < 2; ++o)
            mma_s8(part[t][2 * p + o], a_lo, b_lo[p][o][0], b_lo[p][o][1]);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int o = 0; o < 2; ++o)
            mma_s8(part[t][2 * p + o], a_hi, b_hi[p][o][0], b_hi[p][o][1]);
      }
    }
#pragma unroll
    for (int t = 0; t < TM; ++t)
#pragma unroll
      for (int q = 0; q < 2 * NP; ++q)
#pragma unroll
        for (int v = 0; v < 4; ++v) dots[t][q][v] += part[t][q][v] >> 4;  // exact
  }
  cp_async_wait<0>();

  if (slices == 1) {  // the epilogue in registers, four columns to a 16-byte store
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int n = n0 + col_of(p);
      if (n >= N) continue;  // else all four are: N is a multiple of 4
      const float s[4] = {__ldg(args.scale + n), __ldg(args.scale + n + 1),
                          __ldg(args.scale + n + 2), __ldg(args.scale + n + 3)};
#pragma unroll
      for (int t = 0; t < TM; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row_of(t, h);
          if (r >= x_rows) continue;
          *reinterpret_cast<float4*>(args.out + (int64_t)(m0 + r) * N + n) =
              make_float4(__fmul_rn(__int2float_rn(dot(t, p, h, 0)), s[0]),
                          __fmul_rn(__int2float_rn(dot(t, p, h, 1)), s[1]),
                          __fmul_rn(__int2float_rn(dot(t, p, h, 2)), s[2]),
                          __fmul_rn(__int2float_rn(dot(t, p, h, 3)), s[3]));
        }
    }
    return;
  }

  // S > 1: the tile's columns are cut into S runs of cpo; block s owns run
  // s, and recv[s' share + r cpo + c], over the ring, holds slice s'
  // partial dot at row r, column c of the run
  const int cpo = T::kCols / slices, cpo_shift = __ffs(cpo) - 1;  // S is a power of two
  const int share = T::kRows * cpo;
  int* recv = reinterpret_cast<int*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block of the cluster is done with its ring
  int* base = recv + slice * share;
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
  cluster.sync();  // every partial dot has been stored
  // the owned run, four columns at a time: the S parts added (int32, exact),
  // then the epilogue
  const int nc0 = n0 + slice * cpo;
  const int q_shift = cpo_shift - 2;  // cpo / 4 quads of columns in a row of the run
  for (int u = threadIdx.x; u < (x_rows << q_shift); u += T::kThreads) {
    const int r = u >> q_shift, c = (u & ((1 << q_shift) - 1)) * 4;
    const int n = nc0 + c;
    if (n >= N) continue;
    int4 d = *reinterpret_cast<const int4*>(recv + r * cpo + c);
    for (int s = 1; s < slices; ++s) {
      const int4 e = *reinterpret_cast<const int4*>(recv + s * share + r * cpo + c);
      d.x += e.x;
      d.y += e.y;
      d.z += e.z;
      d.w += e.w;
    }
    *reinterpret_cast<float4*>(args.out + (int64_t)(m0 + r) * N + n) =
        make_float4(__fmul_rn(__int2float_rn(d.x), __ldg(args.scale + n)),
                    __fmul_rn(__int2float_rn(d.y), __ldg(args.scale + n + 1)),
                    __fmul_rn(__int2float_rn(d.z), __ldg(args.scale + n + 2)),
                    __fmul_rn(__int2float_rn(d.w), __ldg(args.scale + n + 3)));
  }
}

// The tile of an M: (TM, WR, NP, ST) = (1, 1, 1, 4), (2, 1, 1, 4), (4, 1, 1,
// 3) up to 16, 32, 64 rows (64 columns, 4 warps); (3, 2, 2, 3) up to 96 (96
// rows by 128 columns, 8 warps); (3, 3, 2, 3) above (144 rows by 128
// columns, 12 warps).
int tile_kind(int M) { return M <= 16 ? 0 : M <= 32 ? 1 : M <= 64 ? 2 : M <= 96 ? 3 : 4; }

template <typename F>
auto with_tile(int M, F f) {
  switch (tile_kind(M)) {
    case 0: return f(Tile<1, 1, 1, 4>{});
    case 1: return f(Tile<2, 1, 1, 3>{});
    case 2: return f(Tile<4, 1, 1, 3>{});
    case 3: return f(Tile<3, 2, 2, 3>{});
    default: return f(Tile<3, 3, 2, 3>{});
  }
}

// S, the slices of K/2: 1 where the tiles fill the card (kBlocksPerSM blocks
// on each SM, within 1/16), else the least of 2, 4, 8, 16 that does, with
// slices of at least kMinSlice packed rows.
template <typename T>
int slices_for(T, int M, int K2, int N) {
  const int tiles = ceil_div(N, T::kCols) * ceil_div(M, T::kRows);
  const int full = kSMs * T::kBlocksPerSM * 15 / 16;
  int s = 1;
  while (s < kMaxSlices && tiles * s < full && ceil_div(K2, 2 * s) >= kMinSlice) s *= 2;
  return s;
}

// packed rows in each of S slices: ceil(K/2 / S) rounded up to 32
int part_rows(int K2, int slices) { return ceil_div(ceil_div(K2, slices), 32) * 32; }

template <int TM, int WR, int NP, int ST, int V, bool kBiased>
cudaError_t launch_v(Args args, cudaStream_t stream) {
  using T = Tile<TM, WR, NP, ST>;
  auto kernel = int4_split_matmul_kernel<TM, WR, NP, ST, V, kBiased>;
  // clusters of more than 8 blocks and more than 48 KB of shared memory must
  // be allowed, once per kernel
  static const cudaError_t allowed = [&] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxSmemBytes);
  }();
  if (allowed != cudaSuccess) return allowed;
  const int slices = slices_for(T{}, args.M, args.K / 2, args.N);
  args.part_rows = part_rows(args.K / 2, slices);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ceil_div(args.M, T::kRows), slices, ceil_div(args.N, T::kCols));
  config.blockDim = dim3(T::kThreads);
  config.dynamicSmemBytes = T::kSmem;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = slices;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args);
}

template <int TM, int WR, int NP, int ST, bool kBiased>
cudaError_t launch_b(const Args& args, bool vec16, cudaStream_t stream) {
  return vec16 ? launch_v<TM, WR, NP, ST, 16, kBiased>(args, stream)
               : launch_v<TM, WR, NP, ST, 4, kBiased>(args, stream);
}

template <int TM, int WR, int NP, int ST>
cudaError_t launch(Tile<TM, WR, NP, ST>, const Args& args, bool vec16, bool biased,
                   cudaStream_t stream) {
  return biased ? launch_b<TM, WR, NP, ST, true>(args, vec16, stream)
                : launch_b<TM, WR, NP, ST, false>(args, vec16, stream);
}

bool valid(int M, int K, int N) {
  return M > 0 && K > 0 && K % 2 == 0 && N > 0 && N % 4 == 0;
}

}  // namespace

// The geometry of an (M, K, N) product into grid[0..2]: (column tiles, S
// slices of K/2, row blocks); S is also the cluster size. The launch puts
// the row blocks fastest. biased does not change it. Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int blurr_int4_split_matmul_grid(int M, int K, int N, int biased, int* grid) {
  (void)biased;
  if (!valid(M, K, N)) return (int)cudaErrorInvalidValue;
  return with_tile(M, [&](auto tile) {
    using T = decltype(tile);
    grid[0] = ceil_div(N, T::kCols);
    grid[1] = slices_for(tile, M, K / 2, N);
    grid[2] = ceil_div(M, T::kRows);
    return 0;
  });
}

// x int8 [M, K], packed int8 [K/2, N] (split-half; biased != 0: nibbles hold
// q + 8), scale fp32 [N], out fp32 [M, N], all contiguous; K even, N a
// multiple of 4, packed 4-byte aligned (16-byte copies where N and packed
// allow, else 4-byte ones) and out 16-byte aligned (float4 stores). Launches
// the kernel on `stream`; returns its cudaError_t.
extern "C" int blurr_int4_split_matmul(const void* x, const void* packed, const void* scale,
                                       void* out, int M, int K, int N, int biased,
                                       void* stream) {
  if (!valid(M, K, N)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)packed % 4 || (uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  const Args args = {static_cast<const int8_t*>(x), static_cast<const int8_t*>(packed),
                     static_cast<const float*>(scale), static_cast<float*>(out),
                     M, K, N, 0, (K / 2) % 16 == 0 && (uintptr_t)x % 16 == 0};
  const bool vec16 = N % 16 == 0 && (uintptr_t)packed % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_tile(M, [&](auto tile) { return launch(tile, args, vec16, biased, s); });
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
