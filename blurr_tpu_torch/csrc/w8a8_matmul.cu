// int8 x int8 matmul with one fp32 scale per column (the w8a8 product),
// written for Hopper (sm_90a).
//
// Replaces the TPU kernels of the w8a8 experiments:
// experiments/bench_pallas_int4.py:52 pallas_int8 (body _int8_kernel :37),
// experiments/bench_pallas_int4_tune.py:46 make_int8 (body _int8_kernel :25)
// and experiments/bench_pallas_int8_blockmajor.py:49 pallas_int8_bm (body
// _kernel :32, the block-major weight). It computes their function, and that
// of the plain blurr_tpu_torch.ops.w8a8_matmul.w8a8_matmul_reference:
//
//   out[m, n] = __fmul_rn(__int2float_rn(int32 dot of x[m, :] and w[:, n]), scale[n])
//
// x is int8 [M, K]; w is int8, row-major [K, N] or block-major [N/BN, K, BN]
// (row-major is block-major with BN = N); scale is fp32 [N]; out is fp32
// [M, N]. The dot is exact in int32 (K < 2^17) in any order of its terms, and
// is converted (round to nearest even, as the plain version's float64 ->
// float32 cast) and scaled once, after the whole sum: the result equals the
// plain version bit for bit, however K is cut and merged.
//
// What bounds it on the H100 (each input read once, the output written once,
// 3.35 TB/s; int8 tensor cores 1,979 TOP/s): at the harness shapes (M, K, N)
// (8, 4096, 11264) 46.6 MB, 13.9 us; (32, 4096, 11264) 47.8 MB, 14.3 us;
// (96, 2048, 16384) 40.1 MB, 12.0 us; (96, 16384, 2048) 35.9 MB, 10.7 us;
// (276, 2048, 16384) 52.3 MB, 15.6 us (its 18.5 G operations 9.4 us); (5,
// 1024, 4096) 4.3 MB, 1.3 us. All are bound by bytes: the weight stream, and
// at M 276 the 18 MB of fp32 output as well. The design:
// - Tensor cores. mma.sync m16n8k32 s8 x s8 -> s32. A is x, staged in shared
//   memory as it lies and read by ldmatrix.x4 (lane l: row l % 16, bytes
//   16 (l / 16)). B is the weight tile, K rows by 16-byte runs of columns.
//   The B fragment wants 4 consecutive K values of one column in a register;
//   ldmatrix.trans works on 16-bit elements and hands lane (g, t) = (lane / 4,
//   lane % 4) a word of staged rows 2t and 2t + 1 by columns 2g and 2g + 1.
//   So the K rows are staged permuted: within each 16 rows, K row 4t + j
//   lands on staged row 2t + {0, 1, 8, 9}[j] (staged_row). One
//   ldmatrix.x4.trans reads staged rows 0-7, 8-15, 16-23, 24-31 of a 32-row
//   step; __byte_perm(m0, m1, 0x6420) gathers bytes 0 and 2 of each, that is
//   K rows 4t .. 4t + 3 of column 2g in order, and 0x7531 the same rows of
//   column 2g + 1: one mma for the even columns, one for the odd, and A and B
//   both in the natural K order. A thread then holds the dots of 4 adjacent
//   columns, 4t .. 4t + 3 of its 16, for rows g and g + 8.
// - Loads. K is walked in chunks of 128 rows, four stages deep (three for
//   the 96-row tile): the next chunks' cp.async are in flight while one is
//   multiplied. Each thread copies a fixed vector of V bytes of the weight
//   (V = 16 where BN and w allow it, else 4: BN a multiple of 4 only) on
//   rows r0, r0 + step, ... and a fixed 16 bytes of x's rows; its column
//   pointer is found once (a vector never straddles a block of BN columns,
//   so a column tile may).
//   x past the chunk's K rows is zero-filled by cp.async (src_bytes), so the
//   rows of a 32-row step past K, or past the slice, multiply zeros; where K
//   or x is not 16-byte aligned, x is staged byte by byte. Staged rows are
//   80 or 144 bytes apart: ldmatrix reads without bank conflicts.
// - Tiles (Tile). Up to 16, 32, 64 rows of x: 4 warps, 64 columns, each
//   warp all the rows by 16 columns. Up to 96 rows: 8 warps, 96 rows by 128
//   columns, each warp 48 rows by 32 columns (96 KB of shared memory, so two
//   blocks share an SM). Above 96 rows: 12 warps, 144 rows by 128 columns
//   (M 276 in 2 row blocks, not 3). The grid is (row blocks, S
//   slices of K, column tiles) with the row blocks fastest, so the blocks
//   that share weight columns run together and the weight comes from device
//   memory once. Rows past M are computed and not stored.
// - Split K, exactly. Where the tiles alone leave the card short of full
//   (2 blocks to an SM for the 4-warp tiles, 1 for the larger ones, within
//   1/16), K is cut into S = 2, 4, 8 or 16 slices of ceil(K / S) rows
//   rounded up to 32 (the last may be short or empty), with slices of at
//   least 64 rows. The tile's S slice-blocks are one thread block cluster
//   (16 needs the non-portable size): the tile's columns are cut into S
//   runs, block s owns run s. After a cluster barrier (every block is done
//   with its ring) each block stores its int32 partial dots, four columns
//   to a 16-byte store, into the owner's shared memory over its ring
//   (distributed shared memory); after a second one each block adds the S
//   parts of its run (int32, exact) and runs the epilogue. No atomics, no
//   workspace, one launch. Grids (column tiles x S x row blocks):
//   (8, 4096, 11264) 176 x 2 x 1; (32, 4096, 11264) the same; (96, 2048,
//   16384) 128 x 1 x 1; (96, 16384, 2048) 16 x 8 x 1; (276, 2048, 16384)
//   128 x 1 x 2; (5, 1024, 4096) 64 x 4 x 1.
// - Stores. Four adjacent fp32 columns to a 16-byte store, from registers
//   (S = 1) or from the owner's run in shared memory.
// The first form ran __dp4a on the CUDA cores with 4-byte __ldg of the
// weight, 64 threads a block and no split: 44 blocks at N 11264. Variants
// tried on the H100 in a CUDA graph: what paid was the 144-row tile at M 276
// (2 row blocks, not 3: the weight crosses L2 twice, not three times) and,
// for the 96-row tile, 3 stages with the partial dots over the ring, so that
// two blocks share an SM (with the partial dots beside a 4-stage ring the
// card could not hold all 16 clusters of 8 of (96, 16384, 2048) at once, and
// ran the rest in a second wave). What did not: 256-row chunks in 2 stages,
// 64-row chunks in 8 and 5 stages (equal or slower); 128-column tiles of 4
// warps at M <= 64 (slower); streaming stores of the output (no change).
// Skipping the DSMEM stores altogether saved only a few percent: the merge
// is not what bounds the split shapes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 128;            // rows of K staged at once
constexpr int kXStride = kChunk + 16;  // bytes per staged x row (bank spread)
constexpr int kMinSlice = 64;          // fewest rows of K in a slice
constexpr int kMaxSlices = 16;         // the largest cluster Hopper takes (non-portable)
constexpr int kSMs = 132;
constexpr int kMaxSmemBytes = 227 * 1024;  // the most a block can have

// A block's tile: 4 WR warps, WR rows of 4; each warp owns TM row tiles of
// 16 and NP column runs of 16 (an even and an odd 8-column mma tile each);
// ST chunks in the ring.
template <int TM, int WR, int NP, int ST>
struct Tile {
  static constexpr int kStages = ST;
  static constexpr int kThreads = 128 * WR;
  static constexpr int kRows = 16 * TM * WR;   // rows of x
  static constexpr int kCols = 64 * NP;        // columns of the weight
  static constexpr int kWStride = kCols + 16;  // bytes per staged weight row (bank spread)
  static constexpr int kWStage = kChunk * kWStride;
  static constexpr int kStage = kWStage + kRows * kXStride;
  static constexpr int kRecv = kRows * kCols * 4;  // the tile's partial dots (S > 1)
  static constexpr int kSmem = kStages * kStage;      // the ring; kRecv reuses it
  static constexpr int kBlocksPerSM = WR == 1 ? 2 : 1;  // counted on to fill the card
  static_assert(kRecv <= kSmem, "the partial dots reuse the ring");
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

// V bytes (16 or 4) of the weight from gmem to smem
template <int V>
__device__ __forceinline__ void cp_async_w(void* smem, const void* gmem) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
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

// The staged row of K row r of a chunk: within each 16 rows, row 4t + j goes
// to 2t + {0, 1, 8, 9}[j], so that ldmatrix.trans and one byte permute give
// each lane K rows 4t .. 4t + 3 of a column in order.
__device__ __forceinline__ int staged_row(int r) {
  return (r & ~15) | ((r >> 1) & 6) | ((r & 2) << 2) | (r & 1);
}

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  float* out;
  int M, K, N, BN;
  int part_rows;  // rows of K in a slice (a multiple of 32)
  bool x_vec;     // x staged by 16-byte cp.async
};

// One block: rows m0 .. m0 + kRows - 1, columns n0 .. n0 + kCols - 1, slice
// blockIdx.y of K; its rank in the cluster of the tile's S slices is the
// slice. V is the width in bytes of a weight copy.
template <int TM, int WR, int NP, int ST, int V>
__global__ void __launch_bounds__(128 * WR)
w8a8_matmul_kernel(const Args args) {
  using T = Tile<TM, WR, NP, ST>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int M = args.M, K = args.K, N = args.N, BN = args.BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp / 4, wc = warp % 4;
  const int m0 = blockIdx.x * T::kRows;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int n0 = blockIdx.z * T::kCols;
  const int x_rows = min(T::kRows, M - m0);

  const int k0 = slice * args.part_rows;
  const int k_len = max(0, min(args.part_rows, K - k0));
  const int chunks = (k_len + kChunk - 1) / kChunk;

  // each thread's fixed share of a chunk's copies: weight vector wv of rows
  // wr0, wr0 + kWStep, ...; x vector xv of rows xr0, xr0 + kXStep, ...
  constexpr int kVecs = T::kCols / V, kWStep = T::kThreads / kVecs;
  constexpr int kXVecs = kChunk / 16, kXStep = T::kThreads / kXVecs;
  const int wv = threadIdx.x % kVecs, wr0 = threadIdx.x / kVecs;
  const int xv = threadIdx.x % kXVecs, xr0 = threadIdx.x / kXVecs;
  const int wn = n0 + wv * V;  // a vector lies in one block of BN columns
  const int8_t* w_col = wn < N ? args.w + (int64_t)(wn / BN) * K * BN + wn % BN : nullptr;

  auto issue = [&](int c) {
    if (c < chunks) {
      uint8_t* w_s = smem + (c % T::kStages) * T::kStage;
      int8_t* x_s = reinterpret_cast<int8_t*>(w_s + T::kWStage);
      const int start = k0 + c * kChunk, len = min(kChunk, k_len - c * kChunk);
      if (w_col)
        for (int r = wr0; r < len; r += kWStep)
          cp_async_w<V>(w_s + staged_row(r) * T::kWStride + wv * V,
                        w_col + (int64_t)(start + r) * BN);
      const int width = (len + 31) & ~31;  // columns the mma reads
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
  // bytes 16 (l / 16); B: lane l the address of staged row l of a 32-row
  // step, at the warp's columns
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
#pragma unroll
    for (int k = 0; k < kChunk; k += 32) {
      if (k >= len) break;
      uint32_t b_even[NP][2], b_odd[NP][2];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t b[4];  // staged rows 0-7, 8-15, 16-23, 24-31 of the step
        ldmatrix_x4_trans(b, b_base + k * T::kWStride + 16 * p);
        b_even[p][0] = __byte_perm(b[0], b[1], 0x6420);  // K rows k + 4 tig .. + 3
        b_odd[p][0] = __byte_perm(b[0], b[1], 0x7531);
        b_even[p][1] = __byte_perm(b[2], b[3], 0x6420);  // K rows k + 16 + 4 tig .. + 3
        b_odd[p][1] = __byte_perm(b[2], b[3], 0x7531);
      }
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        uint32_t a[4];
        ldmatrix_x4(a, a_base + t * 16 * kXStride + k);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          mma_s8(dots[t][2 * p], a, b_even[p][0], b_even[p][1]);
          mma_s8(dots[t][2 * p + 1], a, b_odd[p][0], b_odd[p][1]);
        }
      }
    }
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

// The tile of an M: (TM, WR, NP) = (1, 1, 1), (2, 1, 1), (4, 1, 1) up to
// 16, 32, 64 rows (64 columns, 4 warps, 4 stages); (3, 2, 2) up to 96 (96
// rows by 128 columns, 8 warps, 3 stages: 96 KB, two blocks to an SM);
// (3, 3, 2) above (144 rows by 128 columns, 12 warps, 4 stages).
int tile_kind(int M) { return M <= 16 ? 0 : M <= 32 ? 1 : M <= 64 ? 2 : M <= 96 ? 3 : 4; }

template <typename F>
auto with_tile(int M, F f) {
  switch (tile_kind(M)) {
    case 0: return f(Tile<1, 1, 1, 4>{});
    case 1: return f(Tile<2, 1, 1, 4>{});
    case 2: return f(Tile<4, 1, 1, 4>{});
    case 3: return f(Tile<3, 2, 2, 3>{});
    default: return f(Tile<3, 3, 2, 4>{});
  }
}

// S, the slices of K: 1 where the tiles fill the card (kBlocksPerSM blocks
// on each SM, within 1/16), else the least of 2, 4, 8, 16 that does, with
// slices of at least kMinSlice rows.
template <typename T>
int slices_for(T, int M, int K, int N) {
  const int tiles = ceil_div(N, T::kCols) * ceil_div(M, T::kRows);
  const int full = kSMs * T::kBlocksPerSM * 15 / 16;
  int s = 1;
  while (s < kMaxSlices && tiles * s < full && ceil_div(K, 2 * s) >= kMinSlice) s *= 2;
  return s;
}

// rows of K in each of S slices: ceil(K / S) rounded up to 32
int part_rows(int K, int slices) { return ceil_div(ceil_div(K, slices), 32) * 32; }

template <int TM, int WR, int NP, int ST, int V>
cudaError_t launch_v(Args args, cudaStream_t stream) {
  using T = Tile<TM, WR, NP, ST>;
  auto kernel = w8a8_matmul_kernel<TM, WR, NP, ST, V>;
  // clusters of more than 8 blocks and more than 48 KB of shared memory must
  // be allowed, once per kernel
  static const cudaError_t allowed = [&] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxSmemBytes);
  }();
  if (allowed != cudaSuccess) return allowed;
  const int slices = slices_for(T{}, args.M, args.K, args.N);
  args.part_rows = part_rows(args.K, slices);
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

template <int TM, int WR, int NP, int ST>
cudaError_t launch(Tile<TM, WR, NP, ST>, const Args& args, bool vec16, cudaStream_t stream) {
  return vec16 ? launch_v<TM, WR, NP, ST, 16>(args, stream)
               : launch_v<TM, WR, NP, ST, 4>(args, stream);
}

bool valid(int M, int K, int N, int BN) {
  return M > 0 && K > 0 && K < (1 << 17) && N > 0 && BN > 0 && BN % 4 == 0 && N % BN == 0;
}

}  // namespace

// The geometry of an (M, K, N) product into grid[0..2]: (column tiles, S
// slices of K, row blocks); S is also the cluster size. The launch puts the
// row blocks fastest. BN does not change it. Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int blurr_w8a8_matmul_grid(int M, int K, int N, int BN, int* grid) {
  if (!valid(M, K, N, BN)) return (int)cudaErrorInvalidValue;
  return with_tile(M, [&](auto tile) {
    using T = decltype(tile);
    grid[0] = ceil_div(N, T::kCols);
    grid[1] = slices_for(tile, M, K, N);
    grid[2] = ceil_div(M, T::kRows);
    return 0;
  });
}

// x int8 [M, K], w int8 [N/BN, K, BN] (BN = N: row-major [K, N]), scale fp32
// [N], out fp32 [M, N], all contiguous; BN a multiple of 4, 1 <= K < 2^17, w
// 4-byte aligned (16-byte copies where BN and w allow, else 4-byte ones) and
// out 16-byte aligned (float4 stores). Launches the kernel on `stream`;
// returns its cudaError_t.
extern "C" int blurr_w8a8_matmul(const void* x, const void* w, const void* scale, void* out,
                                 int M, int K, int N, int BN, void* stream) {
  if (!valid(M, K, N, BN)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)w % 4 || (uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  const Args args = {static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                     static_cast<const float*>(scale), static_cast<float*>(out),
                     M, K, N, BN, 0, K % 16 == 0 && (uintptr_t)x % 16 == 0};
  const bool vec16 = BN % 16 == 0 && (uintptr_t)w % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_tile(M, [&](auto tile) { return launch(tile, args, vec16, s); });
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
