// Fused GeGLU feed-forward block, bf16, written for Hopper (sm_90a).
//
// Replaces the TPU kernel experiments/bench_fused_ffn.py:57 fused_ffn (body
// _kernel :32). It computes that kernel's function, and that of the plain
// blurr_tpu_torch.ops.fused_ffn.fused_ffn_reference:
//
//   a   = bf16(gelu_tanh(x @ Wg) * (x @ Wu))    fp32 dots, GeGLU and product in fp32
//   out = bf16(a @ Wd)                          accumulated in fp32, rounded once
//
// x is bf16 [M, H]; Wg and Wu are bf16 [H, I] (the JAX harness's layout); Wd
// is bf16 [I, H]; out is bf16 [M, H]. The intermediate a is written once, as
// bf16 [M, I], to a workspace the caller allocates, and read once.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at the harness
// shape (M, H, I) = (280, 2048, 16384) the three weights are 201 MB (60 us)
// and the three products 56.4 G operations (57 us): 0.0608 ms, at the card's
// ridge. The gate and up product is 2/3 of both.
//
// Why a goes through L2. The TPU kernel keeps the whole fp32 [M, H] sum (2.3
// MB) in VMEM across a sequential grid over I. An SM has 227 KB of shared
// memory, so a design that keeps a on chip must split I across blocks and
// add S partials of the whole output, S x 4.6 MB of fp32 traffic (101 MB at
// 22 slices, ~600 MB at one slice per SM): more than the weights. Written
// once and read once, bf16 a [280, 16384] moves 2 x 9.2 MB, and all of it
// stays in the 50 MB L2. So the fusion kept is the GeGLU in the epilogue of
// the gate/up product, where g and u never leave registers.
//
// The design: two kernels on one stream (capturable in a CUDA graph), the
// same block and mainloop in both. The products are taken transposed, D^T =
// W^T . X^T, so that the weight is wgmma's A operand (M = 64 of its
// columns) and the rows of x (or a) are its N: 280 rows are two N of 144 (2
// x 144 = 288, 3% padding, where 64-row tiles would pad to 320 and 128-row
// ones to 384).
// - Block: two warpgroups (256 threads; up to 255 registers a thread), 64
//   columns of the weight by 288 rows, warpgroup w the rows [144 w, 144 w +
//   144). Thread 0 also keeps a ring of 4 stages full by TMA, each stage one
//   64-deep step of K: the weight tile(s) [64 k][64 n] (8 KB each) and the
//   two activation tiles [144 rows][64 k] (18 KB each), 52 KB a stage, 208
//   KB in all; a full mbarrier per stage takes the bytes (expect_tx). Rows
//   past M come in as zeros (TMA's out-of-bounds fill); a half with no
//   valid row is not loaded, and is multiplied but never stored.
// - Tensor cores: wgmma.mma_async m64n144k16 bf16 -> fp32, both operands
//   from shared memory, 4 or 8 per warpgroup a stage; one group in flight
//   (wait_group 1) while the next is issued. Then a named barrier of both
//   warpgroups hands the stage before back, and thread 0 refills it. The
//   producer's operations are predicated asm and the waits loop inside asm,
//   so the mainloop has no divergent branch: with one, ptxas serialized the
//   wgmma (C7518), and with a producer warp it capped the registers at 168
//   (three warps on one SM sub-partition) and spilled the accumulators.
// - Phase 1, gate and up (ffn_kernel<true>): grid (row blocks, I / 64), row
//   blocks fastest, so the blocks that share weight tiles run together and
//   each weight byte comes from device memory once. Each warpgroup
//   multiplies the Wg and the Wu tile by its own rows: the two accumulators
//   align element for element, gelu_tanh(g) * u is formed in registers
//   (PyTorch's tanh formula), rounded to bf16, staged in shared memory (over
//   its own activation tile of stage 0, in the same 128-byte swizzle) and
//   stored to a_ws 16 bytes at a time. At (280, 2048, 16384): 256 blocks,
//   two waves on 132 SMs.
// - Phase 2, down (ffn_kernel<false>): grid (row blocks, S, H / 64), the S
//   slice-blocks of a tile one thread block cluster (1, S, 1), slices of
//   ceil(I / 64 / S) steps. S is the one of 1..8 that least the steps of a
//   slice times the waves its clusters take: an H100 SXM runs at most 132,
//   66, 39, 30, 22, 17, 15, 15 clusters of 1..8 of these blocks at once
//   (cudaOccupancyMaxActiveClusters), so 32 tiles of S 3 (96 blocks) run in
//   one wave where S 4 or 8 took two. After a cluster barrier each block
//   stores its fp32 partial, two rows to an 8-byte store, into the shared
//   memory of the block that owns those rows (S runs of R rows), over its
//   ring; after a second the owner adds the S parts in slice order and
//   rounds once to bf16. No atomics, no fp32 workspace in device memory: the
//   result does not depend on the order the blocks ran in.
// - Shared-memory layouts behind the wgmma descriptors (128-byte swizzle,
//   layout type 1; every tile 1024-byte aligned). TMA writes a box whose
//   inner extent is 64 bf16 (128 bytes) as rows of 128 bytes, the 16-byte
//   chunk c of row r at chunk c ^ (r % 8): byte(r, e) = 128 r + 16 ((e / 8)
//   ^ (r % 8)) + 2 (e % 8).
//   - The weight tile, rows k, elements n: wgmma's A, MN-major (imm-trans-a
//     1). Canonical ((8,8,1),(8,2)):((1,8,LBO),(64,SBO)) in elements: SBO
//     1024 bytes (the next 8 rows of k); LBO, the next 64 columns, unused at
//     M 64. The k16 step kk starts 2048 bytes further.
//   - The activation tile, rows of x, elements k: wgmma's B, K-major
//     (imm-trans-b 0). Canonical ((8,18),(8,2)):((64,SBO),(1,8)): SBO 1024
//     bytes (the next 8 rows), LBO unused. The k16 step kk starts 32 bytes
//     further, inside the swizzle atom (the swizzle acts on address bits).
//   tests/test_torch_fused_ffn.py mirrors both maps and the descriptors in
//   numpy.
// - Accumulators: D^T element j of a thread (warp v of its warpgroup, lane
//   4 g + q) is weight column 16 v + g + 8 ((j / 2) % 2), activation row 8
//   (j / 4) + 2 q + j % 2: 72 fp32 a product, two in phase 1.
// Where it stands on the H100 (0.108 ms a layer in a CUDA graph, phase 1
// 0.055 ms, phase 2 0.048 ms): each phase moves 7.6-7.7 TB/s from L2 to the
// SMs (phase 1 426 MB, x re-read by every column tile; phase 2 363 MB, a
// re-read by every column tile), while the tensor cores of the SMs that hold
// blocks run at 57-73% of their peak (both derived from the shapes and the
// times; L2's own rate was not measured).
// Tried on the H100 and not kept (variants no longer in the tree):
// multicasting each activation half by TMA to a pair of column tiles (x's
// or a's L2 traffic halved), with 512 and then 16 mbarrier arrivals a step
// across the pair, made both phases slower (phase 1 by about 1.7 times,
// phase 2 by about 2.3); 128-column down tiles (the warpgroups split the
// columns, half the reads of a) were no faster at S 6 and slower at S 8
// (16 clusters of 8, one more than fit, so two waves).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kCols = 64;                 // weight columns of one A tile (the wgmma M)
constexpr int kK = 64;                    // K of a stage: 64 bf16 = one 128-byte swizzle row
constexpr int kHalf = 144;                // rows per warpgroup (the wgmma N)
constexpr int kRows = 2 * kHalf;          // rows of a block
constexpr int kStages = 4;
constexpr int kThreads = 256;             // two warpgroups
constexpr int kATile = kK * kCols * 2;    // 8 KB
constexpr int kBTile = kHalf * kK * 2;    // 18 KB
constexpr int kStage = 2 * kATile + 2 * kBTile;
constexpr int kRing = kStages * kStage;
constexpr int kSmem = kRing + 1024 + kStages * 8;  // + alignment + the mbarriers
constexpr int kAcc = kHalf / 2;           // fp32 accumulators of one m64n144 product a thread
constexpr int kMaxSlices = 8;
constexpr int kMinSliceSteps = 4;         // a slice of K gets at least 4 steps of 64
// the most clusters of 1..8 blocks of phase 2 (one block an SM) an H100 SXM
// runs at once (blurr_fused_ffn_clusters on the card)
constexpr int kClusters[kMaxSlices + 1] = {0, 132, 66, 39, 30, 22, 17, 15, 15};
static_assert((kRows + 2 * kMaxSlices) * kCols * 4 <= kRing,
              "the partials of phase 2 reuse the ring");

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct Params {
  bf16* dst;          // a_ws [M, I] (phase 1) or out [M, H] (phase 2)
  int M;
  int K;              // H (phase 1) or I (phase 2)
  int ld;             // row length of dst
  int slice_steps;    // steps of 64 in a slice of K (all of K in phase 1)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The producer's operations take a predicate, so that one thread issues them
// from code that every thread runs (no divergent branch).
__device__ __forceinline__ void mbar_expect_tx(bool on, uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes), "r"((int)on)
      : "memory");
}

// Waits until the phase of parity `parity` of the mbarrier has completed.
// The loop is inside one asm block, so the compiler sees no divergent path
// between the asynchronous wgmma. After 2^26 unsuccessful tries (seconds)
// the kernel traps, so a lost transfer fails the launch instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u32 n;\n mov.u32 n, 0;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra.uni DONE;\n"
      " add.u32 n, n, 1;\n"
      " setp.lt.u32 p, n, 67108864;\n"
      " @p bra.uni WAIT;\n"
      " trap;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one TMA box of a 2-D tensor map to shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(bool on, void* dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " @p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n}\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"((int)on)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start, LBO and SBO in
// bytes (encoded >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma (its registers are written after the asm returns).
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int j = 0; j < kAcc; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

// d += A . B for A a 64 x 16 MN-major tile and B a 16 x 144 K-major tile
// (imm-trans-a 1, imm-trans-b 0), bf16 in, fp32 accumulate
__device__ __forceinline__ void wgmma_144(float (&d)[kAcc], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %74, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71},"
      " %72, %73, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(1));
}

// PyTorch's tanh approximation of GELU (its CUDA formula), in fp32.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// The byte offset of element e (of 64) of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ int swizzled(int r, int e) {
  return r * 128 + ((((e >> 3) ^ r) & 7) << 4) + (e & 7) * 2;
}

// kGateUp: phase 1 (w0 = Wg, w1 = Wu, act = x, dst = a_ws). Otherwise phase
// 2 (w0 = Wd, act = a_ws, dst = out). See the header.
template <bool kGateUp>
__global__ void __launch_bounds__(kThreads, 1)
ffn_kernel(const __grid_constant__ CUtensorMap w0, const __grid_constant__ CUtensorMap w1,
           const __grid_constant__ CUtensorMap act, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t full0 = smem_u32(ring + kRing);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, v = warp % 4, g = lane / 4, q = lane % 4;
  const bool producer = threadIdx.x == 0;

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, p.M - row0);  // valid rows of the block
  const bool two_halves = rows > kHalf;
  const int n0 = (kGateUp ? blockIdx.y : blockIdx.z) * kCols;
  const int slice = kGateUp ? 0 : blockIdx.y;
  const int k_begin = slice * p.slice_steps * kK;
  const int steps = max(0, min(p.slice_steps, p.K / kK - slice * p.slice_steps));

  if (producer) {
    for (int s = 0; s < kStages; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads of one step into its stage of the ring, issued by thread 0:
  // the weight tile(s) and the activation halves that hold rows
  const uint32_t bytes = (kGateUp ? 2 : 1) * kATile + (two_halves ? 2 : 1) * kBTile;
  auto issue = [&](int step) {
    const uint32_t bar = full0 + 8 * (step % kStages);
    uint8_t* s = ring + (step % kStages) * kStage;
    const int k = k_begin + step * kK;
    mbar_expect_tx(producer, bar, bytes);
    tma_load(producer, s, &w0, bar, n0, k);
    if (kGateUp) tma_load(producer, s + kATile, &w1, bar, n0, k);
    tma_load(producer, s + 2 * kATile, &act, bar, k, row0);
    if (two_halves) tma_load(producer, s + 2 * kATile + kBTile, &act, bar, k, row0 + kHalf);
  };
  for (int step = 0; step < min(steps, kStages); ++step) issue(step);

  // warpgroup wg: the weight tile(s) times its own half of the rows (a half
  // past M multiplies what its tile holds and is never stored)
  float acc0[kAcc], acc1[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc0[j] = acc1[j] = 0.f;
  for (int step = 0; step < steps; ++step) {
    const int st = step % kStages;
    mbar_wait(full0 + 8 * st, (step / kStages) & 1);
    const uint32_t s = smem_u32(ring + st * kStage);
    const uint64_t a0 = desc_sw128(s, kATile, 1024);
    const uint64_t a1 = desc_sw128(s + kATile, kATile, 1024);
    const uint64_t b = desc_sw128(s + 2 * kATile + wg * kBTile, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      // the k16 step: 16 rows of the weight tile (2048 bytes), 16 elements
      // of the activation rows (32 bytes), in units of 16 bytes
      wgmma_144(acc0, a0 + 128 * kk, b + 2 * kk);
      if (kGateUp) wgmma_144(acc1, a1 + 128 * kk, b + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done
    if (step > 0 && step - 1 + kStages < steps) {
      // both warpgroups are done with step - 1's stage: refill it
      asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
      issue(step - 1 + kStages);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc0);
  fence_acc(acc1);

  if (kGateUp) {
    // a = bf16(gelu_tanh(g) * u), staged over this warpgroup's activation
    // tile of stage 0 (every copy into it has landed), then 16-byte stores
    const int half_rows = min(kHalf, rows - wg * kHalf);
    if (half_rows <= 0) return;
    uint8_t* tile = ring + 2 * kATile + wg * kBTile;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int col = 16 * v + g + 8 * ((j >> 1) & 1);
      const int r = 8 * (j >> 2) + 2 * q + (j & 1);
      *reinterpret_cast<bf16*>(tile + swizzled(r, col)) =
          __float2bfloat16_rn(gelu_tanh(acc0[j]) * acc1[j]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    for (int c = threadIdx.x % 128; c < half_rows * 8; c += 128) {
      const int r = c >> 3, ch = c & 7;
      const uint4 val = *reinterpret_cast<const uint4*>(tile + swizzled(r, ch * 8));
      *reinterpret_cast<uint4*>(p.dst + (int64_t)(row0 + wg * kHalf + r) * p.ld + n0 + ch * 8) =
          val;
    }
    return;
  }

  // Phase 2: the S partials of the tile meet in the block that owns their
  // rows: block s owns rows [s R, s R + R) of the tile (R even, S R >= the
  // rows); recv[s'][c][r] (over the ring) holds slice s' partial at column
  // c, row s R + r.
  const int slices = gridDim.y;
  const int R = 2 * ceil_div(rows, 2 * slices);
  float* recv = reinterpret_cast<float*>(ring);
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  cluster.sync();  // every ring of the cluster is done with
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float* base = recv + (slice * kCols + 16 * v + g + 8 * x) * R;
#pragma unroll
    for (int nb = 0; nb < kHalf / 8; ++nb) {
      const int j = 4 * nb + 2 * x, row = wg * kHalf + 8 * nb + 2 * q;  // and row + 1
      if (row < rows) {
        const int owner = row / R;
        *reinterpret_cast<float2*>(cluster.map_shared_rank(base + row - owner * R, owner)) =
            make_float2(acc0[j], acc0[j + 1]);
      }
    }
  }
  cluster.sync();  // every partial is stored
  // the owned rows, 8 columns of a row at a time: the S parts added in slice
  // order, rounded once, one 16-byte store
  const int own = max(0, min(R, rows - slice * R));
  for (int e = threadIdx.x; e < own * (kCols / 8); e += kThreads) {
    const int r = e % own, c8 = e / own;
    uint32_t packed[4];
#pragma unroll
    for (int u = 0; u < 8; u += 2) {
      const float* c0 = recv + (8 * c8 + u) * R + r;
      float s0 = c0[0], s1 = c0[R];
      for (int s = 1; s < slices; ++s) {
        s0 = __fadd_rn(s0, c0[s * kCols * R]);
        s1 = __fadd_rn(s1, c0[s * kCols * R + R]);
      }
      const __nv_bfloat162 pair = __floats2bfloat162_rn(s0, s1);
      packed[u / 2] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(p.dst + (int64_t)(row0 + slice * R + r) * p.ld + n0 + 8 * c8) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// S, the slices of K of phase 2: the S in 1..8 (each slice at least
// kMinSliceSteps steps of 64) that least the steps of a slice times the
// waves its clusters take (kClusters at once), the smaller on a tie.
int slices_for(int M, int H, int I) {
  const int tiles = ceil_div(M, kRows) * (H / kCols);
  const int steps = I / kK;
  int best = 1, best_cost = steps * ceil_div(tiles, kClusters[1]);
  for (int s = 2; s <= kMaxSlices && steps >= s * kMinSliceSteps; ++s) {
    const int cost = ceil_div(steps, s) * ceil_div(tiles, kClusters[s]);
    if (cost < best_cost) best = s, best_cost = cost;
  }
  return best;
}

bool valid(int M, int H, int I) {
  return M > 0 && H >= 2 * kCols && H % (2 * kCols) == 0 && I >= kCols && I % kCols == 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A row-major bf16 [rows, cols] matrix read in boxes of box_rows rows by 64
// columns (128 bytes), 128-byte swizzle, zeros past its edge.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                   strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The geometry of an (M, H, I) FFN into grid[0..4]: phase 1 (row blocks of
// 288, column tiles of 64 of I); phase 2 (row blocks, S slices of K = I,
// column tiles of 64 of H), its cluster (1, S, 1). Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int blurr_fused_ffn_grid(int M, int H, int I, int* grid) {
  if (!valid(M, H, I)) return (int)cudaErrorInvalidValue;
  grid[0] = ceil_div(M, kRows);
  grid[1] = I / kCols;
  grid[2] = grid[0];
  grid[3] = slices_for(M, H, I);
  grid[4] = H / kCols;
  return 0;
}

// The most clusters of `size` blocks of phase 2 (1, size, 1) that the
// current card runs at once (cudaOccupancyMaxActiveClusters), into *out:
// what kClusters holds for an H100 SXM. Returns the cudaError_t.
extern "C" int blurr_fused_ffn_clusters(int size, int* out) {
  if (size < 1 || size > kMaxSlices) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(1, size, 1);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmem;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = size;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, ffn_kernel<false>, &config);
}

// x bf16 [M, H], wg and wu bf16 [H, I], wd bf16 [I, H], a_ws bf16 [M, I]
// (scratch), out bf16 [M, H], all contiguous and 16-byte aligned; H a
// multiple of 128, I a multiple of 64. Launches both phases on `stream`;
// returns the first cudaError_t.
extern "C" int blurr_fused_ffn(const void* x, const void* wg, const void* wu, const void* wd,
                               void* a_ws, void* out, int M, int H, int I, void* stream) {
  if (!valid(M, H, I)) return (int)cudaErrorInvalidValue;
  for (const void* p : {x, wg, wu, wd, (const void*)a_ws, (const void*)out})
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  if (!encoder()) return (int)cudaErrorNotSupported;
  CUtensorMap map_x, map_wg, map_wu, map_wd, map_a;
  if (!tensor_map(&map_x, x, M, H, kHalf) || !tensor_map(&map_wg, wg, H, I, kK) ||
      !tensor_map(&map_wu, wu, H, I, kK) || !tensor_map(&map_wd, wd, I, H, kK) ||
      !tensor_map(&map_a, a_ws, M, I, kHalf))
    return (int)cudaErrorInvalidValue;
  // more than 48 KB of shared memory must be allowed, once per kernel (not
  // again inside a CUDA graph capture)
  static const cudaError_t allowed = [] {
    cudaError_t e = cudaFuncSetAttribute(ffn_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ffn_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem);
  }();
  if (allowed != cudaSuccess) return (int)allowed;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = ceil_div(M, kRows);

  const Params gate_up = {static_cast<bf16*>(a_ws), M, H, I, H / kK};
  ffn_kernel<true><<<dim3(row_blocks, I / kCols), kThreads, kSmem, s>>>(map_wg, map_wu, map_x,
                                                                       gate_up);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int slices = slices_for(M, H, I);
  const Params down = {static_cast<bf16*>(out), M, I, H, ceil_div(I / kK, slices)};
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(row_blocks, slices, H / kCols);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmem;
  config.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = slices;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, ffn_kernel<false>, map_wd, map_wd, map_a, down);
}

extern "C" const char* blurr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
