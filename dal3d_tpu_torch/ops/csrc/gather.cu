// Fused gather-GEMM of the gather sparse-conv engine, and a row gather, for
// Hopper (sm_90a).
//
// gather_gemm_f32:
//   out[b, order[b, p], :] = sum_{k : rb[b, k, p] >= 0} feat[b, rb[b, k, p], :] @ w[k]
// feat [B, N, Cin], rb [B, K, M] int32 (-1 = miss) and order [B, M] int64 (a
// permutation of the output rows; null: p itself), w [K, Cin, Cout], out
// [B, M, Cout], all f32. The plan (rb, order) is made once per rulebook by
// ops/gather.py::gather_plan: for a rulebook several convs share, its rows
// grouped by their set of hit taps.
//
// Replaces the TPU kernel dal3d_tpu/ops/pallas_gather.py::gather_gemm_pallas
// (inner `kernel` + `_gather_tile`). That kernel walks a (batch, row tile,
// tap) grid in order, issues one DMA per gathered row into VMEM, contracts
// the tile on the MXU and carries the sum in VMEM scratch from one tap to the
// next; misses point at an appended zero row and the channels are padded to
// 128 lanes. Here blocks run in parallel with no order, so a block loops over
// the taps itself and keeps the sum in registers; a miss is a zero-filled
// copy (it adds exactly 0), and channels are padded to 4 only (16 bytes).
//
// Bound on the card: the f32-accurate products on the tensor cores in
// 3xTF32, 3 * 2 * hits * Cin * Cout operations at 495 TFLOP/s (or 2 * hits *
// Cin * Cout on the FMA units at 67 TFLOP/s, which is longer); the bytes
// (table, rulebook, weights, output; 40-95 MB a launch on the BEVFusion
// encoder) bound the L0 and L1 launches, the operations the L2 and L3 ones.
//
// Design:
//   - products on the tensor cores, mma.sync m16n8k8 TF32 with f32
//     accumulators, in 3xTF32: each operand is split in registers into big =
//     tf32(x) and small = tf32(x - big), both rounded to nearest with ties
//     away (cvt.rna; big by two integer operations that give the same bits
//     and leave the conversion unit to small, faster than a cvt for both:
//     tools/hopper_calibration.py times the step both ways), and
//     the sum takes small*big and big*small before big*big. Single-pass TF32
//     keeps about 3 decimal digits; the three passes keep f32's level. The
//     tensor cores' own f32 sum truncates, and a chain of some 1300 of them
//     through one accumulator (27 taps x 128 channels) drifted 1.5-1.9e-5 of
//     scale toward zero on the card; so each 8-channel step sums its three
//     products in fresh accumulators, added to the row's f32 sums with
//     round-to-nearest adds (unbiased: about 6e-7 of scale at every depth of
//     the path). On mma.sync this step reaches about 65 TFLOP/s of f32 work
//     (tools/hopper_calibration.py), the FMA units' peak: the splits and
//     adds, not the tensor cores, set its pace; wgmma is the step after.
//   - the walk: only 19 % of the (row, tap) pairs of a predict hit and the
//     L0 rows come in point order, so a tile of rows in that order touches
//     nearly every tap (256-, 128- and 64-row tiles of rows in that order
//     multiply 3.9x the hits over a predict). Each warp
//     skips the staging and the products of every tap none of its rows
//     hits, and the plan of a rulebook that several convs share groups its
//     rows by their hit mask (a stable sort on it): L0 1.68x the hits, L1
//     1.07, L2 1.11, L3 1.02. A rulebook used once (the strided convs)
//     keeps its rows' order, where the sort costs about what it saves.
//     Which tile a row lands in does not change its sum: a skipped or
//     zero-filled tap adds exact zeros, and every row sums its taps and Cin
//     chunks in the same order, so repeated calls give the same bits.
//   - one block of 8 warps per (128 plan positions, COUT output columns,
//     batch), COUT in {16, 32, 64, 128}: a block covers every output column
//     of the BEVFusion encoder's convs, so a gathered row is read once per
//     tap. Warp tiles 16 x COUT below COUT 64 (8 row groups of 16), 32 x
//     COUT/2 from it (4 row groups of 32, two warps each). Three blocks a
//     multiprocessor for the small tiles (COUT <= 32 with chunks of 16 or
//     fewer channels: the stem, L0 and ds1, whose blocks are short and
//     latency-bound), two for the others; 256-row blocks of 16 warps at
//     COUT 128 (half the w staging per row) measured slower.
//   - per (active tap, Cin chunk) step, 16-byte cp.async gathers of the rows
//     (zero fill for misses and the Cin edge) and of the w[k] chunk into a
//     ring, one barrier per step: chunks of 8 channels for the stem (Cin 5,
//     padded to 8), 16 for Cin 16 and 32 from Cin 32 on, with 4, 4 and 3
//     stages (2 at COUT 128, so that two blocks fit a multiprocessor); A
//     fragments by ldmatrix (an 8 x 8 b16 matrix is an 8 x 4 f32 one), B
//     fragments by 32-bit loads from w's [Cin][Cout] layout (ldmatrix.trans
//     cannot transpose 32-bit elements); row pitches padded so that both are
//     conflict-free. Splitting w once per launch instead, into (big, small)
//     pairs staged from memory, was slower: twice the w bytes a step.
//   - the epilogue writes each output row once, at its place order[p].
//   wgmma (both operands K-major in shared memory, split there) is not used
//   yet.
//
// gather_rows: out[m] = rows(table)[idx[m]] for a [B, R, C] table of any
// strides whose rows are taken in (batch, row) order, so that a permuted
// view needs no copy. One thread per 16-, 4-, 2- or 1-byte piece of an
// output row, so the output is written coalesced. Replaces
// dal3d_tpu/ops/pallas_gather.py::gather_rows (inner `kernel`). It moves a
// few hundred KB on the path, so it is bound by the launch, not the bytes.
// An index outside [0, B * R) gives a zero row (never an out-of-bounds read).
//
// gather_dw_f32: the weight gradient of gather_gemm_f32 for an output
// gradient g [B, M, Cout] (rows in output order), over the same plan:
//   dw[k] = sum_{b, p : rb[b, k, p] >= 0} feat[b, rb[b, k, p], :]^T g[b, order[b, p], :]
// JAX has no Pallas kernel here (XLA differentiates its gather_gemm); this is
// the port's own. Bound on the card: 2 * hits * Cin * Cout f32-accurate
// operations (3xTF32 on the tensor cores at 495 TFLOP/s, or the FMA units'
// 67 TFLOP/s), or the bytes of the features, rulebook, g and dw; the L2 and
// L3 convs of the BEVFusion encoder (Cin 64, 128) are bound by operations,
// the stem, L0 and L1 (Cin, Cout <= 32) by bytes. What held the first
// version (mma.sync, 16x its bound on a train step) was latency, not either
// bound: every 32-position step waited for its own gathers behind two
// barriers, and each warp split its operands again in registers.
//
// Design:
//   - one block per (share of the plan's 32-position chunks, tap, TI x TO
//     tile of dw; TI 16/32/64/128 of Cin, TO 16/32/64/128 of Cout); the block
//     first ballots which chunks of its share hit its tap (eight chunks a
//     warp in flight) and keeps their list in shared memory, so a chunk
//     without a hit costs one read of its 32 rulebook entries;
//   - products on TF32 wgmma, m64nNk8 with dw's Cin rows as M (two
//     warpgroups of 64 at TI = 128), its Cout columns as N (two warpgroups of
//     TO / 2 at TI <= 64, TO >= 64) and the plan positions as the reduction
//     axis; A (features) from registers, B (g) from shared memory, which TF32
//     wgmma takes K-major only: [channel][position], a chunk of 32 positions
//     one 128-byte row of the 128-byte swizzle (common.cuh::wgmma_desc_sw128),
//     written by the threads (TMA has no row gather);
//   - the gathers: 16-byte cp.async of the chunk's feature rows and g rows
//     (g through the plan's order; zero fill for misses and the Cin / Cout
//     edge) into a ring of 4 stages in [position][channel] order, issued 3
//     chunks ahead; the rulebook entries and output rows they need come into
//     an index ring by 4- and 8-byte cp.async 3 steps before that, so no
//     thread waits on a global load in the loop;
//   - B: one pass transposes the landed g chunk into the K-major planes and
//     splits each element there, once per block, into big = tf32(x) and
//     small = tf32(x - big) (round to nearest, as the forward); the planes
//     are double buffered, so this pass for chunk j runs while the tensor
//     cores take chunk j - 1, with one barrier a chunk. A: each thread reads
//     its m16n8k8 fragments of the chunk straight from the stage (a padded
//     row pitch keeps the reads on 32 banks) and splits them in registers.
//     Transposing A through shared memory too (and, in a later draft,
//     gathering both operands into K-major planes by 4-byte copies) left
//     the pass or the copies the longest part of a step;
//   - 3xTF32: small*big, big*small, big*big over the chunk's four k8 steps,
//     twelve wgmma into fresh accumulators, added to the block's f32 sums
//     with round-to-nearest adds: the tensor cores' own sum truncates, and a
//     tap's reduction can run to tens of thousands of positions, so no chain
//     through the tensor cores is longer than one chunk;
//   - each block writes its partial tile to scratch [shares, K, Cin, Cout];
//     gather_dw_reduce_kernel adds a tap's partials in share order. No float
//     atomics: a repeat gives the same bits.

// gather_gemm_bf16 and gather_dw_bf16: the same two functions on bf16
// features, weights and g, with f32 sums and each output rounded once to
// bf16, as JAX's gather_gemm computes in bf16 (its Pallas kernel takes the
// features' dtype). Bound on the card: the bytes, or 2 * hits * Cin * Cout
// at the 989 TFLOP/s bf16 tensor-core peak (a CBGS gather predict's 21
// launches by bytes; its L3 convs alone by operations).
//
// Design, both kernels:
//   - products on bf16 wgmma m64nNk16 (f32 accumulators) with both
//     operands in shared memory, in tiles stored in the 128-, 64- or
//     32-byte swizzle as wide as their rows (common.cuh swz_off,
//     wgmma_desc_sw). bf16 wgmma reads an operand in either major order,
//     so every tile is read as it was gathered: no transpose pass, no
//     ldmatrix;
//   - warp-specialised: a producer warpgroup gathers by 16-byte cp.async
//     (TMA has no row gather) straight to the swizzled places, each copy
//     landing on its ring stage's full mbarrier (cp.async.mbarrier.arrive
//     .noinc); the consumer warpgroups wait on it, and each consumer warp
//     releases the stage on its empty mbarrier once its products are done.
//     No block-wide barrier in the main loop. No setmaxnreg: no tile is
//     short of registers at the occupancy it runs at, and the m64n128 tile
//     needs 90 a thread, more than two 384-thread blocks leave (80);
//   - the bits: no atomics, f32 sums in a fixed order, one rounding, so a
//     repeat and the sorted plan give the same bits.
//
// gather_gemm_bf16:
//   - blocks of one consumer warpgroup (64 plan positions) at COUT 16, 32
//     and 128, of two (128) at COUT 64, all COUT columns, so a gathered row
//     is read once a tap; steps (active tap, Cin chunk of 16, 32 or 64
//     channels: one 32-, 64- or 128-byte swizzle row), A the gathered rows
//     (K-major), B w[k]'s chunk (MN-major, in atoms of 16, 32 or 64
//     columns); wgmma_wait<1> keeps one step's products in flight while
//     the next step's copies are awaited. Each warpgroup's 64 rows skip the
//     taps none of them hits: no row gathered, no product issued.
//   - Tile choices, measured on the CBGS gather backbone's launches (H100
//     SXM, 700 W; tools/kernel_ab.py's inputs): at COUT 128 one warpgroup
//     at two blocks a multiprocessor took its L3 convs in 0.091 ms a
//     launch, two warpgroups at one block 0.104 and four 0.101; at COUT 64
//     two warpgroups at two blocks 0.057 ms, one at three 0.059.
//   - The 64-row skip walks 1.418x a CBGS gather predict's hits against
//     1.253x for the f32 kernel's 16- and 32-row warp groups (L0 1.395 /
//     1.120, L1 1.332 / 1.120, L2 1.137 / 1.095, L3 1.035 / 1.022, the
//     strided 16 -> 32 conv 10.71 / 7.45; gemm_walk over the plans: the
//     launch arithmetic's model of the walk, its tiles held to the
//     build's by gather_bf16_tile in a card test). What
//     a small tile walks in vain is zero-filled copies (issue slots, no
//     bytes) and products of a few cycles: L0's launches take 0.019 ms on
//     this kernel against 0.024 for the mma.sync one of 16-row groups, so
//     no shape keeps mma.sync.
//
// gather_dw_bf16:
//   - one block per (share of the plan's 64-position chunks, tap, TI x TO
//     tile of dw), the share's chunks that hit the tap listed first;
//     wgmma's M the larger of the tile's Cin and Cout sides (dw^T where
//     Cout is larger: the strided convs' 16 -> 32, 32 -> 64, 64 -> 128),
//     one consumer warpgroup per 64 of it, N the other side; a tile side
//     below 64 is padded to wgmma's 64 rows (the padding rows read whatever
//     the stage holds and are dropped: a small tile is bound by its bytes,
//     not by the products). A chunk is one stage, 4 k16 steps, with both
//     gathered operands MN-major;
//   - the producer takes two threads a position; a slot's rulebook entries
//     and output rows are loaded into registers 4 slots ahead, so no copy
//     waits on a global load;
//   - each chunk's products go into fresh accumulators, added to the sums
//     with round-to-nearest adds (a model of it holds 1.7e-6 of scale over
//     the L0 centre tap's 120000 positions, where one truncating chain
//     drifts 1.6e-4); a chain of two chunks under wgmma_wait<1> measured
//     the same and ptxas serialised it, so each chunk is waited for;
//   - the shares: 4 waves of the blocks the card holds (1.49 ms a CBGS
//     gather step's 21 launches against 1.76 at the f32 kernel's 8: a
//     block's listing, fill and partial tile amortised over a longer
//     share); partial tiles in f32, added in share order by
//     gather_dw_reduce_kernel.
//
// Alignment contract of gather_gemm_f32 (checked by the Python wrapper):
// Cin % 4 == 0 (bf16: Cin % 16 == 0), Cout is 16, 32, 64 or a multiple of
// 128, K <= 32, pointers 16-byte aligned, contiguous.

#include "common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using namespace dal3d;

constexpr int THREADS = 256;
constexpr int BM = 128;  // plan positions of a gather-GEMM block
constexpr int MAX_TAPS = 32;

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small + O(2^-22 |x|), both exact in TF32, rounded to nearest
// with ties away from zero. big takes the bits cvt.rna.tf32 gives for every
// finite value and infinity (add half of the 13 dropped bits to the
// magnitude, clear them) by two integer operations, which leave the
// conversion unit to small = cvt.rna.tf32(x - big); a NaN passes on through
// small.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The prologue of a gather-GEMM block of NT threads: its plan positions m0
// .. m0 + ROWS - 1 of batch element b. Stages their rulebook entries
// sidx[k * ROWS + r] (-1 past M) and output rows sorder[r] (-1 past M), the
// taps each row group of WM rows hits (gmask, one bit a tap) and the block
// hits (bmask). The first ROWS / S warps look at S = min(WM, 32) rows each,
// in order, and OR what they see into their group's mask.
template <int ROWS, int NT, int WM>
__device__ __forceinline__ void stage_block(const int* __restrict__ rbb,
                                            const long long* __restrict__ order, int b, int K,
                                            int M, int m0, int* sidx, int* sorder,
                                            unsigned* gmask, unsigned* bmask) {
  constexpr int S = WM < 32 ? WM : 32;
  static_assert(ROWS % WM == 0 && WM % S == 0 && ROWS / S <= NT / 32, "row groups");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    *bmask = 0;
    for (int g = 0; g < ROWS / WM; ++g) gmask[g] = 0;
  }
  for (int e = tid; e < K * ROWS; e += NT) {
    const int k = e / ROWS, r = e - k * ROWS, m = m0 + r;
    sidx[e] = m < M ? rbb[(size_t)k * M + m] : -1;
  }
  for (int r = tid; r < ROWS; r += NT) {
    const int m = m0 + r;
    sorder[r] = m >= M ? -1 : (order ? static_cast<int>(order[(size_t)b * M + m]) : m);
  }
  __syncthreads();
  if (warp < ROWS / S) {  // the taps the warp's rows hit: one bit per tap
    unsigned wmask = 0;
    for (int k = 0; k < K; ++k) {
      const bool h = lane < S && sidx[k * ROWS + warp * S + lane] >= 0;
      wmask |= (__any_sync(0xffffffffu, h) ? 1u : 0u) << k;
    }
    if (lane == 0 && wmask) {
      atomicOr(&gmask[warp * S / WM], wmask);
      atomicOr(bmask, wmask);
    }
  }
  __syncthreads();
}

// The ring of a gather-GEMM block: the (active tap, Cin chunk) steps of the
// taps the block hits, nk chunks a tap, in order, STAGES - 1 in flight and
// one barrier a step. load(stage, tap, chunk) issues a step's copies;
// compute(stage) multiplies a landed step, in the warps whose row group
// hits its tap (wmask). Called by every thread of the block together.
template <int STAGES, typename Load, typename Compute>
__device__ __forceinline__ void tap_ring(unsigned taps, int nk, unsigned wmask, Load load,
                                         Compute compute) {
  const int steps = __popc(taps) * nk;
  unsigned lrem = taps;
  int lk = taps ? __ffs(taps) - 1 : 0, lc = 0;
  auto load_next = [&](int stage) {
    load(stage, lk, lc);
    if (++lc == nk) {
      lc = 0;
      lrem &= lrem - 1;
      lk = lrem ? __ffs(lrem) - 1 : 0;
    }
  };
#pragma unroll 1
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < steps) load_next(p);
    cp_async_commit();
  }
  unsigned crem = taps;
  int ck = taps ? __ffs(taps) - 1 : 0, cc = 0;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // step s has landed (this thread's copies)
    __syncthreads();              // ... everyone's; the stage of step s - 1 is free
    if (s + STAGES - 1 < steps) load_next((s + STAGES - 1) % STAGES);
    cp_async_commit();
    if ((wmask >> ck) & 1u) compute(s % STAGES);
    if (++cc == nk) {
      cc = 0;
      crem &= crem - 1;
      ck = crem ? __ffs(crem) - 1 : 0;
    }
  }
  cp_async_wait<0>();
}

template <int COUT, int BK>
struct Tile {
  static constexpr int STAGES = BK < 32 ? 4 : (COUT == 128 ? 2 : 3);  // cp.async ring
  // blocks a multiprocessor holds: 3 of the small tiles (L0, the stem, ds1)
  static constexpr int MIN_BLOCKS = COUT <= 32 && BK <= 16 ? 3 : 2;
  static constexpr int WARPS_M = COUT >= 64 ? 4 : 8;  // row groups
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;     // rows of a warp: 16 or 32
  static constexpr int WN = COUT / WARPS_N;   // columns of a warp
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = BK + 4;          // floats: ldmatrix rows on 8 bank groups
  static constexpr int LDW = COUT + 8;        // floats: B loads on 32 banks
  static constexpr int A_STAGE = BM * LDA;
  static constexpr int STAGE = A_STAGE + BK * LDW;
  static constexpr int TILE_BYTES = STAGES * STAGE * 4;
  static_assert(BK % 8 == 0 && WN % 8 == 0 && WM % 16 == 0, "tile shape");
};

template <int COUT, int BK>
__global__ void __launch_bounds__(THREADS, Tile<COUT, BK>::MIN_BLOCKS)
gather_gemm_kernel(const float* __restrict__ feat, const int* __restrict__ rb,
                   const long long* __restrict__ order, const float* __restrict__ w,
                   float* __restrict__ out, int N, int Cin, int K, int M, int Cout) {
  using T = Tile<COUT, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);                // [STAGES][A | W]
  int* sidx = reinterpret_cast<int*>(smem + T::TILE_BYTES);     // [K][BM]
  __shared__ int sorder[BM];
  __shared__ unsigned gmask[T::WARPS_M];  // taps hit by each row group
  __shared__ unsigned bmask;              // taps hit by the block

  const int b = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * COUT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const float* fb = feat + (size_t)b * N * Cin;
  const int* rbb = rb + (size_t)b * K * M;

  stage_block<BM, THREADS, T::WM>(rbb, order, b, K, M, m0, sidx, sorder, gmask, &bmask);
  const unsigned wmask = gmask[wm];  // the taps this warp's row group hits

  // step (tap lk, chunk lc): gathers only the rows of the row groups that
  // hit tap lk (the others' stale rows are never read)
  auto load = [&](int stage, int lk, int lc) {
    float* a = tiles + stage * T::STAGE;
    float* ws = a + T::A_STAGE;
    const int c0 = lc * BK;
    constexpr int CPR = BK / 4;  // 16-byte pieces of a row chunk
    for (int e = tid; e < BM * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * 4;
      if (!((gmask[r / T::WM] >> lk) & 1u)) continue;
      const int src = sidx[lk * BM + r];
      const bool ok = src >= 0 && c0 + c < Cin;
      cp_async16(a + r * T::LDA + c, ok ? fb + (size_t)src * Cin + c0 + c : fb, ok);
    }
    const float* wk = w + (size_t)lk * Cin * Cout + n0;
    constexpr int CPW = COUT / 4;
    for (int e = tid; e < BK * CPW; e += THREADS) {
      const int r = e / CPW, c = (e % CPW) * 4;
      const bool ok = c0 + r < Cin;
      cp_async16(ws + r * T::LDW + c, ok ? wk + (size_t)(c0 + r) * Cout + c : w, ok);
    }
  };

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int g = lane / 4, t = lane % 4;
  // ldmatrix: lanes 8q..8q+7 address matrix q = (rows +8 if q odd, k +4 if q >= 2)
  const int a_row = wm * T::WM + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 4;
  auto compute = [&](int stage) {
    const float* a = tiles + stage * T::STAGE;
    const float* ws = a + T::A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ab[T::MT][4], as[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        uint32_t r[4];
        ldmatrix_x4(r, a + (a_row + i * 16) * T::LDA + kk + a_col);
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(r[q]), ab[i][q], as[i][q]);
      }
      // two column tiles at a time: 2 * MT independent accumulators per pass
#pragma unroll
      for (int j0 = 0; j0 < T::NT; j0 += 2) {
        uint32_t bb[2][2], bs[2][2];
        float part[T::MT][2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = wn * T::WN + (j0 + jj) * 8 + g;
          split_tf32(ws[(kk + t) * T::LDW + n], bb[jj][0], bs[jj][0]);
          split_tf32(ws[(kk + t + 4) * T::LDW + n], bb[jj][1], bs[jj][1]);
#pragma unroll
          for (int i = 0; i < T::MT; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) part[i][jj][q] = 0.0f;
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < T::MT; ++i) mma_tf32_1688(part[i][jj], as[i], bb[jj][0], bb[jj][1]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < T::MT; ++i) mma_tf32_1688(part[i][jj], ab[i], bs[jj][0], bs[jj][1]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < T::MT; ++i) mma_tf32_1688(part[i][jj], ab[i], bb[jj][0], bb[jj][1]);
        // the tensor cores' sum truncates: a long chain of them drifts toward
        // zero, so each 8-channel step is added to the sums in f32 (nearest)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < T::MT; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j0 + jj][q] += part[i][jj][q];
      }
    }
  };

  tap_ring<T::STAGES>(bmask, (Cin + BK - 1) / BK, wmask, load, compute);

  // C fragment: c0, c1 at (g, 2t + {0, 1}), c2, c3 at (g + 8, 2t + {0, 1})
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = sorder[wm * T::WM + i * 16 + h * 8 + g];
      if (m < 0) continue;
      float* o = out + ((size_t)b * M + m) * Cout + n0 + wn * T::WN + 2 * t;
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
        *reinterpret_cast<float2*>(o + j * 8) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  }
}

template <int COUT, int BK>
int launch_gather_gemm(const float* feat, const int* rb, const long long* order,
                       const float* w, float* out, int B, int N, int Cin, int K, int M, int Cout,
                       cudaStream_t stream) {
  using T = Tile<COUT, BK>;
  const size_t smem = T::TILE_BYTES + (size_t)K * BM * 4;
  // set on every launch: the static arrays count against the 48 KB default too
  cudaError_t e = cudaFuncSetAttribute(gather_gemm_kernel<COUT, BK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + BM - 1) / BM, Cout / COUT, B);
  gather_gemm_kernel<COUT, BK><<<grid, THREADS, smem, stream>>>(feat, rb, order, w, out, N,
                                                                Cin, K, M, Cout);
  return static_cast<int>(cudaGetLastError());
}

template <int COUT>
int dispatch_bk(const float* feat, const int* rb, const long long* order, const float* w,
                float* out, int B, int N, int Cin, int K, int M, int Cout, cudaStream_t stream) {
  if (Cin <= 8)
    return launch_gather_gemm<COUT, 8>(feat, rb, order, w, out, B, N, Cin, K, M, Cout, stream);
  if (Cin <= 16)
    return launch_gather_gemm<COUT, 16>(feat, rb, order, w, out, B, N, Cin, K, M, Cout, stream);
  return launch_gather_gemm<COUT, 32>(feat, rb, order, w, out, B, N, Cin, K, M, Cout, stream);
}

// ---- gather_gemm_bf16 --------------------------------------------------------
//
// (the design and its measurements: the note on the bf16 kernels above)

constexpr int PATH_TAPS = 27;  // the path's largest tap count: sizes the rings below

template <int COUT, int BK>
struct WgTile {
  static constexpr int NWG = COUT == 64 ? 2 : 1;   // consumer warpgroups, 64 rows each
  static constexpr int WR = 64;                     // rows that skip a tap together: wgmma's M
  static constexpr int BMW = WR * NWG;              // plan positions of a block
  static constexpr int THREADS = 128 * (NWG + 1);   // and the producer warpgroup
  static constexpr int NA = COUT < 64 ? COUT : 64;  // columns of a B swizzle atom
  static constexpr int RA = BK * 2, RB = NA * 2;    // bytes of an A row, of a B atom row
  static constexpr int A_BYTES = BMW * RA;          // [BMW rows][BK], K-major
  static constexpr int B_BYTES = BK * COUT * 2;     // [COUT / NA][BK][NA], MN-major
  static constexpr int STAGE = (A_BYTES + B_BYTES + 1023) / 1024 * 1024;
  static constexpr int MIN_BLOCKS = COUT >= 64 ? 2 : 4;
  // the ring: what MIN_BLOCKS blocks leave of a multiprocessor (1 KB each
  // reserved) after the alignment slack, the rulebook of PATH_TAPS taps,
  // the barriers and the static arrays; at most 8 stages
  static constexpr int FIXED = 1024 + PATH_TAPS * BMW * 4 + 16 * 8 + BMW * 4 + 16;
  static constexpr int FIT = (232448 / MIN_BLOCKS - 1024 - FIXED) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static_assert(BK == 16 || BK == 32 || BK == 64, "Cin chunks of 16, 32 or 64");
  static_assert(STAGES >= 3, "ring");
};

template <int COUT, int BK>
__global__ void __launch_bounds__(WgTile<COUT, BK>::THREADS, WgTile<COUT, BK>::MIN_BLOCKS)
gather_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ rb,
                        const long long* __restrict__ order, const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, int N, int Cin, int K, int M, int Cout) {
  using T = WgTile<COUT, BK>;
  extern __shared__ unsigned char dsm_gemm[];
  unsigned char* sm = dsm_gemm + ((1024u - (smem_u32(dsm_gemm) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  int* sidx = reinterpret_cast<int*>(empty + T::STAGES);  // [K][BMW]
  __shared__ int sorder[T::BMW];
  __shared__ unsigned gmask[T::NWG];  // taps hit by each consumer warpgroup's rows
  __shared__ unsigned bmask;          // taps hit by the block

  const int b = blockIdx.z, m0 = blockIdx.x * T::BMW, n0 = blockIdx.y * COUT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* rbb = rb + (size_t)b * K * M;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 128);                 // the producer's threads
      mbar_init(&empty[s], 4 * T::NWG);         // the consumers' warps
    }
    fence_mbar_init();
  }
  stage_block<T::BMW, T::THREADS, T::WR>(rbb, order, b, K, M, m0, sidx, sorder, gmask, &bmask);
  const unsigned taps = bmask;
  const int nk = (Cin + BK - 1) / BK, steps = __popc(taps) * nk;

  if (warp >= 4 * T::NWG) {
    // the producer: step s (active tap k, Cin chunk c, in order) into stage
    // s % STAGES once the consumers have released its last use; the rows of
    // the warpgroups that hit tap k (zero fill for misses and the Cin edge)
    // and w[k]'s chunk, 16-byte cp.async to swizzled places, all landing on
    // the stage's full barrier
    const int pt = tid - 128 * T::NWG;
    const __nv_bfloat16* fb = feat + (size_t)b * N * Cin;
    // A: thread pt takes piece pa of rows ra0 + RPI i of each warpgroup's 64
    // (RPI a multiple of 8, so the swizzle of those rows is ra0's); B: piece
    // qb of w rows rb0 + WPI i, in atom qb / CPA
    constexpr int CPR = BK / 8, RPI = 128 / CPR;      // 16-byte pieces of a row chunk
    constexpr int CPW = COUT / 8, CPA = T::NA / 8, WPI = 128 / CPW;
    constexpr int BPT = (BK * CPW + 127) / 128;       // B pieces a thread
    const int ra0 = pt / CPR, pa = pt % CPR, rb0 = pt / CPW, qb = pt % CPW;
    const uint32_t aoff = swz_off<T::RA>(ra0, pa);
    const uint32_t boff = (qb / CPA) * (BK * T::RB) + swz_off<T::RB>(rb0, qb % CPA);
    unsigned masks[T::NWG];
#pragma unroll
    for (int g = 0; g < T::NWG; ++g) masks[g] = gmask[g];
    unsigned rem = taps;
    int k = taps ? __ffs(taps) - 1 : 0, c = 0;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const int st = s % T::STAGES;
      if (s >= T::STAGES) mbar_wait(&empty[st], ((s / T::STAGES) - 1) & 1);
      unsigned char* a = sm + st * T::STAGE;
      unsigned char* bt = a + T::A_BYTES;
      const int c0 = c * BK;
      const bool a_in = c0 + pa * 8 < Cin;
      const int* sk = sidx + k * T::BMW;
#pragma unroll
      for (int g = 0; g < T::NWG; ++g) {
        if (!((masks[g] >> k) & 1u)) continue;  // no row of warpgroup g hits tap k
        int src[64 / RPI];
#pragma unroll
        for (int i = 0; i < 64 / RPI; ++i) src[i] = sk[64 * g + RPI * i + ra0];
#pragma unroll
        for (int i = 0; i < 64 / RPI; ++i) {
          const bool ok = src[i] >= 0 && a_in;
          cp_async16(a + aoff + (64 * g + RPI * i) * T::RA,
                     ok ? fb + (size_t)src[i] * Cin + c0 + pa * 8 : fb, ok);
        }
      }
      const __nv_bfloat16* wk = w + (size_t)k * Cin * Cout + n0 + qb * 8;
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        const int r = rb0 + WPI * i;
        if ((BK * CPW) % 128 != 0 && r >= BK) break;
        const bool ok = c0 + r < Cin;
        cp_async16(bt + boff + WPI * i * T::RB, ok ? wk + (size_t)(c0 + r) * Cout : w, ok);
      }
      cp_async_mbar_arrive(&full[st]);
      if (++c == nk) {
        c = 0;
        rem &= rem - 1;
        k = rem ? __ffs(rem) - 1 : 0;
      }
    }
    cp_async_wait<0>();
    return;
  }

  // the consumers: warpgroup wg multiplies rows 64 wg .. of every step whose
  // tap its rows hit, one step's products in flight while it waits for the
  // next (a stage is released once its products are done), and passes over
  // the others (released at once: nothing reads them)
  const int wg = warp / 4, t = tid % 128;
  const unsigned mine = gmask[wg];
  float acc[COUT / 2];
#pragma unroll
  for (int q = 0; q < COUT / 2; ++q) acc[q] = 0.0f;
  int pending = -1;  // the stage whose products may be in flight
  unsigned rem = taps;
  int k = taps ? __ffs(taps) - 1 : 0, c = 0;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int st = s % T::STAGES;
    mbar_wait(&full[st], (s / T::STAGES) & 1);
    if ((mine >> k) & 1u) {
      fence_proxy_async();  // the landed copies, to the tensor cores' reads
      const unsigned char* a = sm + st * T::STAGE;
      const uint64_t da = wgmma_desc_sw<T::RA>(a + wg * 64 * T::RA, 16, 8 * T::RA);
      const uint64_t db = wgmma_desc_sw<T::RB>(a + T::A_BYTES, BK * T::RB, 8 * T::RB);
      wgmma_fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_bf16<COUT, 0, 1>(acc, da + 2 * kk, db + ((16 * T::RB * kk) >> 4), 1);
      wgmma_commit();
      wgmma_wait<1>();
      wgmma_fence_operands(acc);
      if (pending >= 0 && lane == 0) mbar_arrive(&empty[pending]);
      pending = st;
    } else {
      if (pending >= 0) {  // released before a later step can need its stage
        wgmma_wait<0>();
        wgmma_fence_operands(acc);
        if (lane == 0) mbar_arrive(&empty[pending]);
        pending = -1;
      }
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    if (++c == nk) {
      c = 0;
      rem &= rem - 1;
      k = rem ? __ffs(rem) - 1 : 0;
    }
  }
  wgmma_wait<0>();
  wgmma_fence_operands(acc);

  // thread t holds acc[4 j + q] at row 16 (t / 32) + (t % 32) / 4 + 8 (q / 2)
  // of the warpgroup's 64, column 8 j + 2 (t % 4) + q % 2; each output row
  // written once at its place, rounded once to bf16 (nearest)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = sorder[wg * 64 + 16 * (t / 32) + (t % 32) / 4 + 8 * h];
    if (m < 0) continue;
    __nv_bfloat16* o = out + ((size_t)b * M + m) * Cout + n0 + 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < COUT / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <int COUT, int BK>
int launch_gather_gemm_bf16(const __nv_bfloat16* feat, const int* rb, const long long* order,
                            const __nv_bfloat16* w, __nv_bfloat16* out, int B, int N, int Cin,
                            int K, int M, int Cout, cudaStream_t stream) {
  using T = WgTile<COUT, BK>;
  const size_t smem = 1024 + T::STAGES * (T::STAGE + 16) + (size_t)K * T::BMW * 4;
  cudaError_t e = cudaFuncSetAttribute(gather_gemm_bf16_kernel<COUT, BK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + T::BMW - 1) / T::BMW, Cout / COUT, B);
  gather_gemm_bf16_kernel<COUT, BK><<<grid, T::THREADS, smem, stream>>>(feat, rb, order, w, out,
                                                                       N, Cin, K, M, Cout);
  return static_cast<int>(cudaGetLastError());
}

template <int COUT>
int dispatch_bk_bf16(const __nv_bfloat16* feat, const int* rb, const long long* order,
                     const __nv_bfloat16* w, __nv_bfloat16* out, int B, int N, int Cin, int K,
                     int M, int Cout, cudaStream_t stream) {
  if (Cin <= 16)
    return launch_gather_gemm_bf16<COUT, 16>(feat, rb, order, w, out, B, N, Cin, K, M, Cout,
                                             stream);
  if (Cin <= 32)
    return launch_gather_gemm_bf16<COUT, 32>(feat, rb, order, w, out, B, N, Cin, K, M, Cout,
                                             stream);
  return launch_gather_gemm_bf16<COUT, 64>(feat, rb, order, w, out, B, N, Cin, K, M, Cout,
                                           stream);
}

template <typename V>
__global__ void gather_rows_kernel(const unsigned char* __restrict__ table,
                                   const int* __restrict__ idx, V* __restrict__ out,
                                   long long total, int pieces, long long rows, long long R,
                                   long long sb, long long sr, long long sp) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long m = e / pieces;
    const long long p = e - m * pieces;
    const long long src = idx[m];
    V v{};
    if (src >= 0 && src < rows) {
      const long long bb = src / R;
      v = *reinterpret_cast<const V*>(table + bb * sb + (src - bb * R) * sr + p * sp);
    }
    out[e] = v;
  }
}

template <typename V>
int launch_gather_rows(const void* table, const int* idx, void* out, int M, int pieces,
                       long long rows, long long R, long long sb, long long sr, long long sp,
                       cudaStream_t stream) {
  const long long total = (long long)M * pieces;
  const long long blocks = (total + THREADS - 1) / THREADS;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), THREADS, 0,
                          stream>>>(static_cast<const unsigned char*>(table), idx,
                                    static_cast<V*>(out), total, pieces, rows, R, sb, sr, sp);
  return static_cast<int>(cudaGetLastError());
}


// ---- gather_dw_f32 -----------------------------------------------------------

constexpr int DW_CH = 32;             // plan positions of a chunk: one 128-byte K-major row
constexpr int DW_MAX_CHUNKS = 256;    // chunks of a share
constexpr int DW_STAGES = 4;          // cp.async ring of gathered chunks
constexpr int DW_AHEAD = DW_STAGES - 1;  // a slot's gathers are issued this many steps ahead
constexpr int DW_LEAD = DW_AHEAD;     // and its rulebook entries this many steps before that
constexpr int DW_IDX = 8;             // ring of rulebook entries and output rows
// static shared memory of a dW block: the chunk list, the index ring, the count
constexpr int DW_STATIC = DW_MAX_CHUNKS * 8 + DW_IDX * DW_CH * 12 + 16;

// A block's (TI x TO) tile of dw: TI rows of Cin (16, 32, 64 or 128) by TO
// columns of Cout (16, 32, 64 or 128). Warpgroups: two along Cin at TI =
// 128 (64 rows each, wgmma's M), two along Cout from TO = 64 on below that
// (TO / 2 columns each, wgmma's N), else one. Dynamic shared memory,
// 1024-byte aligned: two buffers of B's big and small TF32 planes ([TO][32
// positions], 128-byte K-major rows in the swizzle of wgmma_desc_sw128),
// then the ring of DW_STAGES gathered chunks, [32 positions][TI + 4]
// features (the pitch keeps the A fragments' loads on 32 banks) and [32][TO]
// g. ops/gather.py::_dw_blocks_per_sm mirrors SMEM + DW_STATIC.
// The chunks of a dW block's share (chunks c_begin .. c_begin + n_ch - 1 of
// tc a batch element, CH positions each) that hit tap k, in order, into
// clist as (batch element, first position); returns their count. 8 chunks
// a warp a round (their rulebook reads in flight together), one byte a
// chunk of flags in the scratch `flag` (n_ch bytes); count is a shared int.
template <int WARPS, int CH>
__device__ __forceinline__ int list_hit_chunks(const int* __restrict__ rb, int k, int K, int M,
                                               int tc, int c_begin, int n_ch, unsigned char* flag,
                                               int2* clist, int* count) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c0 = warp * 8; c0 < n_ch; c0 += WARPS * 8) {
    int v[8][CH / 32];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int cc = c_begin + c0 + u, b = cc / tc;
#pragma unroll
      for (int h = 0; h < CH / 32; ++h) {
        const int p = (cc - b * tc) * CH + 32 * h + lane;
        v[u][h] = c0 + u < n_ch && p < M ? __ldg(rb + ((size_t)b * K + k) * M + p) : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      bool any = false;
#pragma unroll
      for (int h = 0; h < CH / 32; ++h) any |= v[u][h] >= 0;
      const unsigned m = __ballot_sync(0xffffffffu, any);
      if (lane == 0 && c0 + u < n_ch) flag[c0 + u] = m != 0u;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_ch; base += 32) {
      const bool f = base + lane < n_ch && flag[base + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) {
        const int cc = c_begin + base + lane, b = cc / tc;
        clist[n + __popc(m & ((1u << lane) - 1u))] = make_int2(b, (cc - b * tc) * CH);
      }
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

template <int TI, int TO>
struct DwTile {
  static constexpr int WGM = TI == 128 ? 2 : 1;
  static constexpr int WGN = TI <= 64 && TO >= 64 ? 2 : 1;
  static constexpr int THREADS = 128 * WGM * WGN;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int NW = TO / WGN;  // columns of a warpgroup
  static constexpr int LDA = TI + 4;   // floats: a feature row of a stage
  static constexpr int B_BYTES = TO * 128, BUF = 2 * B_BYTES;
  static constexpr int RAW = DW_CH * (LDA + TO) * 4;  // bytes of a ring stage
  static constexpr int REGION = 2 * BUF + DW_STAGES * RAW;
  static constexpr int SMEM = 1024 + REGION;  // + the alignment slack
  // blocks a multiprocessor holds (232448 bytes, 1 KB reserved a block)
  static constexpr int FIT = 232448 / (SMEM + DW_STATIC + 1024);
  static constexpr int MIN_BLOCKS = FIT < 1 ? 1 : (FIT > 2048 / THREADS ? 2048 / THREADS : FIT);
  static constexpr int PIECES = (TI + TO) / 4;  // 16-byte pieces of a position's two rows
  static constexpr int TPP = THREADS / DW_CH;   // threads of a position's gathers
  static constexpr int GROUPS = TO * 8;         // (row, 4 positions) groups of B in a chunk
  static constexpr int SPLITS = (GROUPS + THREADS - 1) / THREADS;  // groups a thread
  static_assert(TI % 16 == 0 && TO % 16 == 0 && TI <= 128 && TO <= 128, "dw tile");
  static_assert(DW_IDX >= DW_AHEAD + DW_LEAD, "index ring");
};

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  if constexpr (N == 128) wgmma_m64n128k8_tf32_rs(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k8_tf32_rs(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_m64n32k8_tf32_rs(d, a, b, scale_d);
  else wgmma_m64n16k8_tf32_rs(d, a, b, scale_d);
}

template <int TI, int TO>
__global__ void __launch_bounds__(DwTile<TI, TO>::THREADS, DwTile<TI, TO>::MIN_BLOCKS)
gather_dw_kernel(const float* __restrict__ feat, const int* __restrict__ rb,
                 const long long* __restrict__ order, const float* __restrict__ g,
                 float* __restrict__ part, int N, int Cin, int K, int M, int Cout, int chunks,
                 int cps, int tiles_o) {
  using T = DwTile<TI, TO>;
  constexpr int PA = TI / 4;  // 16-byte pieces of a feature row
  extern __shared__ unsigned char dsm_raw[];
  unsigned char* sm = dsm_raw + ((1024u - (smem_u32(dsm_raw) & 1023u)) & 1023u);
  float* ring = reinterpret_cast<float*>(sm + 2 * T::BUF);
  __shared__ int2 clist[DW_MAX_CHUNKS];      // listed chunks: (batch element, first position)
  __shared__ int ridx[DW_IDX][DW_CH];        // rulebook entries of a slot's positions
  __shared__ long long oidx[DW_IDX][DW_CH];  // their output rows (order)
  __shared__ int count;

  const int s = blockIdx.x, k = blockIdx.y;
  const int i0 = (blockIdx.z / tiles_o) * TI, o0 = (blockIdx.z % tiles_o) * TO;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tc = (M + DW_CH - 1) / DW_CH;  // chunks of one batch element
  const int c_begin = s * cps;
  const int n_ch = min(c_begin + cps, chunks) - c_begin;

  const int nh = list_hit_chunks<T::WARPS, DW_CH>(rb, k, K, M, tc, c_begin, n_ch,
                                                  reinterpret_cast<unsigned char*>(ring), clist,
                                                  &count);

  // slot j's rulebook entries (warp 0) and output rows (warp 1) into the
  // index ring by 4- and 8-byte cp.async: no thread waits on them
  auto fetch = [&](int j) {
    if (j >= nh || warp > 1) return;
    const int2 c = clist[j];
    const int pos = c.y + lane;
    const bool ok = pos < M;
    if (warp == 0)
      cp_async4(&ridx[j % DW_IDX][lane], ok ? rb + ((size_t)c.x * K + k) * M + pos : rb, ok);
    else if (order != nullptr)
      cp_async8(&oidx[j % DW_IDX][lane], ok ? order + (size_t)c.x * M + pos : order, ok);
  };
  // the gathers of slot j into ring stage `stage`, 16-byte cp.async: thread
  // tid takes position p = tid / TPP, pieces sub, sub + TPP, ... of its
  // feature row then its g row; zero fill for misses and the Cin / Cout edge
  const int p = tid / T::TPP, sub = tid % T::TPP;
  auto load = [&](int j, int stage) {
    const int2 c = clist[j];
    const int pos = c.y + p;
    const int v = pos < M ? ridx[j % DW_IDX][p] : -1;
    const int o = order != nullptr ? static_cast<int>(oidx[j % DW_IDX][p]) : pos;
    float* ra = ring + stage * (T::RAW / 4);
    const bool h = v >= 0;
    const float* fr = feat + ((size_t)c.x * N + (h ? v : 0)) * Cin + i0;
    const float* gr = g + ((size_t)c.x * M + (h ? o : 0)) * Cout + o0;
#pragma unroll
    for (int q = sub; q < T::PIECES; q += T::TPP) {
      const bool is_a = q < PA;
      const int cc = 4 * (is_a ? q : q - PA);
      const bool ok = h && (is_a ? i0 + cc < Cin : o0 + cc < Cout);
      float* dst = is_a ? ra + p * T::LDA + cc : ra + DW_CH * T::LDA + p * TO + cc;
      cp_async16(dst, ok ? (is_a ? fr : gr) + cc : feat, ok);
    }
  };
  // B: the staged g chunk transposed into the K-major planes of buffer bf
  // and split there, once for the block, into big = tf32(x) and small =
  // tf32(x - big) (round to nearest, ties away, as the forward); a thread
  // takes (row, 4 positions) groups, consecutive lanes consecutive rows
  // (conflict-free reads of the [position][row] stage, 16-byte swizzled
  // writes). All of a thread's reads come before its writes: the compiler
  // cannot tell the planes from the stage.
  auto split_b = [&](int stage, int bf) {
    const float* rg = ring + stage * (T::RAW / 4) + DW_CH * T::LDA;
    unsigned char* tb = sm + bf * T::BUF;
    float x[T::SPLITS][4];
#pragma unroll
    for (int it = 0; it < T::SPLITS; ++it) {
      const int e = tid + it * T::THREADS, pq = e / TO, row = e - pq * TO;
      if (T::GROUPS % T::THREADS != 0 && e >= T::GROUPS) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) x[it][r] = rg[(4 * pq + r) * TO + row];
    }
#pragma unroll
    for (int it = 0; it < T::SPLITS; ++it) {
      const int e = tid + it * T::THREADS, pq = e / TO, row = e - pq * TO;
      if (T::GROUPS % T::THREADS != 0 && e >= T::GROUPS) break;
      uint4 big, small;
      split_tf32(x[it][0], big.x, small.x);
      split_tf32(x[it][1], big.y, small.y);
      split_tf32(x[it][2], big.z, small.z);
      split_tf32(x[it][3], big.w, small.w);
      const int off = row * 128 + ((pq ^ (row & 7)) << 4);
      *reinterpret_cast<uint4*>(tb + off) = big;
      *reinterpret_cast<uint4*>(tb + T::B_BYTES + off) = small;
    }
  };

  // warpgroup (wm, wn): rows wm * 64 .. of A, columns wn * NW .. of B
  const int wgi = tid / 128, wm = wgi / T::WGN, wn = wgi % T::WGN, t = tid % 128;
  // A in registers, the m16n8k8 fragment of each of the chunk's four k8
  // steps: rows r0 = wm 64 + 16 (t / 32) + (t % 32) / 4 and r0 + 8,
  // positions 8 kk + t % 4 and + 4, read from the stage and split there
  // (rows past TI are zeros)
  const int r0 = wm * 64 + (t / 32) * 16 + (t % 32) / 4, pa = t % 4;
  uint32_t ab[4][4], as[4][4];
  auto load_a = [&](int stage) {
    const float* ra = ring + stage * (T::RAW / 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r0 + 8 * (q % 2), pos = 8 * kk + pa + 4 * (q / 2);
        const float x = row < TI ? ra[pos * T::LDA + row] : 0.0f;
        split_tf32(x, ab[kk][q], as[kk][q]);
      }
  };

  float acc[T::NW / 2], pr[T::NW / 2];
#pragma unroll
  for (int q = 0; q < T::NW / 2; ++q) acc[q] = pr[q] = 0.0f;
  // 3xTF32 over one chunk into fresh accumulators: small*big, big*small,
  // big*big, each over the chunk's four k8 steps (B's 32 bytes apart)
  auto products = [&](int bf) {
    const unsigned char* tb = sm + bf * T::BUF + wn * T::NW * 128;
    const uint64_t bb = wgmma_desc_sw128(tb), bs = wgmma_desc_sw128(tb + T::B_BYTES);
    wgmma_fence_operands(pr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs<T::NW>(pr, as[kk], bb + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs<T::NW>(pr, ab[kk], bs + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs<T::NW>(pr, ab[kk], bb + 2 * kk, 1);
    wgmma_commit();
  };
  // the tensor cores' sum truncates: each chunk's products are added to the
  // sums in f32 (nearest), so no chain grows with the reduction's length
  auto accumulate = [&]() {
    wgmma_wait<0>();
    wgmma_fence_operands(pr);
#pragma unroll
    for (int q = 0; q < T::NW / 2; ++q) acc[q] = __fadd_rn(acc[q], pr[q]);
  };

  // the ring: slot j's gathers are issued AHEAD steps before its own, its
  // rulebook entries LEAD steps before that; B's split of slot j overlaps
  // the products of slot j - 1, A's fragments are read once those are done
  // (their registers are the products' operands); one barrier a step.
  // Commit groups in order: the entries of slots 0 .. AHEAD + LEAD - 1,
  // the gathers of slots 0 .. AHEAD - 1, then one a step (the gathers of
  // slot j + AHEAD and the entries of slot j + AHEAD + LEAD): after the
  // wait at the end of step j every group but the last AHEAD - 1 has
  // landed, slot j + 1's gathers and slot j + 1 + AHEAD's entries among them.
#pragma unroll 1
  for (int j = 0; j < DW_AHEAD + DW_LEAD; ++j) fetch(j);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < DW_AHEAD; ++j) {
    if (j < nh) load(j, j);
    cp_async_commit();
  }
  cp_async_wait<DW_AHEAD - 1>();
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < nh; ++j) {
    // the stage of slot j - 1, read before the last barrier, takes slot j + AHEAD
    if (j + DW_AHEAD < nh) load(j + DW_AHEAD, (j + DW_AHEAD) % DW_STAGES);
    fetch(j + DW_AHEAD + DW_LEAD);
    cp_async_commit();
    split_b(j % DW_STAGES, j & 1);  // buffer j & 1 was last read by the products of j - 2
    accumulate();  // slot j - 1's products (at j = 0: nothing pending, zeros added)
    load_a(j % DW_STAGES);
    cp_async_wait<DW_AHEAD - 1>();  // slot j + 1 has landed (this thread's copies)
    fence_proxy_async();            // B's planes, to the tensor cores
    __syncthreads();                // ... everyone's
    products(j & 1);
  }
  accumulate();  // the last slot's products
  cp_async_wait<0>();

  // the block's partial tile; thread t of warpgroup (wm, wn) holds rows
  // wm 64 + 16 (t / 32) + (t % 32) / 4 (+ 8), columns wn NW + 8 j + 2 (t %
  // 4) (+ 1); rows from TI on are not dw's
  float* out = part + ((size_t)s * K + k) * Cin * Cout;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= TI || i0 + row >= Cin) continue;
#pragma unroll
    for (int jn = 0; jn < T::NW / 8; ++jn) {
      const int col = o0 + wn * T::NW + 8 * jn + 2 * (t % 4);
      if (col < Cout)
        *reinterpret_cast<float2*>(out + (size_t)(i0 + row) * Cout + col) =
            make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void store_sum(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_sum(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// dw[e] = sum over shares s, in order, of part[s][e] (f32), rounded once to
// dw's type
template <typename OutT>
__global__ void gather_dw_reduce_kernel(const float* __restrict__ part, OutT* __restrict__ dw,
                                        int shares, long long per) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < per;
       e += (long long)gridDim.x * blockDim.x) {
    float sum = part[e];
    for (int s = 1; s < shares; ++s) sum += part[(size_t)s * per + e];
    store_sum(dw + e, sum);
  }
}

template <typename OutT>
int launch_dw_reduce(const float* part, OutT* dw, int shares, long long per,
                     cudaStream_t stream) {
  const long long blocks = (per + THREADS - 1) / THREADS;
  gather_dw_reduce_kernel<OutT><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), THREADS,
                                  0, stream>>>(part, dw, shares, per);
  return static_cast<int>(cudaGetLastError());
}

template <int TI, int TO>
int launch_gather_dw(const float* feat, const int* rb, const long long* order, const float* g,
                     float* dw, float* part, int B, int N, int Cin, int K, int M, int Cout,
                     int shares, int cps, cudaStream_t stream) {
  using T = DwTile<TI, TO>;
  const int tiles_i = (Cin + TI - 1) / TI, tiles_o = (Cout + TO - 1) / TO;
  const int chunks = B * ((M + DW_CH - 1) / DW_CH);
  cudaError_t e = cudaFuncSetAttribute(gather_dw_kernel<TI, TO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(shares, K, tiles_i * tiles_o);
  gather_dw_kernel<TI, TO><<<grid, T::THREADS, T::SMEM, stream>>>(
      feat, rb, order, g, part, N, Cin, K, M, Cout, chunks, cps, tiles_o);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_dw_reduce(part, dw, shares, (long long)K * Cin * Cout, stream);
}

template <int TI>
int dispatch_dw_to(const float* feat, const int* rb, const long long* order, const float* g,
                   float* dw, float* part, int B, int N, int Cin, int K, int M, int Cout,
                   int shares, int cps, cudaStream_t stream) {
  if (Cout <= 16)
    return launch_gather_dw<TI, 16>(feat, rb, order, g, dw, part, B, N, Cin, K, M, Cout, shares,
                                    cps, stream);
  if (Cout <= 32)
    return launch_gather_dw<TI, 32>(feat, rb, order, g, dw, part, B, N, Cin, K, M, Cout, shares,
                                    cps, stream);
  if (Cout <= 64)
    return launch_gather_dw<TI, 64>(feat, rb, order, g, dw, part, B, N, Cin, K, M, Cout, shares,
                                    cps, stream);
  return launch_gather_dw<TI, 128>(feat, rb, order, g, dw, part, B, N, Cin, K, M, Cout, shares,
                                   cps, stream);
}

// ---- gather_dw_bf16 -----------------------------------------------------------
//
// (the design and its measurements: the note on the bf16 kernels above)

constexpr int DWB_CH = 64;    // plan positions of a bf16 dW chunk: one ring stage, 4 k16 steps
constexpr int DWB_LEAD = 4;   // the producer's rulebook entries and output rows, slots ahead

template <int TI, int TO>
struct DwWgTile {
  static constexpr bool TR = TO > TI;                // dw^T: Cout as wgmma's M
  static constexpr int MD = TR ? TO : TI;            // the M side (Cin or Cout), padded to 64
  static constexpr int ND = TR ? TI : TO;            // the N side
  static constexpr int WG = MD > 64 ? 2 : 1;         // consumer warpgroups, 64 of M each
  static constexpr int THREADS = 128 * (WG + 1);     // and the producer warpgroup
  static constexpr int WARPS = THREADS / 32;
  static constexpr int NA = ND < 64 ? ND : 64;       // columns of a B swizzle atom
  static constexpr int RB = NA * 2;                  // bytes of a B atom row
  static constexpr int A_BYTES = WG * DWB_CH * 128;  // [WG][64 positions][64 of M], MN-major
  static constexpr int B_BYTES = DWB_CH * ND * 2;    // [ND / NA][64 positions][NA], MN-major
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // registers of a consumer thread: the sums and products, and about 40 more
  static constexpr int REGS = ND + 40;
  static constexpr int BY_REGS = 65536 / (THREADS * ((REGS + 7) / 8 * 8));
  static constexpr int MIN_BLOCKS = BY_REGS < 1 ? 1 : (BY_REGS > 4 ? 4 : BY_REGS);
  // the ring: what MIN_BLOCKS blocks leave of a multiprocessor (1 KB each
  // reserved) after the alignment slack, the barriers and the chunk list;
  // at most 8 stages
  static constexpr int FIXED = 1024 + 16 * 8 + DW_MAX_CHUNKS * 8 + 16;
  static constexpr int FIT = (232448 / MIN_BLOCKS - 1024 - FIXED) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static_assert(TI % 16 == 0 && TO % 16 == 0 && TI <= 128 && TO <= 128, "dw tile");
  static_assert(STAGES >= 3 && STAGE >= DW_MAX_CHUNKS, "ring; the chunk flags live in it");
};

template <int TI, int TO>
__global__ void __launch_bounds__(DwWgTile<TI, TO>::THREADS, DwWgTile<TI, TO>::MIN_BLOCKS)
gather_dw_bf16_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ rb,
                      const long long* __restrict__ order, const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ part, int N, int Cin, int K, int M, int Cout,
                      int chunks, int cps, int tiles_o) {
  using T = DwWgTile<TI, TO>;
  constexpr int ND = T::ND, NA = T::NA, RB = T::RB;
  extern __shared__ unsigned char dsm_dw[];
  unsigned char* sm = dsm_dw + ((1024u - (smem_u32(dsm_dw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  __shared__ int2 clist[DW_MAX_CHUNKS];
  __shared__ int count;

  const int s = blockIdx.x, k = blockIdx.y;
  const int i0 = (blockIdx.z / tiles_o) * TI, o0 = (blockIdx.z % tiles_o) * TO;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tc = (M + DWB_CH - 1) / DWB_CH;
  const int c_begin = s * cps;
  const int n_ch = min(c_begin + cps, chunks) - c_begin;
  if (tid == 0) {
    for (int q = 0; q < T::STAGES; ++q) {
      mbar_init(&full[q], 128);
      mbar_init(&empty[q], 4 * T::WG);
    }
    fence_mbar_init();
  }
  const int nh = list_hit_chunks<T::WARPS, DWB_CH>(rb, k, K, M, tc, c_begin, n_ch, sm, clist,
                                                   &count);

  if (warp >= 4 * T::WG) {
    // the producer: slot j (a listed chunk) into stage j % STAGES once the
    // consumers have released its last use. Two threads a position, each
    // every other 16-byte piece of its feature row then its g row (zero
    // fill for misses, positions past M and the Cin / Cout edge), to their
    // swizzled places; the rulebook entries and output rows of slot j +
    // DWB_LEAD are loaded into registers while slot j is issued, so no
    // copy waits on a global load
    const int pt = tid - 128 * T::WG, p = pt / 2, sub = pt % 2;
    // A: the M side's rows (features, or g for dw^T); B: the N side's
    const __nv_bfloat16* src_a = T::TR ? g : feat;
    const __nv_bfloat16* src_b = T::TR ? feat : g;
    const int ca = T::TR ? Cout : Cin, cb = T::TR ? Cin : Cout;
    const int a0 = T::TR ? o0 : i0, b0 = T::TR ? i0 : o0;
    constexpr int PA = T::MD / 8, PIECES = PA + ND / 8;
    int vq[DWB_LEAD], oq[DWB_LEAD];
    auto entries = [&](int j, int& v, int& o) {
      v = -1;
      o = 0;
      if (j >= nh) return;
      const int2 c = clist[j];
      const int pos = c.y + p;
      if (pos >= M) return;
      v = __ldg(rb + ((size_t)c.x * K + k) * M + pos);
      o = order != nullptr ? static_cast<int>(__ldg(order + (size_t)c.x * M + pos)) : pos;
    };
#pragma unroll
    for (int i = 0; i < DWB_LEAD; ++i) entries(i, vq[i], oq[i]);
    auto slot = [&](int j, int& v, int& o) {
      const int st = j % T::STAGES;
      if (j >= T::STAGES) mbar_wait(&empty[st], ((j / T::STAGES) - 1) & 1);
      const int bx = clist[j].x;
      const bool h = v >= 0;
      // the feature row is rulebook row v, the g row output row o
      const size_t fr = ((size_t)bx * N + (h ? v : 0)) * Cin;
      const size_t gr = ((size_t)bx * M + (h ? o : 0)) * Cout;
      const __nv_bfloat16* ra = src_a + (T::TR ? gr : fr) + a0;
      const __nv_bfloat16* rbw = src_b + (T::TR ? fr : gr) + b0;
      unsigned char* st_a = sm + st * T::STAGE;
      unsigned char* st_b = st_a + T::A_BYTES;
#pragma unroll
      for (int i = 0; i < PIECES / 2; ++i) {
        const int q = 2 * i + sub;  // PA is even: i < PA / 2 picks A for both threads
        if (i < PA / 2) {
          const bool ok = h && a0 + 8 * q < ca;
          cp_async16(st_a + (q / 8) * (DWB_CH * 128) + swz_off<128>(p, q % 8),
                     ok ? ra + 8 * q : feat, ok);
        } else {
          const int qb = q - PA;
          const bool ok = h && b0 + 8 * qb < cb;
          cp_async16(st_b + (qb / (NA / 8)) * (DWB_CH * RB) + swz_off<RB>(p, qb % (NA / 8)),
                     ok ? rbw + 8 * qb : feat, ok);
        }
      }
      cp_async_mbar_arrive(&full[st]);
      entries(j + DWB_LEAD, v, o);  // the registers of slot j now take slot j + LEAD's
    };
    // unrolled by DWB_LEAD, so that each slot's registers stay in place
    // until their loads are used
#pragma unroll 1
    for (int j = 0; j < nh; j += DWB_LEAD) {
#pragma unroll
      for (int i = 0; i < DWB_LEAD; ++i)
        if (j + i < nh) slot(j + i, vq[i], oq[i]);
    }
    cp_async_wait<0>();
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. of the M side. Each
  // chunk's 4 k16 products go into fresh accumulators (the tensor cores' sum
  // truncates, and a tap's reduction runs to tens of thousands of
  // positions), added to the sums with round-to-nearest adds in chunk
  // order; the chunk's stage is released once its products are done
  const int wg = warp / 4, t = tid % 128;
  float acc[ND / 2], pr[ND / 2];
#pragma unroll
  for (int q = 0; q < ND / 2; ++q) acc[q] = 0.0f;
#pragma unroll 1
  for (int j = 0; j < nh; ++j) {
    const int st = j % T::STAGES;
    mbar_wait(&full[st], (j / T::STAGES) & 1);
    fence_proxy_async();  // the landed copies, to the tensor cores' reads
    const unsigned char* a = sm + st * T::STAGE;
    const uint64_t da = wgmma_desc_sw<128>(a + wg * (DWB_CH * 128), DWB_CH * 128, 1024);
    const uint64_t db = wgmma_desc_sw<RB>(a + T::A_BYTES, DWB_CH * RB, 8 * RB);
    wgmma_fence_operands(pr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DWB_CH / 16; ++kk)
      wgmma_bf16<ND, 1, 1>(pr, da + ((16 * 128 * kk) >> 4), db + ((16 * RB * kk) >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(pr);
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int q = 0; q < ND / 2; ++q) acc[q] = __fadd_rn(acc[q], pr[q]);
  }

  // thread t holds acc[4 jn + q] at row 16 (t / 32) + (t % 32) / 4 + 8 (q /
  // 2) of the warpgroup's 64 of M, column 8 jn + 2 (t % 4) + q % 2 of N;
  // rows past the tile's M side are not dw's
  float* out = part + ((size_t)s * K + k) * Cin * Cout;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wg * 64 + 16 * (t / 32) + (t % 32) / 4 + 8 * h;
    if (row >= T::MD) continue;
#pragma unroll
    for (int jn = 0; jn < ND / 8; ++jn) {
      const int col = 8 * jn + 2 * (t % 4);
      if constexpr (T::TR) {
        const int o = o0 + row, i = i0 + col;
        if (o < Cout && i < Cin) out[(size_t)i * Cout + o] = acc[4 * jn + 2 * h];
        if (o < Cout && i + 1 < Cin) out[(size_t)(i + 1) * Cout + o] = acc[4 * jn + 2 * h + 1];
      } else {
        const int i = i0 + row, o = o0 + col;
        if (i < Cin && o < Cout)
          *reinterpret_cast<float2*>(out + (size_t)i * Cout + o) =
              make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
      }
    }
  }
}

template <int TI, int TO>
int launch_gather_dw_bf16(const __nv_bfloat16* feat, const int* rb, const long long* order,
                          const __nv_bfloat16* g, __nv_bfloat16* dw, float* part, int B, int N,
                          int Cin, int K, int M, int Cout, int shares, int cps,
                          cudaStream_t stream) {
  using T = DwWgTile<TI, TO>;
  const int tiles_i = (Cin + TI - 1) / TI, tiles_o = (Cout + TO - 1) / TO;
  const int chunks = B * ((M + DWB_CH - 1) / DWB_CH);
  const int smem = 1024 + T::STAGES * (T::STAGE + 16);
  cudaError_t e = cudaFuncSetAttribute(gather_dw_bf16_kernel<TI, TO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(shares, K, tiles_i * tiles_o);
  gather_dw_bf16_kernel<TI, TO><<<grid, T::THREADS, smem, stream>>>(
      feat, rb, order, g, part, N, Cin, K, M, Cout, chunks, cps, tiles_o);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_dw_reduce(part, dw, shares, (long long)K * Cin * Cout, stream);
}

template <int TI>
int dispatch_dw_bf16_to(const __nv_bfloat16* feat, const int* rb, const long long* order,
                        const __nv_bfloat16* g, __nv_bfloat16* dw, float* part, int B, int N,
                        int Cin, int K, int M, int Cout, int shares, int cps,
                        cudaStream_t stream) {
  if (Cout <= 16)
    return launch_gather_dw_bf16<TI, 16>(feat, rb, order, g, dw, part, B, N, Cin, K, M, Cout,
                                         shares, cps, stream);
  if (Cout <= 32)
    return launch_gather_dw_bf16<TI, 32>(feat, rb, order, g, dw, part, B, N, Cin, K, M, Cout,
                                         shares, cps, stream);
  if (Cout <= 64)
    return launch_gather_dw_bf16<TI, 64>(feat, rb, order, g, dw, part, B, N, Cin, K, M, Cout,
                                         shares, cps, stream);
  return launch_gather_dw_bf16<TI, 128>(feat, rb, order, g, dw, part, B, N, Cin, K, M, Cout,
                                        shares, cps, stream);
}

// the checks of a dW launch's chunk shares (ops/gather.py::_dw_chunk_shares)
bool dw_shares_ok(int B, int M, int shares, int cps, int ch) {
  const long long chunks = (long long)B * ((M + ch - 1) / ch);
  return cps > 0 && cps <= DW_MAX_CHUNKS && shares > 0 && (long long)shares * cps >= chunks &&
         (long long)(shares - 1) * cps < (chunks > 0 ? chunks : 1);
}

template <int TI>
int dw_bf16_min_blocks(int to) {
  switch (to) {
    case 16: return DwWgTile<TI, 16>::MIN_BLOCKS;
    case 32: return DwWgTile<TI, 32>::MIN_BLOCKS;
    case 64: return DwWgTile<TI, 64>::MIN_BLOCKS;
    case 128: return DwWgTile<TI, 128>::MIN_BLOCKS;
    default: return -1;
  }
}

}  // namespace

extern "C" int gather_gemm_f32(const void* feat, const void* rb, const void* order,
                               const void* w, void* out, int B, int N, int Cin, int K, int M,
                               int Cout, void* stream) {
  if (B == 0 || M == 0 || Cout == 0) return 0;
  if (Cin % 4 != 0 || K <= 0 || K > MAX_TAPS) return static_cast<int>(cudaErrorInvalidValue);
  const float* f = static_cast<const float*>(feat);
  const int* r = static_cast<const int*>(rb);
  const long long* o = static_cast<const long long*>(order);
  const float* ww = static_cast<const float*>(w);
  float* y = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cout) {
    case 16: return dispatch_bk<16>(f, r, o, ww, y, B, N, Cin, K, M, Cout, s);
    case 32: return dispatch_bk<32>(f, r, o, ww, y, B, N, Cin, K, M, Cout, s);
    case 64: return dispatch_bk<64>(f, r, o, ww, y, B, N, Cin, K, M, Cout, s);
    default:
      if (Cout % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_bk<128>(f, r, o, ww, y, B, N, Cin, K, M, Cout, s);
  }
}

// out [M, row_bytes] contiguous; row idx[m] of the table is batch src / R,
// row src % R, at table + batch * sb + row * sr (bytes); a row is
// row_bytes / piece pieces of piece bytes, sp bytes apart.
extern "C" int gather_rows(const void* table, const void* idx, void* out, int M, long long rows,
                           long long R, long long sb, long long sr, long long sp, int piece,
                           int row_bytes, void* stream) {
  if (M == 0 || row_bytes == 0) return 0;
  if (R <= 0 || piece <= 0 || row_bytes % piece != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* i = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pieces = row_bytes / piece;
  switch (piece) {
    case 16: return launch_gather_rows<uint4>(table, i, out, M, pieces, rows, R, sb, sr, sp, s);
    case 8: return launch_gather_rows<uint2>(table, i, out, M, pieces, rows, R, sb, sr, sp, s);
    case 4: return launch_gather_rows<uint32_t>(table, i, out, M, pieces, rows, R, sb, sr, sp, s);
    case 2: return launch_gather_rows<uint16_t>(table, i, out, M, pieces, rows, R, sb, sr, sp, s);
    case 1: return launch_gather_rows<uint8_t>(table, i, out, M, pieces, rows, R, sb, sr, sp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dw [K, Cin, Cout]; part: scratch of shares * K * Cin * Cout floats; the
// plan's B * ceil(M / 32) chunks of positions in shares of cps chunks
// (ops/gather.py::_dw_chunk_shares).
extern "C" int gather_dw_f32(const void* feat, const void* rb, const void* order, const void* g,
                             void* dw, void* part, int B, int N, int Cin, int K, int M, int Cout,
                             int shares, int cps, void* stream) {
  if (K == 0 || Cin == 0 || Cout == 0) return 0;
  if (Cin % 4 != 0 || Cout % 4 != 0 || !dw_shares_ok(B, M, shares, cps, DW_CH))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* f = static_cast<const float*>(feat);
  const int* r = static_cast<const int*>(rb);
  const long long* o = static_cast<const long long*>(order);
  const float* gg = static_cast<const float*>(g);
  float* d = static_cast<float*>(dw);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin <= 16) return dispatch_dw_to<16>(f, r, o, gg, d, p, B, N, Cin, K, M, Cout, shares, cps, s);
  if (Cin <= 32) return dispatch_dw_to<32>(f, r, o, gg, d, p, B, N, Cin, K, M, Cout, shares, cps, s);
  if (Cin <= 64) return dispatch_dw_to<64>(f, r, o, gg, d, p, B, N, Cin, K, M, Cout, shares, cps, s);
  return dispatch_dw_to<128>(f, r, o, gg, d, p, B, N, Cin, K, M, Cout, shares, cps, s);
}

// bf16 features [B, N, Cin] with Cin % 16 == 0 and weights [K, Cin, Cout]
// -> out [B, M, Cout] bf16; the rest as gather_gemm_f32.
extern "C" int gather_gemm_bf16(const void* feat, const void* rb, const void* order,
                                const void* w, void* out, int B, int N, int Cin, int K, int M,
                                int Cout, void* stream) {
  if (B == 0 || M == 0 || Cout == 0) return 0;
  if (Cin % 16 != 0 || K <= 0 || K > MAX_TAPS) return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(feat);
  const int* r = static_cast<const int*>(rb);
  const long long* o = static_cast<const long long*>(order);
  const __nv_bfloat16* ww = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cout) {
    case 16: return dispatch_bk_bf16<16>(f, r, o, ww, y, B, N, Cin, K, M, Cout, s);
    case 32: return dispatch_bk_bf16<32>(f, r, o, ww, y, B, N, Cin, K, M, Cout, s);
    case 64: return dispatch_bk_bf16<64>(f, r, o, ww, y, B, N, Cin, K, M, Cout, s);
    default:
      if (Cout % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_bk_bf16<128>(f, r, o, ww, y, B, N, Cin, K, M, Cout, s);
  }
}

// bf16 features and g with Cin % 8 == 0 and Cout % 8 == 0 -> dw [K, Cin,
// Cout] bf16; part and the shares as gather_dw_f32.
extern "C" int gather_dw_bf16(const void* feat, const void* rb, const void* order, const void* g,
                              void* dw, void* part, int B, int N, int Cin, int K, int M, int Cout,
                              int shares, int cps, void* stream) {
  if (K == 0 || Cin == 0 || Cout == 0) return 0;
  if (Cin % 8 != 0 || Cout % 8 != 0 || !dw_shares_ok(B, M, shares, cps, DWB_CH))
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(feat);
  const int* r = static_cast<const int*>(rb);
  const long long* o = static_cast<const long long*>(order);
  const __nv_bfloat16* gg = static_cast<const __nv_bfloat16*>(g);
  __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dw);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin <= 16)
    return dispatch_dw_bf16_to<16>(f, r, o, gg, d, p, B, N, Cin, K, M, Cout, shares, cps, s);
  if (Cin <= 32)
    return dispatch_dw_bf16_to<32>(f, r, o, gg, d, p, B, N, Cin, K, M, Cout, shares, cps, s);
  if (Cin <= 64)
    return dispatch_dw_bf16_to<64>(f, r, o, gg, d, p, B, N, Cin, K, M, Cout, shares, cps, s);
  return dispatch_dw_bf16_to<128>(f, r, o, gg, d, p, B, N, Cin, K, M, Cout, shares, cps, s);
}

// The bf16 kernels' tile constants as built, for the launch arithmetic of
// ops/gather.py to be held against them (gemm_tile_rows, gemm_walk,
// _dw_bf16_blocks_per_sm): what 0 gives a K4 block's plan positions at
// Cout a, 1 the rows of a K4 block that skip a tap together, 2 the K4-dW
// blocks a multiprocessor holds at the tile a (of Cin) x b (of Cout); -1
// for a shape without a tile.
extern "C" int gather_bf16_tile(int what, int a, int b) {
  if (what == 0 || what == 1) {
    int bm, wr;
    switch (a) {
      case 16: bm = WgTile<16, 16>::BMW, wr = WgTile<16, 16>::WR; break;
      case 32: bm = WgTile<32, 16>::BMW, wr = WgTile<32, 16>::WR; break;
      case 64: bm = WgTile<64, 16>::BMW, wr = WgTile<64, 16>::WR; break;
      default:
        if (a <= 0 || a % 128 != 0) return -1;
        bm = WgTile<128, 16>::BMW, wr = WgTile<128, 16>::WR;
    }
    return what == 0 ? bm : wr;
  }
  if (what != 2) return -1;
  switch (a) {
    case 16: return dw_bf16_min_blocks<16>(b);
    case 32: return dw_bf16_min_blocks<32>(b);
    case 64: return dw_bf16_min_blocks<64>(b);
    case 128: return dw_bf16_min_blocks<128>(b);
    default: return -1;
  }
}
