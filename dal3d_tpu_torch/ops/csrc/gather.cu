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
// features' dtype). The same walks on bf16 mma.sync m16n8k16; see their
// sections below. Bound on the card: the bytes, or 2 * hits * Cin * Cout
// at the 989 TFLOP/s bf16 tensor-core peak.
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

// The prologue of a gather-GEMM block: its plan positions m0 .. m0 + BM - 1
// of batch element b. Stages their rulebook entries sidx[k * BM + r] (-1
// past M) and output rows sorder[r] (-1 past M), the taps each row group of
// WM rows hits (gmask, one bit a tap) and the block hits (bmask); returns
// the calling warp's row group's mask. Warps WM-row groups in order, as
// many warps a group as the block has over BM / WM.
template <int WM>
__device__ __forceinline__ unsigned stage_block(const int* __restrict__ rbb,
                                                const long long* __restrict__ order, int b,
                                                int K, int M, int m0, int* sidx, int* sorder,
                                                unsigned* gmask, unsigned* bmask) {
  constexpr int GROUPS = BM / WM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % GROUPS, wn = warp / GROUPS;
  if (tid == 0) *bmask = 0;
  for (int e = tid; e < K * BM; e += THREADS) {
    const int k = e / BM, r = e - k * BM, m = m0 + r;
    sidx[e] = m < M ? rbb[(size_t)k * M + m] : -1;
  }
  for (int r = tid; r < BM; r += THREADS) {
    const int m = m0 + r;
    sorder[r] = m >= M ? -1 : (order ? static_cast<int>(order[(size_t)b * M + m]) : m);
  }
  __syncthreads();
  // the taps the warp's rows hit: one bit per tap
  unsigned wmask = 0;
  for (int k = 0; k < K; ++k) {
    const bool h = lane < WM && sidx[k * BM + wm * WM + lane] >= 0;
    wmask |= (__any_sync(0xffffffffu, h) ? 1u : 0u) << k;
  }
  if (lane == 0) {
    if (wn == 0) gmask[wm] = wmask;
    atomicOr(bmask, wmask);
  }
  __syncthreads();
  return wmask;
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

  const unsigned wmask = stage_block<T::WM>(rbb, order, b, K, M, m0, sidx, sorder, gmask, &bmask);

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
// The same block walk as gather_gemm_kernel (stage_block, then tap_ring's
// (active tap, Cin chunk) steps, only the row groups that hit a tap
// gathering and multiplying it), on bf16 rows and weights: one bf16
// mma.sync m16n8k16 a 16-channel step into the f32 sums (JAX's product:
// bf16 operands, f32 sums), each output rounded once to bf16 (nearest) in
// the epilogue. A row's sum runs through at most 27 x 128 / 16 = 216
// products of the tensor cores' truncating accumulator, whose drift (about
// 1e-5 of scale over such a chain, see gather_gemm_f32) is far below the
// output's bf16 rounding (2^-9 of scale), so no step is summed apart.
// Chunks of 16 channels at Cin 16 and of 32 from Cin 32 on; A and B tiles
// by ldmatrix (B transposed) from row pitches padded by 16 bytes, which put
// the 8 rows each 8 x 8 matrix reads on 8 different 16-byte bank groups.

template <int COUT, int BK>
struct Bf16Tile {
  static constexpr int STAGES = 4;                      // cp.async ring
  static constexpr int WARPS_M = COUT >= 64 ? 4 : 8;    // row groups
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;               // rows of a warp: 16 or 32
  static constexpr int WN = COUT / WARPS_N;             // columns of a warp
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = BK + 8;                    // bf16
  static constexpr int LDW = COUT + 8;                  // bf16
  static constexpr int A_STAGE = BM * LDA;
  static constexpr int STAGE = A_STAGE + BK * LDW;
  static constexpr int TILE_BYTES = STAGES * STAGE * 2;
  static_assert(BK % 16 == 0 && WN % 16 == 0 && WM % 16 == 0, "tile shape");
};

template <int COUT, int BK>
__global__ void __launch_bounds__(THREADS, 2)
gather_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ rb,
                        const long long* __restrict__ order, const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, int N, int Cin, int K, int M, int Cout) {
  using T = Bf16Tile<COUT, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][A | W]
  int* sidx = reinterpret_cast<int*>(smem + T::TILE_BYTES);       // [K][BM]
  __shared__ int sorder[BM];
  __shared__ unsigned gmask[T::WARPS_M];
  __shared__ unsigned bmask;

  const int b = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * COUT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const __nv_bfloat16* fb = feat + (size_t)b * N * Cin;
  const unsigned wmask = stage_block<T::WM>(rb + (size_t)b * K * M, order, b, K, M, m0, sidx,
                                            sorder, gmask, &bmask);
  auto load = [&](int stage, int lk, int lc) {
    __nv_bfloat16* a = tiles + stage * T::STAGE;
    __nv_bfloat16* ws = a + T::A_STAGE;
    const int c0 = lc * BK;
    constexpr int CPR = BK / 8;  // 16-byte pieces of a row chunk
    for (int e = tid; e < BM * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * 8;
      if (!((gmask[r / T::WM] >> lk) & 1u)) continue;
      const int src = sidx[lk * BM + r];
      const bool ok = src >= 0 && c0 + c < Cin;
      cp_async16(a + r * T::LDA + c, ok ? fb + (size_t)src * Cin + c0 + c : fb, ok);
    }
    const __nv_bfloat16* wk = w + (size_t)lk * Cin * Cout + n0;
    constexpr int CPW = COUT / 8;
    for (int e = tid; e < BK * CPW; e += THREADS) {
      const int r = e / CPW, c = (e % CPW) * 8;
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

  // ldmatrix: lanes 8q..8q+7 address matrix q; A: rows +8 for q odd, k +8
  // for q >= 2; B (transposed): k +8 for q odd, columns +8 for q >= 2
  const int a_row = wm * T::WM + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = wn * T::WN + (lane >> 4) * 8;
  auto compute = [&](int stage) {
    const __nv_bfloat16* a = tiles + stage * T::STAGE;
    const __nv_bfloat16* ws = a + T::A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
        ldmatrix_x4(af[i], a + (a_row + i * 16) * T::LDA + kk + a_col);
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, ws + (kk + b_row) * T::LDW + b_col + np * 16);
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma_bf16_16816(acc[i][2 * np], af[i], bf[0], bf[1]);
          mma_bf16_16816(acc[i][2 * np + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  };

  tap_ring<T::STAGES>(bmask, (Cin + BK - 1) / BK, wmask, load, compute);

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = sorder[wm * T::WM + i * 16 + h * 8 + g];
      if (m < 0) continue;
      __nv_bfloat16* o = out + ((size_t)b * M + m) * Cout + n0 + wn * T::WN + 2 * t;
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o + j * 8) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  }
}

template <int COUT, int BK>
int launch_gather_gemm_bf16(const __nv_bfloat16* feat, const int* rb, const long long* order,
                            const __nv_bfloat16* w, __nv_bfloat16* out, int B, int N, int Cin,
                            int K, int M, int Cout, cudaStream_t stream) {
  using T = Bf16Tile<COUT, BK>;
  const size_t smem = T::TILE_BYTES + (size_t)K * BM * 4;
  cudaError_t e = cudaFuncSetAttribute(gather_gemm_bf16_kernel<COUT, BK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + BM - 1) / BM, Cout / COUT, B);
  gather_gemm_bf16_kernel<COUT, BK><<<grid, THREADS, smem, stream>>>(feat, rb, order, w, out, N,
                                                                     Cin, K, M, Cout);
  return static_cast<int>(cudaGetLastError());
}

template <int COUT>
int dispatch_bk_bf16(const __nv_bfloat16* feat, const int* rb, const long long* order,
                     const __nv_bfloat16* w, __nv_bfloat16* out, int B, int N, int Cin, int K,
                     int M, int Cout, cudaStream_t stream) {
  if (Cin <= 16)
    return launch_gather_gemm_bf16<COUT, 16>(feat, rb, order, w, out, B, N, Cin, K, M, Cout,
                                             stream);
  return launch_gather_gemm_bf16<COUT, 32>(feat, rb, order, w, out, B, N, Cin, K, M, Cout,
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
// tc a batch element) that hit tap k, in order, into clist as (batch
// element, first position); returns their count. 8 chunks a warp a round
// (their rulebook reads in flight together), one byte a chunk of flags in
// the scratch `flag` (n_ch bytes); count is a shared int.
template <int WARPS>
__device__ __forceinline__ int list_hit_chunks(const int* __restrict__ rb, int k, int K, int M,
                                               int tc, int c_begin, int n_ch, unsigned char* flag,
                                               int2* clist, int* count) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c0 = warp * 8; c0 < n_ch; c0 += WARPS * 8) {
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int cc = c_begin + c0 + u, b = cc / tc, p = (cc - b * tc) * DW_CH + lane;
      v[u] = c0 + u < n_ch && p < M ? __ldg(rb + ((size_t)b * K + k) * M + p) : -1;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned m = __ballot_sync(0xffffffffu, v[u] >= 0);
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
        clist[n + __popc(m & ((1u << lane) - 1u))] = make_int2(b, (cc - b * tc) * DW_CH);
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

  const int nh = list_hit_chunks<T::WARPS>(rb, k, K, M, tc, c_begin, n_ch,
                                           reinterpret_cast<unsigned char*>(ring), clist, &count);

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
// The weight gradient of gather_gemm_bf16: bf16 features and g, f32 sums, dw
// rounded once to bf16. The block walk of gather_dw_kernel (one block per
// (share, tap, TI x TO tile of dw); the share's chunks that hit the tap
// listed first by list_hit_chunks; partial tiles summed in share order by
// gather_dw_reduce_kernel, so a repeat gives the same bits), with the
// products on bf16 mma.sync m16n8k16: one warp per 16 rows of the tile's
// Cin, all TO columns, the 32 positions of a chunk as two k16 steps. Both
// operands come by ldmatrix.trans from the chunk's [position][channel]
// rows (features as the transposed A, g as B), in a ring of DW_STAGES
// chunks gathered by 16-byte cp.async DW_STAGES - 1 chunks ahead (zero fill
// for misses and the Cin / Cout edge; row pitches padded by 16 bytes, so
// each 8 x 8 matrix reads 8 bank groups). A chunk's products go into fresh
// accumulators, added to the block's f32 sums with round-to-nearest adds:
// the tensor cores' sum truncates and a tap's reduction can run to tens of
// thousands of positions. The rulebook entries and output rows are read
// where a chunk's gathers are issued (no index ring, unlike the f32 kernel).

template <int TI, int TO>
struct DwBf16Tile {
  static constexpr int WARPS = TI / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NT = TO / 8;             // n8 tiles of a warp
  static constexpr int LDA = TI + 8, LDG = TO + 8;  // bf16
  static constexpr int STAGE = DW_CH * (LDA + LDG);  // bf16 of a ring stage
  static constexpr int SMEM = DW_STAGES * STAGE * 2;
  static constexpr int PIECES = (TI + TO) / 8;  // 16-byte pieces of a position's two rows
  static constexpr int TPP = THREADS / DW_CH;   // threads of a position's gathers
  static_assert(TI % 16 == 0 && TO % 16 == 0 && TI <= 128 && TO <= 128, "dw tile");
  static_assert(STAGE * 2 >= DW_MAX_CHUNKS, "the chunk flags live in the ring");
};

template <int TI, int TO>
__global__ void __launch_bounds__(DwBf16Tile<TI, TO>::THREADS)
gather_dw_bf16_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ rb,
                      const long long* __restrict__ order, const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ part, int N, int Cin, int K, int M, int Cout,
                      int chunks, int cps, int tiles_o) {
  using T = DwBf16Tile<TI, TO>;
  constexpr int PA = TI / 8;  // 16-byte pieces of a feature row
  extern __shared__ __align__(128) unsigned char dsm_bf16[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(dsm_bf16);
  __shared__ int2 clist[DW_MAX_CHUNKS];
  __shared__ int count;

  const int s = blockIdx.x, k = blockIdx.y;
  const int i0 = (blockIdx.z / tiles_o) * TI, o0 = (blockIdx.z % tiles_o) * TO;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tc = (M + DW_CH - 1) / DW_CH;
  const int c_begin = s * cps;
  const int n_ch = min(c_begin + cps, chunks) - c_begin;
  const int nh = list_hit_chunks<T::WARPS>(rb, k, K, M, tc, c_begin, n_ch,
                                           reinterpret_cast<unsigned char*>(ring), clist, &count);

  // slot j into ring stage `stage`: thread tid takes position p = tid /
  // TPP, pieces sub, sub + TPP, ... of its feature row then its g row
  const int p = tid / T::TPP, sub = tid % T::TPP;
  auto load = [&](int j, int stage) {
    const int2 c = clist[j];
    const int pos = c.y + p;
    const int v = pos < M ? __ldg(rb + ((size_t)c.x * K + k) * M + pos) : -1;
    const bool h = v >= 0;
    const int o = !h ? 0
                     : order != nullptr ? static_cast<int>(__ldg(order + (size_t)c.x * M + pos))
                                        : pos;
    __nv_bfloat16* ra = ring + stage * T::STAGE;
    const __nv_bfloat16* fr = feat + ((size_t)c.x * N + (h ? v : 0)) * Cin + i0;
    const __nv_bfloat16* gr = g + ((size_t)c.x * M + o) * Cout + o0;
#pragma unroll
    for (int q = sub; q < T::PIECES; q += T::TPP) {
      const bool is_a = q < PA;
      const int cc = 8 * (is_a ? q : q - PA);
      const bool ok = h && (is_a ? i0 + cc < Cin : o0 + cc < Cout);
      __nv_bfloat16* dst = is_a ? ra + p * T::LDA + cc : ra + DW_CH * T::LDA + p * T::LDG + cc;
      cp_async16(dst, ok ? (is_a ? fr : gr) + cc : feat, ok);
    }
  };

  float acc[T::NT][4], pr[T::NT][4];
#pragma unroll
  for (int j = 0; j < T::NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
  // ldmatrix.trans, lanes 8q..8q+7 address matrix q: A (the features,
  // [position][Cin]) rows +8 of Cin for q odd, positions +8 for q >= 2;
  // B (g, [position][Cout]) positions +8 for q odd, columns +8 for q >= 2
  const int a_pos = (lane & 7) + (lane >> 4) * 8, a_col = warp * 16 + ((lane >> 3) & 1) * 8;
  const int b_pos = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = (lane >> 4) * 8;
  auto compute = [&](int stage) {
    const __nv_bfloat16* ra = ring + stage * T::STAGE;
    const __nv_bfloat16* rg = ra + DW_CH * T::LDA;
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) pr[j][q] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DW_CH; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, ra + (kk + a_pos) * T::LDA + a_col);
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, rg + (kk + b_pos) * T::LDG + b_col + np * 16);
        mma_bf16_16816(pr[2 * np], af, bf[0], bf[1]);
        mma_bf16_16816(pr[2 * np + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = __fadd_rn(acc[j][q], pr[j][q]);
  };

  constexpr int AHEAD = DW_STAGES - 1;
#pragma unroll 1
  for (int j = 0; j < AHEAD; ++j) {
    if (j < nh) load(j, j);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < nh; ++j) {
    cp_async_wait<AHEAD - 1>();  // slot j has landed (this thread's copies)
    __syncthreads();             // ... everyone's; slot j - 1's stage is free
    if (j + AHEAD < nh) load(j + AHEAD, (j + AHEAD) % DW_STAGES);
    cp_async_commit();
    compute(j % DW_STAGES);
  }
  cp_async_wait<0>();

  // C fragment: rows (Cin) g and g + 8 of the warp's 16, columns 8 j + 2 t (+ 1)
  float* out = part + ((size_t)s * K + k) * Cin * Cout;
  const int gr_ = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = i0 + warp * 16 + gr_ + 8 * h;
    if (row >= Cin) continue;
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int col = o0 + 8 * j + 2 * t;
      if (col < Cout)
        *reinterpret_cast<float2*>(out + (size_t)row * Cout + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

template <int TI, int TO>
int launch_gather_dw_bf16(const __nv_bfloat16* feat, const int* rb, const long long* order,
                          const __nv_bfloat16* g, __nv_bfloat16* dw, float* part, int B, int N,
                          int Cin, int K, int M, int Cout, int shares, int cps,
                          cudaStream_t stream) {
  using T = DwBf16Tile<TI, TO>;
  const int tiles_i = (Cin + TI - 1) / TI, tiles_o = (Cout + TO - 1) / TO;
  const int chunks = B * ((M + DW_CH - 1) / DW_CH);
  cudaError_t e = cudaFuncSetAttribute(gather_dw_bf16_kernel<TI, TO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(shares, K, tiles_i * tiles_o);
  gather_dw_bf16_kernel<TI, TO><<<grid, T::THREADS, T::SMEM, stream>>>(
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
bool dw_shares_ok(int B, int M, int shares, int cps) {
  const long long chunks = (long long)B * ((M + DW_CH - 1) / DW_CH);
  return cps > 0 && cps <= DW_MAX_CHUNKS && shares > 0 && (long long)shares * cps >= chunks &&
         (long long)(shares - 1) * cps < (chunks > 0 ? chunks : 1);
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
  if (Cin % 4 != 0 || Cout % 4 != 0 || !dw_shares_ok(B, M, shares, cps))
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
  if (Cin % 8 != 0 || Cout % 8 != 0 || !dw_shares_ok(B, M, shares, cps))
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
