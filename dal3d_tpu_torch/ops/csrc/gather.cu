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
// Alignment contract of gather_gemm_f32 (checked by the Python wrapper):
// Cin % 4 == 0, Cout is 16, 32, 64 or a multiple of 128, K <= 32, pointers
// 16-byte aligned, contiguous.

#include "common.cuh"

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

  if (tid == 0) bmask = 0;
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
    const bool h = lane < T::WM && sidx[k * BM + wm * T::WM + lane] >= 0;
    wmask |= (__any_sync(0xffffffffu, h) ? 1u : 0u) << k;
  }
  if (lane == 0) {
    if (wn == 0) gmask[wm] = wmask;
    atomicOr(&bmask, wmask);
  }
  __syncthreads();

  const int nk = (Cin + BK - 1) / BK;
  const unsigned taps = bmask;
  const int steps = __popc(taps) * nk;

  // load side: step (tap lk, chunk lc); gathers only the rows of the row
  // groups that hit tap lk (the others' stale rows are never read)
  unsigned lrem = taps;
  int lk = taps ? __ffs(taps) - 1 : 0, lc = 0;
  auto load_next = [&](int stage) {
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
    if (++lc == nk) {
      lc = 0;
      lrem &= lrem - 1;
      lk = lrem ? __ffs(lrem) - 1 : 0;
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

  // the ring: STAGES - 1 steps in flight, one barrier per step
  constexpr int STAGES = T::STAGES;
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
