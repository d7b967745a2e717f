// Weight gradient of the rulebook gather-GEMM, for Hopper (sm_90a).
//
//   dw[q, r, o] = sum_{b, m : idx[b, q, m] >= 0} table[b, idx[b, q, m], r] * g[b, m, o]
//
// table [B, Mb, R], idx [B, Q, M] int32 (-1 = no contribution), g [B, M, Rout]
// (bf16 or f32, both the same), dw [Q, R, Rout] f32; products accumulate in f32.
//
// Replaces the TPU kernel dal3d_tpu/ops/banded.py::_dw_kernel (launched by
// _banded_dw_pallas). That kernel walks a (tap, 128-row block) grid in order,
// DMAs a [band, R] slab per step, gathers with a one-hot MXU matmul, carries
// the [R, Rout] sum in scratch memory across the grid, and is vmapped over the
// batch; entries outside the band are not its business. Hopper gathers rows
// straight from device memory and its blocks run in no order, so this kernel
// takes the full rulebook (no band, no starts, no clamped window) over the
// flattened (b, m) rows and reduces in deterministic passes. The whole
// [R, Rout] of every dw[q] is computed, the entries outside the band too: the
// gradient goes to whatever weight the caller holds, and a weight with zero
// blocks (a zero init) must still get its true gradient.
//
// Bound on the card: 2 * nnz(idx >= 0) * R * Rout operations against the
// 989 TFLOP/s bf16 tensor-core peak, or the bytes of table, idx, g and dw
// against 3.35 TB/s, whichever is larger. A rulebook hits 28 % (L0) to 70 %
// (L2) of its (row, tap) pairs, and the taps of one level differ several
// fold in hits, so a miss row must cost no MMA and a block's share of the
// work must be counted in hits, not rows.
//
// Design (one C call, three kernels on the caller's stream):
//   - hit_count_kernel counts the hits of each (tap, chunk of rows) into
//     scratch (at most 512 ints), for the two kernels after it.
//   - The main kernel's block (dw tile, share s) takes the s-th of S equal
//     shares of all taps' hits laid end to end, so every block of a tile does
//     the same work whatever the taps' hit counts (splitting each tap's rows
//     evenly left the blocks of the heavy taps with most of the work). A
//     share covers part of one tap or the end of one and the start of the
//     next: for each tap segment the block sums its hits in registers and
//     writes one partial tile to slot s + q of scratch (the (share, tap)
//     pairs a staircase of shares meets have distinct s + q), starting its
//     scan at the chunk that holds the segment's first hit.
//   - Hit compaction inside the block: it reads each idx of its rows once, in
//     windows of 512 rows (2 per thread, loaded one window ahead), ballots
//     idx >= 0 and appends the hits' (table row, g row) pairs to a ring in
//     shared memory (__ballot_sync / __popc prefix), dropping the hits before
//     and after its segment. Only tiles of 32 hits are gathered and
//     multiplied; the last tile of a segment is zero-filled.
//   - bf16: dw tiles of 128 x 256, one block of 8 warps (64 x 64 warp
//     tiles) per multiprocessor, for every launch of the path (R 96-776,
//     Rout 256-528): each gathered table row is fetched once per 256 columns
//     of Rout, each g row once per 128 rows of R. A ring of 6 shared-memory
//     stages fed by 16-byte cp.async gathers (TMA cannot gather rows),
//     XOR-swizzled, one barrier per two 32-hit steps; A^T comes from
//     ldmatrix.trans of the gathered [m][r] tile and g from ldmatrix.trans of
//     [m][o], into mma.sync m16n8k16 (bf16 in, f32 accumulate). Columns past
//     R or Rout are neither copied nor multiplied. wgmma is not used yet.
//     The gathers bound this loop (PERF.md, tools/hopper_calibration.py):
//     cp.async gathers alone and ldmatrix + mma.sync alone each run several
//     times faster than the two together, which share the shared-memory
//     path. The 64 x 64 warp tile reads a third fewer shared bytes per MMA
//     than 64 x 32, and the 256-wide tile gathers each table row half as
//     often as a 128-wide one.
//   - f32: 64 x 64 tiles, the same shares and compaction, plain FMAs in a
//     4 x 4 register tile (the f32 path serves parity runs, not speed).
//   - banded_dw_reduce_kernel sums each tap's partial tiles in share order
//     (a copy where one block held the whole tap, zeros where the tap has no
//     hit): no atomics, so repeated calls give the same bits.
//
// Alignment contract (checked by the Python wrapper): R % 8 == 0,
// Rout % 8 == 0, all pointers 16-byte aligned, tensors contiguous.

#include "common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using namespace dal3d;

constexpr int BKM = 32;           // hits reduced per step
constexpr int WIN = 512;          // rows compacted per refill
constexpr int LCAP = 1024;        // ring entries: WIN plus fewer than BKM pending
constexpr int MAX_COUNTS = 512;   // (tap, chunk) hit counts at most
constexpr int MAX_Q = 64;
static_assert(WIN + BKM <= LCAP && (LCAP & (LCAP - 1)) == 0, "ring too small");

// Rows per chunk of the hit counts: a multiple of WIN, so that at most
// MAX_COUNTS / Q chunks cover the rows of a tap.
int chunk_rows(int rows, int Q) {
  const int nch = MAX_COUNTS / Q > 1 ? MAX_COUNTS / Q : 1;
  const int ch = (rows + nch - 1) / nch;
  return ((ch + WIN - 1) / WIN) * WIN;
}

// counts[q * nch + c] = hits of tap q among rows [c * CH, (c + 1) * CH)
__global__ void __launch_bounds__(256)
hit_count_kernel(const int* __restrict__ idx, int* __restrict__ counts, int rows, int Q, int M,
                 int CH, int nch) {
  __shared__ int wsum[8];
  const int c = blockIdx.x, q = blockIdx.y;
  const int end = min((c + 1) * CH, rows);
  int n = 0;
  for (int i = c * CH + threadIdx.x; i < end; i += 256) {
    const int b = i / M;
    n += idx[((size_t)b * Q + q) * M + (i - b * M)] >= 0;
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if (threadIdx.x % 32 == 0) wsum[threadIdx.x / 32] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < 8; ++w) t += wsum[w];
    counts[(size_t)q * nch + c] = t;
  }
}

// The hit layout every block of the main kernel needs, in shared memory:
// pre[q * nch + c] the hits of tap q before chunk c, tap[q] the hits before
// tap q (tap[Q] = all hits). NT threads, one warp per tap.
template <int NT>
__device__ void load_counts(const int* __restrict__ counts, int Q, int nch, int* pre, int* tap) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int q = warp; q < Q; q += NT / 32) {
    int run = 0;
    for (int c0 = 0; c0 < nch; c0 += 32) {
      const int c = c0 + lane;
      const int v = c < nch ? counts[(size_t)q * nch + c] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      if (c < nch) pre[q * nch + c] = run + incl - v;
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) tap[q + 1] = run;  // this tap's hits; the prefix follows
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tap[0] = 0;
    for (int q = 0; q < Q; ++q) tap[q + 1] += tap[q];
  }
  __syncthreads();
}

// [h0, h1) of all hits: share s of S
__device__ __forceinline__ int share_begin(int H, int s, int S) {
  return static_cast<int>((long long)H * s / S);
}

// Walk the tap segments of share s of S: seg(q, first row, hits to drop,
// hits to keep) for each tap whose hits the share meets, in tap order. Every
// thread calls it with the same arguments.
template <typename Seg>
__device__ __forceinline__ void for_each_segment(const int* pre, const int* tap, int Q, int nch,
                                                 int CH, int s, int S, Seg seg) {
  const int h0 = share_begin(tap[Q], s, S), h1 = share_begin(tap[Q], s + 1, S);
  for (int q = 0; q < Q; ++q) {
    const int a = max(h0, tap[q]), z = min(h1, tap[q + 1]);
    if (a >= z) continue;
    const int lo = a - tap[q];
    const int* p = pre + q * nch;
    int c = 0, hi = nch - 1;  // the last chunk with p[c] <= lo
    while (c < hi) {
      const int mid = (c + hi + 1) / 2;
      if (p[mid] <= lo) c = mid; else hi = mid - 1;
    }
    seg(q, c * CH, lo - p[c], z - a);
  }
}

// Block (0, 0) writes, for each tap, the first and last share that meets its
// hits (first > last: none), for the reduction.
__device__ void write_share_range(const int* tap, int Q, int S, int* first, int* last) {
  if (blockIdx.x != 0 || blockIdx.y != 0) return;
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    int f = S, l = -1;
    for (int s = 0; s < S; ++s)
      if (max(share_begin(tap[Q], s, S), tap[q]) < min(share_begin(tap[Q], s + 1, S), tap[q + 1])) {
        f = min(f, s);
        l = s;
      }
    first[q] = f;
    last[q] = l;
  }
}

// The hits of one tap segment: a ring of (table row b * Mb + src, g row i)
// pairs in shared memory, filled window by window from row `scan` on; the
// first `skip` hits are dropped, the next `take` kept. Every method is called
// by all NT threads of the block together (they hold the same counters).
template <int NT>
struct HitRing {
  static constexpr int J = WIN / NT;  // rows per thread and window
  static constexpr int W = NT / 32;
  static constexpr int INTS = 2 * LCAP + J * W;  // shared ints it needs
  int* tab;   // [LCAP]
  int* grow;  // [LCAP]
  int* wcnt;  // [J * W]
  const int* idx;
  int Q, M, Mb, q, rows;
  int scan;  // next row to compact
  int seen;  // hits met so far, dropped ones included
  int skip, take;
  int nxt[J];  // idx of the window at scan, loaded one window ahead

  __device__ int kept() const { return min(max(seen - skip, 0), take); }

  __device__ void prefetch() {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = scan + j * NT + threadIdx.x;
      int v = -1;
      if (i < rows) {
        const int b = i / M;
        v = idx[((size_t)b * Q + q) * M + (i - b * M)];
      }
      nxt[j] = v;
    }
  }

  __device__ void init(int* ring_ints, const int* idx_, int Q_, int M_, int Mb_, int rows_,
                       int q_, int begin, int skip_, int take_) {
    tab = ring_ints;
    grow = tab + LCAP;
    wcnt = grow + LCAP;
    idx = idx_, Q = Q_, M = M_, Mb = Mb_, rows = rows_, q = q_;
    scan = begin, seen = 0, skip = skip_, take = take_;
    prefetch();
  }

  __device__ void refill() {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    unsigned bal[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      bal[j] = __ballot_sync(0xffffffffu, nxt[j] >= 0);
      if (lane == 0) wcnt[j * W + warp] = __popc(bal[j]);
    }
    __syncthreads();
    int before[J], total = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) before[j] = 0;
    for (int k = 0; k < J * W; ++k) {
      const int c = wcnt[k];
#pragma unroll
      for (int j = 0; j < J; ++j) before[j] += k < j * W + warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = seen + before[j] + __popc(bal[j] & ((1u << lane) - 1u)) - skip;
      if (nxt[j] >= 0 && k >= 0 && k < take) {
        const int i = scan + j * NT + tid;
        tab[k & (LCAP - 1)] = (i / M) * Mb + nxt[j];
        grow[k & (LCAP - 1)] = i;
      }
    }
    __syncthreads();
    seen += total;
    scan += WIN;
    prefetch();
  }

  // true when step t has at least one hit; compacts windows until it has
  // BKM of them or the segment is complete. Called with t = steps issued so
  // far, so at most BKM - 1 pairs are pending when a refill appends WIN.
  __device__ bool ready(int t) {
    while (kept() < (t + 1) * BKM && seen < skip + take && scan < rows) refill();
    return t * BKM < kept();
  }
};

// ---------------------------------------------------------------------------
// bf16: BR x BO tiles of dw[q] on the tensor cores

constexpr int BR = 128;
constexpr int BO = 256;
constexpr int WO = 64;                   // warp tiles 64 x 64
constexpr int THREADS = 256;             // 8 warps: 2 (r) x 4 (o)
constexpr int NT = WO / 8;               // n8 tiles per warp
constexpr int STAGES = 6;
constexpr int SPS = 2;                   // steps per barrier
constexpr int A_CH = BR / 8;             // 16-byte chunks per gathered table row
constexpr int G_CH = BO / 8;
constexpr int STAGE = BKM * BR + BKM * BO;  // bf16 elements
constexpr size_t STAGE_BYTES = (size_t)STAGES * STAGE * 2;

// grid: x = R tile + nRt * Rout tile, y = share s of S; one block (and its
// 200 or so registers a thread) per multiprocessor
__global__ void __launch_bounds__(THREADS, 1)
banded_dw_bf16_kernel(const __nv_bfloat16* __restrict__ table, const int* __restrict__ idx,
                      const __nv_bfloat16* __restrict__ g, int* __restrict__ counts,
                      float* __restrict__ part, int rows, int Mb, int R, int Q, int M, int Rout,
                      int S, int nRt, int CH, int nch) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][A | G]
  int* ring_ints = reinterpret_cast<int*>(smem + STAGE_BYTES);
  int* pre = ring_ints + HitRing<THREADS>::INTS;  // [Q * nch]
  int* tap = pre + Q * nch;                        // [Q + 1]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = (blockIdx.x % nRt) * BR;
  const int o0 = (blockIdx.x / nRt) * BO;
  const int s = blockIdx.y;
  const int wr = warp / (BO / WO), wo = warp % (BO / WO);
  // a warp whose 64 x WO piece lies wholly past R or Rout multiplies nothing
  const bool live = r0 + wr * 64 < R && o0 + wo * WO < Rout;
  load_counts<THREADS>(counts, Q, nch, pre, tap);
  write_share_range(tap, Q, S, counts + MAX_COUNTS, counts + MAX_COUNTS + MAX_Q);

  HitRing<THREADS> ring;
  float acc[4][NT][4];
  auto load = [&](int t, int buf) {
    __nv_bfloat16* a = st + buf * STAGE;
    __nv_bfloat16* gs = a + BKM * BR;
    const int kept = ring.kept();
#pragma unroll
    for (int c16 = tid; c16 < BKM * A_CH; c16 += THREADS) {
      const int m = c16 / A_CH, c = c16 % A_CH;
      if (r0 + c * 8 >= R) continue;  // a column of dw past R: never stored
      const int ent = t * BKM + m;
      const bool ok = ent < kept;
      const int src = ok ? ring.tab[ent & (LCAP - 1)] : 0;
      cp_async16(a + swz<A_CH>(m, c), table + (size_t)src * R + r0 + c * 8, ok);
    }
#pragma unroll
    for (int c16 = tid; c16 < BKM * G_CH; c16 += THREADS) {
      const int m = c16 / G_CH, c = c16 % G_CH;
      if (o0 + c * 8 >= Rout) continue;
      const int ent = t * BKM + m;
      const bool ok = ent < kept;
      const int gi = ok ? ring.grow[ent & (LCAP - 1)] : 0;
      cp_async16(gs + swz<G_CH>(m, c), g + (size_t)gi * Rout + o0 + c * 8, ok);
    }
  };
  auto compute = [&](int buf) {
    if (!live) return;
    const __nv_bfloat16* a = st + buf * STAGE;
    const __nv_bfloat16* gs = a + BKM * BR;
#pragma unroll
    for (int kk = 0; kk < BKM; kk += 16) {
      uint32_t af[4][4], bf[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(af[mt], a + swz<A_CH>(kk + lane % 8 + (lane / 16) * 8,
                                                (wr * 64 + mt * 16) / 8 + (lane / 8) % 2));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4_trans(bf[np], gs + swz<G_CH>(kk + lane % 8 + ((lane / 8) % 2) * 8,
                                                 (wo * WO + np * 16) / 8 + lane / 16));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16_16816(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2],
                         bf[nt / 2][(nt % 2) * 2 + 1]);
    }
  };

  for_each_segment(pre, tap, Q, nch, CH, s, S, [&](int q, int begin, int skip, int take) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;
    ring.init(ring_ints, idx, Q, M, Mb, rows, q, begin, skip, take);
    cp_async_pipeline<STAGES, SPS>([&](int t) { return ring.ready(t); }, load, compute);
    float* pq = part + (size_t)(s + q) * R * Rout;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = r0 + wr * 64 + mt * 16 + lane / 4;
        const int o = o0 + wo * WO + nt * 8 + (lane % 4) * 2;
        if (o >= Rout) continue;
        if (r < R)
          *reinterpret_cast<float2*>(pq + (size_t)r * Rout + o) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        if (r + 8 < R)
          *reinterpret_cast<float2*>(pq + (size_t)(r + 8) * Rout + o) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    __syncthreads();  // the next segment refills the stages and the ring
  });
}

// ---------------------------------------------------------------------------
// f32: 64 x 64 tiles, plain FMAs

constexpr int FBR = 64;
constexpr int FBO = 64;
constexpr int FTHREADS = 256;  // each thread 4 rows x 4 columns of dw

__global__ void __launch_bounds__(FTHREADS)
banded_dw_f32_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ g, int* __restrict__ counts,
                     float* __restrict__ part, int rows, int Mb, int R, int Q, int M, int Rout,
                     int S, int nRt, int CH, int nch) {
  __shared__ __align__(16) float As[BKM][FBR];
  __shared__ __align__(16) float Gs[BKM][FBO];
  extern __shared__ __align__(128) unsigned char smem[];
  int* ring_ints = reinterpret_cast<int*>(smem);
  int* pre = ring_ints + HitRing<FTHREADS>::INTS;  // [Q * nch]
  int* tap = pre + Q * nch;                         // [Q + 1]

  const int tid = threadIdx.x;
  const int r0 = (blockIdx.x % nRt) * FBR;
  const int o0 = (blockIdx.x / nRt) * FBO;
  const int s = blockIdx.y;
  const int tx = tid % 16, ty = tid / 16;  // dw columns tx*4..+3, dw rows ty*4..+3
  load_counts<FTHREADS>(counts, Q, nch, pre, tap);
  write_share_range(tap, Q, S, counts + MAX_COUNTS, counts + MAX_COUNTS + MAX_Q);
  HitRing<FTHREADS> ring;

  for_each_segment(pre, tap, Q, nch, CH, s, S, [&](int q, int begin, int skip, int take) {
    ring.init(ring_ints, idx, Q, M, Mb, rows, q, begin, skip, take);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
    for (int t = 0; ring.ready(t); ++t) {
      const int kept = ring.kept();
      for (int e = tid; e < BKM * FBR; e += FTHREADS) {
        const int k = e / FBR, c = e % FBR;
        const int ent = t * BKM + k;
        As[k][c] = (ent < kept && r0 + c < R)
                       ? table[(size_t)ring.tab[ent & (LCAP - 1)] * R + r0 + c]
                       : 0.0f;
        Gs[k][c] = (ent < kept && o0 + c < Rout)
                       ? g[(size_t)ring.grow[ent & (LCAP - 1)] * Rout + o0 + c]
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BKM; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Gs[k][tx * 4]);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
      }
      __syncthreads();
    }
    float* pq = part + (size_t)(s + q) * R * Rout;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r >= R) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + tx * 4 + j;
        if (o < Rout) pq[(size_t)r * Rout + o] = acc[i][j];
      }
    }
  });
}

// dw[q][k] = the partial tiles of tap q summed in share order: slots s + q
// for the shares s in [first[q], last[q]] (none: zeros)
__global__ void __launch_bounds__(256)
banded_dw_reduce_kernel(const float* __restrict__ part, const int* __restrict__ first,
                        const int* __restrict__ last, float* __restrict__ dw, int Q, size_t n) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < (size_t)Q * n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int q = static_cast<int>(e / n);
    const size_t k = e - (size_t)q * n;
    float sum = 0.0f;
    for (int s = first[q]; s <= last[q]; ++s) sum += part[(size_t)(s + q) * n + k];
    dw[e] = sum;
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, int tr, int to, size_t smem_fixed, const void* table,
           const void* idx, const void* g, void* dw, void* part, int B, int Mb, int R, int Q,
           int M, int Rout, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)R * Rout;
  if (n * Q == 0) return 0;
  const int rows = B * M;
  if (rows == 0) return static_cast<int>(cudaMemsetAsync(dw, 0, Q * n * sizeof(float), st));
  if (Q > MAX_Q) return static_cast<int>(cudaErrorInvalidValue);
  if (S < 1) S = 1;
  const int CH = chunk_rows(rows, Q), nch = (rows + CH - 1) / CH;
  float* pf = static_cast<float*>(part);
  int* counts = reinterpret_cast<int*>(pf + (size_t)(S + Q - 1) * n);
  hit_count_kernel<<<dim3(nch, Q), 256, 0, st>>>(static_cast<const int*>(idx), counts, rows, Q,
                                                 M, CH, nch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_fixed + 4 * ((size_t)Q * nch + Q + 1);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int nRt = (R + tr - 1) / tr, nOt = (Rout + to - 1) / to;
  kernel<<<dim3(nRt * nOt, S), threads, smem, st>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx), static_cast<const T*>(g),
      counts, pf, rows, Mb, R, Q, M, Rout, S, nRt, CH, nch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t total = (size_t)Q * n;
  const int blocks = static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  banded_dw_reduce_kernel<<<blocks, 256, 0, st>>>(pf, counts + MAX_COUNTS,
                                                  counts + MAX_COUNTS + MAX_Q,
                                                  static_cast<float*>(dw), Q, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part: scratch of (S + Q - 1) * R * Rout floats, then 640 ints (the hit
// counts and each tap's share range); S: the number of equal shares of the
// hits, that is blocks per dw tile. Q <= 64.
extern "C" int banded_dw_bf16(const void* table, const void* idx, const void* g, void* dw,
                              void* part, int B, int Mb, int R, int Q, int M, int Rout, int S,
                              void* stream) {
  return launch<__nv_bfloat16>(banded_dw_bf16_kernel, THREADS, BR, BO,
                               STAGE_BYTES + 4 * HitRing<THREADS>::INTS, table, idx, g, dw, part,
                               B, Mb, R, Q, M, Rout, S, stream);
}

extern "C" int banded_dw_f32(const void* table, const void* idx, const void* g, void* dw,
                             void* part, int B, int Mb, int R, int Q, int M, int Rout, int S,
                             void* stream) {
  return launch<float>(banded_dw_f32_kernel, FTHREADS, FBR, FBO,
                       4 * HitRing<FTHREADS>::INTS, table, idx, g, dw, part, B, Mb, R, Q, M,
                       Rout, S, stream);
}
