// Rulebook gather-GEMM of the brick sparse-conv engine, for Hopper (sm_90a).
//
//   out[b, m, :] = sum_{q : idx[b, q, m] >= 0} table[b, idx[b, q, m], :] @ w[q]
//
// table [B, Mb, R], idx [B, Q, M] int32 (-1 = no contribution), w [Q, R, Rout],
// out [B, M, Rout] in the table's dtype; products accumulate in f32.
//
// Replaces the TPU kernel dal3d_tpu/ops/banded.py::_fwd_kernel (launched by
// _banded_fwd_pallas). That kernel DMAs a [band, R] slab per 128-row block and
// gathers with a one-hot MXU matmul, so it only sees entries inside the band
// and leaves the rest to an XLA fallback. Hopper gathers rows from device
// memory directly, so this kernel takes the full rulebook: no band plan, no
// fallback, any index is legal.
//
// Bound on the card: the operations against the 989 TFLOP/s bf16 tensor-core
// peak, or the bytes of table, idx, w and out against 3.35 TB/s, whichever is
// larger. The weights of the main path are block-sparse by construction (the
// halo band of a subm conv: output voxel p reads padded voxels p..p+2 only;
// the halo pads and the strided conv's taps are 0/1 shift blocks), so the
// least work is 2 * sum_q hits_q * nnz(w[q]), a third to a twentieth of the
// dense 2 * hits * R * Rout.
//
// Design:
//   - one C call, two kernels on the caller's stream. band_flags_kernel marks
//     which 32 x 64 blocks of each w[q] hold a nonzero (from w's content, so
//     it holds for any weights: the dual gather's transposed weights, the
//     strided conv's, a dense test weight) into scratch the wrapper
//     allocates. The main kernel walks, for its 64- or 128-column tile, only
//     the (active tap, nonzero 32-row K-block) steps. Exact for finite
//     inputs: a zero block times a finite tile adds exactly 0. A non-finite
//     table entry under a zero weight block does not propagate, unlike in the
//     plain version (whose dense matmul gives 0 * inf = nan).
//   - bf16: one block of 8 warps per (128 output rows, BN output columns,
//     batch). The K range a column tile needs is about (BN / C + 2) C rows
//     for a subm conv of C channels: a narrower tile skips more, a wider one
//     gathers each table row fewer times. BN is 128 where R or Rout reaches
//     640 (C 64 and 128, their pads, duals and strided convs: at C 128 the
//     range is 3 x 128 rows for either width) and 64 below (C 16 and 32).
//     The block stages its [Q, 128] rulebook slice in shared memory, drops
//     the taps without a hit among its rows, lists its steps, then runs a
//     6-stage ring of 16-byte cp.async gathers (zero fill for misses and
//     ragged edges) into XOR-swizzled tiles, one barrier per two steps, and
//     ldmatrix + mma.sync m16n8k16 (bf16 in, f32 accumulate) on 32 x BN/2
//     warp tiles. The epilogue rounds to bf16 through shared memory and
//     stores 16 bytes per thread. wgmma is not used yet. Other stage counts,
//     steps per barrier, 256-row tiles and 64-row warp tiles measured no
//     faster on the path's launches: the gathers beside the ldmatrix traffic
//     set the pace (PERF.md, tools/hopper_calibration.py).
//   - f32: one block of 4 warps per 64 x 64 tile, the same step walk, plain
//     FMAs (the f32 path serves parity runs, not speed).
//
// Alignment contract (checked by the Python wrapper): R % 8 == 0,
// Rout % 8 == 0, all pointers 16-byte aligned, tensors contiguous.

#include "common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using namespace dal3d;

constexpr int FLAG_BK = 32;  // rows of a weight block of the skip flags
constexpr int FLAG_BN = 64;  // columns of a weight block of the skip flags

// ---------------------------------------------------------------------------
// skip flags: flags[(q * nKB + kb) * nNB + nb] = any nonzero in block (kb, nb)
// of w[q]; one block of 256 threads per weight block. MASK clears the sign
// bits of the 32-bit words (two bf16 or one f32), so -0 counts as zero.

template <uint32_t MASK, int ESIZE>
__global__ void __launch_bounds__(256)
band_flags_kernel(const unsigned char* __restrict__ w, int* __restrict__ flags, int R, int Rout,
                  int nKB, int nNB) {
  constexpr int CH = FLAG_BN * ESIZE / 16;  // 16-byte chunks per block row
  const int nb = blockIdx.x, kb = blockIdx.y, q = blockIdx.z;
  const size_t row_bytes = (size_t)Rout * ESIZE;
  const unsigned char* wq = w + (size_t)q * R * row_bytes;
  int nz = 0;
  for (int e = threadIdx.x; e < FLAG_BK * CH; e += 256) {
    const int r = kb * FLAG_BK + e / CH;
    const int col = nb * FLAG_BN + (e % CH) * (16 / ESIZE);
    if (r < R && col < Rout) {
      const uint4 v = *reinterpret_cast<const uint4*>(wq + r * row_bytes + (size_t)col * ESIZE);
      nz |= ((v.x | v.y | v.z | v.w) & MASK) != 0;
    }
  }
  nz = __syncthreads_or(nz);
  if (threadIdx.x == 0) flags[((size_t)q * nKB + kb) * nNB + nb] = nz;
}

// ---------------------------------------------------------------------------
// the block walk shared by both main kernels

// Stage sidx[q * BM + r] = idx[b, q, m0 + r] (-1 past M) and mark in tapact
// the taps with at least one hit among the block's rows.
template <int BM, int NT>
__device__ void stage_rulebook(const int* __restrict__ ib, int Q, int M, int m0, int* sidx,
                               int* tapact) {
  const int tid = threadIdx.x;
  for (int e = tid; e < Q * BM; e += NT) {
    const int q = e / BM, r = e - q * BM;
    const int m = m0 + r;
    sidx[e] = (m < M) ? ib[(size_t)q * M + m] : -1;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int q = warp; q < Q; q += NT / 32) {
    bool hit = false;
    for (int r = lane; r < BM; r += 32) hit |= sidx[q * BM + r] >= 0;
    const bool any = __any_sync(0xffffffffu, hit);
    if (lane == 0) tapact[q] = any ? 1 : 0;
  }
  __syncthreads();
}

// List in steps[] the (tap, K-block) pairs e = q * nKB + kb, in ascending
// order, whose tap is active and whose weight block under the tile's flag
// columns [nb0, nb0 + nbw) holds a nonzero; returns their count. wcnt holds
// NT / 32 ints of scratch.
template <int NT>
__device__ int list_steps(const int* __restrict__ flags, const int* tapact, int Q, int nKB,
                          int nNB, int nb0, int nbw, int* steps, int* wcnt) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int count = 0;
  for (int base = 0; base < Q * nKB; base += NT) {
    const int e = base + tid;
    bool keep = false;
    if (e < Q * nKB && tapact[e / nKB]) {
      const int* f = flags + (size_t)e * nNB;
      for (int j = nb0; j < nb0 + nbw && j < nNB; ++j) keep |= f[j] != 0;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = count, total = 0;
    for (int k = 0; k < NT / 32; ++k) {
      off += k < warp ? wcnt[k] : 0;
      total += wcnt[k];
    }
    if (keep) steps[off + __popc(bal & ((1u << lane) - 1u))] = e;
    count += total;
    __syncthreads();
  }
  return count;
}

// ---------------------------------------------------------------------------
// bf16: BM x BN tiles on the tensor cores

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;  // 8 warps: 4 (rows) x 2 (columns), warp tiles 32 x BN / 2
constexpr int STAGES = 6;
constexpr int SPS = 2;        // steps per barrier

template <int BN_>
struct Bf16Tile {
  static constexpr int BN = BN_;
  static constexpr int A_ELEMS = BM * BK;        // [128][32], 64-byte rows
  static constexpr int B_ELEMS = BK * BN;        // [32][BN]
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int BCH = BN / 8;             // 16-byte chunks per B row
  static constexpr int C_LD = BN + 8;            // epilogue tile row, bf16
  static constexpr int NT = BN / 16;             // n8 tiles per warp (BN / 2 wide)
  static constexpr size_t STAGE_BYTES = (size_t)STAGES * STAGE * 2;
  static_assert((size_t)BM * C_LD * 2 <= STAGE_BYTES, "C tile must fit in the stages");
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
banded_conv_bf16_kernel(const __nv_bfloat16* __restrict__ table, const int* __restrict__ idx,
                        const __nv_bfloat16* __restrict__ w, const int* __restrict__ flags,
                        __nv_bfloat16* __restrict__ out, int Mb, int R, int Q, int M, int Rout,
                        int nKB, int nNB) {
  constexpr int BN = T::BN, BCH = T::BCH;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][A | B]
  __nv_bfloat16* Cs = st;                                         // [BM][C_LD], epilogue only
  int* sidx = reinterpret_cast<int*>(smem + T::STAGE_BYTES);      // [Q][BM]
  int* steps = sidx + Q * BM;                                     // [Q * nKB]
  int* tapact = steps + Q * nKB;                                  // [Q]
  int* wcnt = tapact + Q;                                         // [THREADS / 32]

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16* tbl = table + (size_t)b * Mb * R;

  stage_rulebook<BM, THREADS>(idx + (size_t)b * Q * M, Q, M, m0, sidx, tapact);
  const int nsteps = list_steps<THREADS>(flags, tapact, Q, nKB, nNB, n0 / FLAG_BN,
                                         BN / FLAG_BN, steps, wcnt);

  auto load = [&](int s, int buf) {
    const int e = steps[s];
    const int q = e / nKB;
    const int k0 = (e - q * nKB) * BK;
    __nv_bfloat16* a = st + buf * T::STAGE;
    __nv_bfloat16* bs = a + T::A_ELEMS;
#pragma unroll
    for (int c16 = tid; c16 < BM * (BK / 8); c16 += THREADS) {
      const int r = c16 / (BK / 8), c = c16 % (BK / 8);
      const int src = sidx[q * BM + r];
      const bool ok = src >= 0 && k0 + c * 8 < R;
      cp_async16(a + swz<BK / 8>(r, c), ok ? tbl + (size_t)src * R + k0 + c * 8 : tbl, ok);
    }
    const __nv_bfloat16* wq = w + (size_t)q * R * Rout;
#pragma unroll
    for (int c16 = tid; c16 < BK * BCH; c16 += THREADS) {
      const int kr = c16 / BCH, c = c16 % BCH;
      const bool ok = k0 + kr < R && n0 + c * 8 < Rout;
      cp_async16(bs + swz<BCH>(kr, c), ok ? wq + (size_t)(k0 + kr) * Rout + n0 + c * 8 : w, ok);
    }
  };

  const int wm = warp / 2, wn = warp % 2;
  float acc[2][T::NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;

  auto compute = [&](int buf) {
    const __nv_bfloat16* a = st + buf * T::STAGE;
    const __nv_bfloat16* bs = a + T::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[T::NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], a + swz<BK / 8>(wm * 32 + mt * 16 + lane % 16, kk / 8 + lane / 16));
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np)
        ldmatrix_x4_trans(bfr[np], bs + swz<BCH>(kk + lane % 8 + ((lane / 8) % 2) * 8,
                                                 (wn * (BN / 2) + np * 16) / 8 + lane / 16));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
          mma_bf16_16816(acc[mt][nt], af[mt], bfr[nt / 2][(nt % 2) * 2],
                         bfr[nt / 2][(nt % 2) * 2 + 1]);
    }
  };
  cp_async_pipeline<STAGES, SPS>([&](int s) { return s < nsteps; }, load, compute);
  __syncthreads();  // every fragment read of the stages is done: Cs may reuse them

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const int r = wm * 32 + mt * 16 + lane / 4;
      const int c = wn * (BN / 2) + nt * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(Cs + r * T::C_LD + c) =
          __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(Cs + (r + 8) * T::C_LD + c) =
          __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  __nv_bfloat16* ob = out + (size_t)b * M * Rout;
  for (int e = tid; e < BM * BCH; e += THREADS) {
    const int r = e / BCH, c = (e % BCH) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < Rout)
      *reinterpret_cast<uint4*>(ob + (size_t)m * Rout + n) =
          *reinterpret_cast<const uint4*>(Cs + r * T::C_LD + c);
  }
}

// ---------------------------------------------------------------------------
// f32: 64 x 64 tiles, plain FMAs

constexpr int FBM = 64;
constexpr int FBN = FLAG_BN;
constexpr int FBK = FLAG_BK;
constexpr int FTHREADS = 128;  // each thread 8 rows x 4 columns

__global__ void __launch_bounds__(FTHREADS)
banded_conv_f32_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                       const float* __restrict__ w, const int* __restrict__ flags,
                       float* __restrict__ out, int Mb, int R, int Q, int M, int Rout, int nKB,
                       int nNB) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* sidx = reinterpret_cast<int*>(smem);  // [Q][FBM]
  int* steps = sidx + Q * FBM;               // [Q * nKB]
  int* tapact = steps + Q * nKB;             // [Q]
  int* wcnt = tapact + Q;                    // [FTHREADS / 32]
  __shared__ float As[FBM][FBK + 1];
  __shared__ float Bs[FBK][FBN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;
  const int tid = threadIdx.x;
  const float* tbl = table + (size_t)b * Mb * R;

  stage_rulebook<FBM, FTHREADS>(idx + (size_t)b * Q * M, Q, M, m0, sidx, tapact);
  const int nsteps = list_steps<FTHREADS>(flags, tapact, Q, nKB, nNB, blockIdx.y, 1, steps, wcnt);
  const int tx = tid % 16, ty = tid / 16;  // columns tx*4..+3, rows ty*8..+7
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < nsteps; ++s) {
    const int e = steps[s];
    const int q = e / nKB;
    const int k0 = (e - q * nKB) * FBK;
    for (int x = tid; x < FBM * FBK; x += FTHREADS) {
      const int r = x / FBK, c = x % FBK;
      const int src = sidx[q * FBM + r];
      As[r][c] = (src >= 0 && k0 + c < R) ? tbl[(size_t)src * R + k0 + c] : 0.0f;
    }
    const float* wq = w + (size_t)q * R * Rout;
    for (int x = tid; x < FBK * FBN; x += FTHREADS) {
      const int r = x / FBN, c = x % FBN;
      Bs[r][c] = (k0 + r < R && n0 + c < Rout) ? wq[(size_t)(k0 + r) * Rout + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < FBK; ++k) {
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = As[ty * 8 + i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* ob = out + (size_t)b * M * Rout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Rout) ob[(size_t)m * Rout + n] = acc[i][j];
    }
  }
}

int tile_n(int R, int Rout) { return (R >= 640 || Rout >= 640) ? 128 : 64; }

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_bf16(const void* table, const void* idx, const void* w, const int* flags, void* out,
                int B, int Mb, int R, int Q, int M, int Rout, int nKB, int nNB, cudaStream_t st) {
  const size_t smem = T::STAGE_BYTES + 4 * ((size_t)Q * BM + (size_t)Q * nKB + Q + THREADS / 32);
  cudaError_t e = set_smem(reinterpret_cast<const void*>(banded_conv_bf16_kernel<T>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + BM - 1) / BM, (Rout + T::BN - 1) / T::BN, B);
  banded_conv_bf16_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(table), static_cast<const int*>(idx),
      static_cast<const __nv_bfloat16*>(w), flags, static_cast<__nv_bfloat16*>(out), Mb, R, Q, M,
      Rout, nKB, nNB);
  return static_cast<int>(cudaGetLastError());
}

template <uint32_t MASK, int ESIZE>
int launch_flags(const void* w, int* flags, int R, int Q, int Rout, int nKB, int nNB,
                 cudaStream_t st) {
  band_flags_kernel<MASK, ESIZE><<<dim3(nNB, nKB, Q), 256, 0, st>>>(
      static_cast<const unsigned char*>(w), flags, R, Rout, nKB, nNB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Column tile of the bf16 kernel for these widths (64 or 128).
extern "C" int banded_conv_tile_n(int R, int Rout) { return tile_n(R, Rout); }

// flags: scratch of at least Q * ceil(R / 32) * ceil(Rout / 64) ints.
extern "C" int banded_conv_bf16(const void* table, const void* idx, const void* w, void* flags,
                                void* out, int B, int Mb, int R, int Q, int M, int Rout,
                                void* stream) {
  if (B == 0 || M == 0 || Rout == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nKB = (R + FLAG_BK - 1) / FLAG_BK, nNB = (Rout + FLAG_BN - 1) / FLAG_BN;
  int* f = static_cast<int*>(flags);
  if (Q == 0 || R == 0) return static_cast<int>(cudaMemsetAsync(out, 0, (size_t)B * M * Rout * 2, st));
  int err = launch_flags<0x7fff7fffu, 2>(w, f, R, Q, Rout, nKB, nNB, st);
  if (err != 0) return err;
  return tile_n(R, Rout) == 128
             ? launch_bf16<Bf16Tile<128>>(table, idx, w, f, out, B, Mb, R, Q, M, Rout, nKB, nNB,
                                          st)
             : launch_bf16<Bf16Tile<64>>(table, idx, w, f, out, B, Mb, R, Q, M, Rout, nKB, nNB,
                                         st);
}

extern "C" int banded_conv_f32(const void* table, const void* idx, const void* w, void* flags,
                               void* out, int B, int Mb, int R, int Q, int M, int Rout,
                               void* stream) {
  if (B == 0 || M == 0 || Rout == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nKB = (R + FLAG_BK - 1) / FLAG_BK, nNB = (Rout + FLAG_BN - 1) / FLAG_BN;
  int* f = static_cast<int*>(flags);
  if (Q == 0 || R == 0) return static_cast<int>(cudaMemsetAsync(out, 0, (size_t)B * M * Rout * 4, st));
  int err = launch_flags<0x7fffffffu, 4>(w, f, R, Q, Rout, nKB, nNB, st);
  if (err != 0) return err;
  const size_t smem = 4 * ((size_t)Q * FBM + (size_t)Q * nKB + Q + FTHREADS / 32);
  const size_t static_smem = sizeof(float) * (FBM * (FBK + 1) + FBK * FBN);
  if (smem + static_smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(banded_conv_f32_kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((M + FBM - 1) / FBM, nNB, B);
  banded_conv_f32_kernel<<<grid, FTHREADS, smem, st>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), f, static_cast<float*>(out), Mb, R, Q, M, Rout, nKB, nNB);
  return static_cast<int>(cudaGetLastError());
}
