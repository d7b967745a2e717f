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
// flattened (b, m) rows and reduces in two deterministic passes.
//
// Design (a simple, right first version):
//   - one block per (64 x 64 tile of dw[q], tap q, split s of the B*M rows);
//   - per step the block gathers 64 table rows (zero fill for misses and the
//     ragged edge) and the 64 matching g rows into shared memory with 16-byte
//     cp.async, double-buffered, and skips the product when no row of the step
//     hits (ghost rows, padding rows past the last brick, border taps);
//   - bf16: 4 warps run WMMA 16x16x16 (A column-major: the gathered tile is
//     stored [m][r] and multiplied as its transpose) with f32 accumulators;
//     f32: plain FMA per thread (the f32 path serves parity runs, not speed);
//   - each split writes its partial tile to scratch [S, Q, R, Rout]; a second
//     small kernel sums the splits in order, so the result does not depend on
//     the order of atomics (with one split the tile goes straight to dw).
//
// Bound on the card: 2 * nnz(idx >= 0) * R * Rout operations against the
// 989 TFLOP/s bf16 tensor-core peak, or the bytes of table, idx, g and dw
// against 3.35 TB/s, whichever is larger. The tile scheme re-reads the table
// once per Rout tile and g once per R tile (from L2 for the most part).
//
// Alignment contract (checked by the Python wrapper): R % 8 == 0,
// Rout % 8 == 0, all pointers 16-byte aligned, tensors contiguous.

#include "common.cuh"

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BR = 64;        // dw rows per block (table columns r)
constexpr int BO = 64;        // dw columns per block (g columns o)
constexpr int BKM = 64;       // (b, m) rows reduced per step, bf16
constexpr int BKF = 32;       // the same, f32
constexpr int THREADS = 128;  // 4 warps: 2 x 2 warp tiles of 32 x 32
constexpr int A_LD = BR + 8;  // bf16 per shared row: 16-byte aligned, banks shifted
constexpr int G_LD = BO + 8;
constexpr int C_LD = BO + 4;  // floats
constexpr int kStageElems = BKM * A_LD + BKM * G_LD;
static_assert(BR * C_LD * 4 <= 2 * kStageElems * 2, "C tile must fit in the stages");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// grid: x = R tile + nRt * Rout tile, y = tap q, z = split s
__global__ void __launch_bounds__(THREADS)
banded_dw_bf16_kernel(const __nv_bfloat16* __restrict__ table, const int* __restrict__ idx,
                      const __nv_bfloat16* __restrict__ g, float* __restrict__ part,
                      int rows, int Mb, int R, int Q, int M, int Rout, int per_split, int nRt) {
  __shared__ __align__(128) unsigned char raw[2 * kStageElems * 2];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(raw);  // 2 stages of [A | G]
  float* Cs = reinterpret_cast<float*>(raw);                    // [BR][C_LD], epilogue only

  const int tid = threadIdx.x;
  const int r0 = (blockIdx.x % nRt) * BR;
  const int o0 = (blockIdx.x / nRt) * BO;
  const int q = blockIdx.y;
  const int s = blockIdx.z;
  const int i_begin = s * per_split;
  const int i_end = min(i_begin + per_split, rows);
  const int steps = (i_end > i_begin) ? (i_end - i_begin + BKM - 1) / BKM : 0;

  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // issues the copies of step t into stage buf; true if one of this thread's
  // table chunks is a hit
  auto load_stage = [&](int t, int buf) -> bool {
    __nv_bfloat16* a = smem + buf * kStageElems;
    __nv_bfloat16* gs = a + BKM * A_LD;
    const int base = i_begin + t * BKM;
    bool hit = false;
    for (int e = tid; e < BKM * (BR / 8); e += THREADS) {
      const int row = e / (BR / 8), c = (e % (BR / 8)) * 8;
      const int i = base + row;
      int src = -1, b = 0;
      if (i < i_end) {
        b = i / M;
        src = idx[((size_t)b * Q + q) * M + (i - b * M)];
      }
      const bool ok = src >= 0 && (r0 + c) < R;
      const __nv_bfloat16* p = ok ? table + ((size_t)b * Mb + src) * R + r0 + c : table;
      cp_async16(a + row * A_LD + c, p, ok);
      hit |= ok;
    }
    for (int e = tid; e < BKM * (BO / 8); e += THREADS) {
      const int row = e / (BO / 8), c = (e % (BO / 8)) * 8;
      const int i = base + row;
      const bool ok = i < i_end && (o0 + c) < Rout;
      const __nv_bfloat16* p = ok ? g + (size_t)i * Rout + o0 + c : g;
      cp_async16(gs + row * G_LD + c, p, ok);
    }
    cp_async_commit();
    return hit;
  };

  bool hit_cur = false, hit_next = false;
  if (steps > 0) hit_cur = load_stage(0, 0);
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) {
      hit_next = load_stage(t + 1, buf ^ 1);  // released by the barrier ending step t - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int any = __syncthreads_or(hit_cur ? 1 : 0);
    if (any) {
      const __nv_bfloat16* a = smem + buf * kStageElems;
      const __nv_bfloat16* gs = a + BKM * A_LD;
#pragma unroll
      for (int kk = 0; kk < BKM; kk += 16) {
        // A^T: element (r, m) of the product's left operand sits at a[m * A_LD + r]
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a + kk * A_LD + wm * 32 + i * 16, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], gs + kk * G_LD + wn * 32 + j * 16, G_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
    hit_cur = hit_next;
  }

  // the C tile reuses the stages: every cp.async group has completed and the
  // barrier ending the last step ordered all fragment reads before this
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();
  float* pq = part + ((size_t)s * Q + q) * R * Rout;
  for (int e = tid; e < BR * (BO / 4); e += THREADS) {
    const int row = e / (BO / 4), c = (e % (BO / 4)) * 4;
    const int r = r0 + row, o = o0 + c;
    if (r < R && o < Rout)
      *reinterpret_cast<float4*>(pq + (size_t)r * Rout + o) =
          *reinterpret_cast<const float4*>(Cs + row * C_LD + c);
  }
}

__global__ void __launch_bounds__(THREADS)
banded_dw_f32_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ g, float* __restrict__ part,
                     int rows, int Mb, int R, int Q, int M, int Rout, int per_split, int nRt) {
  __shared__ float As[BKF][BR];
  __shared__ float Gs[BKF][BO];
  __shared__ int srow[BKF];  // table row (b * Mb + src) of each step row, -1 = miss

  const int tid = threadIdx.x;
  const int r0 = (blockIdx.x % nRt) * BR;
  const int o0 = (blockIdx.x / nRt) * BO;
  const int q = blockIdx.y;
  const int s = blockIdx.z;
  const int i_begin = s * per_split;
  const int i_end = min(i_begin + per_split, rows);
  const int tx = tid % 16, ty = tid / 16;  // dw columns tx*4..+3, dw rows ty*8..+7
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int base = i_begin; base < i_end; base += BKF) {
    int mine = 0;
    if (tid < BKF) {
      const int i = base + tid;
      int row = -1;
      if (i < i_end) {
        const int b = i / M;
        const int src = idx[((size_t)b * Q + q) * M + (i - b * M)];
        if (src >= 0) row = b * Mb + src;
      }
      srow[tid] = row;
      mine = row >= 0;
    }
    const int any = __syncthreads_or(mine);
    if (any) {
      for (int e = tid; e < BKF * BR; e += THREADS) {
        const int k = e / BR, c = e % BR;
        const int row = srow[k];
        As[k][c] = (row >= 0 && r0 + c < R) ? table[(size_t)row * R + r0 + c] : 0.0f;
      }
      for (int e = tid; e < BKF * BO; e += THREADS) {
        const int k = e / BO, c = e % BO;
        const int i = base + k;
        Gs[k][c] = (i < i_end && o0 + c < Rout) ? g[(size_t)i * Rout + o0 + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < BKF; ++k) {
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Gs[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = As[k][ty * 8 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* pq = part + ((size_t)s * Q + q) * R * Rout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + ty * 8 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < Rout) pq[(size_t)r * Rout + o] = acc[i][j];
    }
  }
}

// dw[e] = sum over the splits, in split order
__global__ void banded_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                        size_t n, int S) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int s = 0; s < S; ++s) sum += part[(size_t)s * n + e];
    dw[e] = sum;
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, const void* table, const void* idx, const void* g, void* dw,
           void* part, int B, int Mb, int R, int Q, int M, int Rout, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)Q * R * Rout;
  if (n == 0) return 0;
  const int rows = B * M;
  if (rows == 0) return static_cast<int>(cudaMemsetAsync(dw, 0, n * sizeof(float), st));
  if (S < 1) S = 1;
  // whole steps per split, so that only the last split has a ragged edge
  const int per_split = ((rows + S - 1) / S + BKM - 1) / BKM * BKM;
  const int nRt = (R + BR - 1) / BR, nOt = (Rout + BO - 1) / BO;
  float* out = static_cast<float*>(S > 1 ? part : dw);
  dim3 grid(nRt * nOt, Q, S);
  kernel<<<grid, THREADS, 0, st>>>(static_cast<const T*>(table), static_cast<const int*>(idx),
                                   static_cast<const T*>(g), out, rows, Mb, R, Q, M, Rout,
                                   per_split, nRt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return static_cast<int>(e);
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  banded_dw_reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                                  static_cast<float*>(dw), n, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part: scratch [S, Q, R, Rout] f32, read only when S > 1
extern "C" int banded_dw_bf16(const void* table, const void* idx, const void* g, void* dw,
                              void* part, int B, int Mb, int R, int Q, int M, int Rout, int S,
                              void* stream) {
  return launch<__nv_bfloat16>(banded_dw_bf16_kernel, table, idx, g, dw, part, B, Mb, R, Q, M,
                               Rout, S, stream);
}

extern "C" int banded_dw_f32(const void* table, const void* idx, const void* g, void* dw,
                             void* part, int B, int Mb, int R, int Q, int M, int Rout, int S,
                             void* stream) {
  return launch<float>(banded_dw_f32_kernel, table, idx, g, dw, part, B, Mb, R, Q, M, Rout, S,
                       stream);
}
