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
// Design (a simple, right first version; wgmma/TMA come later):
//   - one block per (64 output rows, 64 output columns, batch);
//   - the block stages its [Q, 64] rulebook slice in shared memory and skips
//     every tap with no hit among its rows (ghost rows and misses are common);
//   - per (active tap, 32-wide R chunk) it gathers the 64 indexed table rows
//     and the w[q] tile into shared memory with 16-byte cp.async (zero fill
//     for misses and ragged edges), double-buffered;
//   - bf16: 4 warps run WMMA 16x16x16 with f32 accumulators in registers;
//     f32: plain FMA per thread (the f32 path serves parity runs, not speed).
//
// Bound on the card: 2 * nnz(idx >= 0) * R * Rout operations against the
// 989 TFLOP/s bf16 tensor-core peak, or the bytes of table, idx, w and out
// against 3.35 TB/s, whichever is larger. At the L0 subm conv (B=2, M=48000,
// Q=9, R=288, Rout=256) the dense count is 2*2*48000*9*288*256 = 1.3e11
// operations (0.13 ms); the hit count is a fraction of it. The banded weights
// are mostly zeros, which a later kernel can skip.
//
// Alignment contract (checked by the Python wrapper): R % 8 == 0,
// Rout % 8 == 0, all pointers 16-byte aligned, tensors contiguous.

#include "common.cuh"

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // reduction chunk
constexpr int THREADS = 128;  // 4 warps: 2 x 2 warp tiles of 32 x 32
constexpr int A_LD = BK + 8;  // bf16 per shared row: 16-byte aligned, banks shifted
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;  // floats
constexpr int kTileBytes = 2 * BM * A_LD * 2 + 2 * BK * B_LD * 2;
static_assert(BM * C_LD * 4 <= kTileBytes, "C tile must fit in the A/B stages");
static_assert(kTileBytes % 16 == 0, "rulebook slice must stay aligned");

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

// Stage the block's rulebook slice sidx[q * BM + r] = idx[b, q, m0 + r] (-1
// past M) and list the taps with at least one hit in sact; returns their
// count. flags holds Q ints of scratch.
__device__ int stage_rulebook(const int* __restrict__ ib, int Q, int M, int m0,
                              int* sidx, int* flags, int* sact) {
  const int tid = threadIdx.x;
  for (int e = tid; e < Q * BM; e += THREADS) {
    const int q = e / BM, r = e - q * BM;
    const int m = m0 + r;
    sidx[e] = (m < M) ? ib[(size_t)q * M + m] : -1;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int q = warp; q < Q; q += THREADS / 32) {
    const bool hit = sidx[q * BM + lane] >= 0 || sidx[q * BM + lane + 32] >= 0;
    const bool any = __any_sync(0xffffffffu, hit);
    if (lane == 0) flags[q] = any ? 1 : 0;
  }
  __syncthreads();
  __shared__ int nact;
  if (tid == 0) {
    int n = 0;
    for (int q = 0; q < Q; ++q)
      if (flags[q]) sact[n++] = q;
    nact = n;
  }
  __syncthreads();
  return nact;
}

__global__ void __launch_bounds__(THREADS)
banded_conv_bf16_kernel(const __nv_bfloat16* __restrict__ table, const int* __restrict__ idx,
                        const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
                        int Mb, int R, int Q, int M, int Rout) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][A_LD]
  __nv_bfloat16* Bs = As + 2 * BM * A_LD;                       // [2][BK][B_LD]
  float* Cs = reinterpret_cast<float*>(smem);                   // [BM][C_LD], epilogue only
  int* sidx = reinterpret_cast<int*>(smem + kTileBytes);        // [Q][BM]
  int* flags = sidx + Q * BM;                                   // [Q]
  int* sact = flags + Q;                                        // [Q]

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const __nv_bfloat16* tbl = table + (size_t)b * Mb * R;

  const int nact = stage_rulebook(idx + (size_t)b * Q * M, Q, M, m0, sidx, flags, sact);
  const int nk = (R + BK - 1) / BK;
  const int steps = nact * nk;

  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto load_stage = [&](int s, int buf) {
    const int q = sact[s / nk];
    const int k0 = (s % nk) * BK;
    __nv_bfloat16* a = As + buf * BM * A_LD;
    for (int e = tid; e < BM * (BK / 8); e += THREADS) {
      const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
      const int src = sidx[q * BM + r];
      const bool ok = src >= 0 && (k0 + c) < R;
      const __nv_bfloat16* g = ok ? tbl + (size_t)src * R + k0 + c : tbl;
      cp_async16(a + r * A_LD + c, g, ok);
    }
    __nv_bfloat16* bs = Bs + buf * BK * B_LD;
    const __nv_bfloat16* wq = w + (size_t)q * R * Rout;
    for (int e = tid; e < BK * (BN / 8); e += THREADS) {
      const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
      const bool ok = (k0 + r) < R && (n0 + c) < Rout;
      const __nv_bfloat16* g = ok ? wq + (size_t)(k0 + r) * Rout + n0 + c : w;
      cp_async16(bs + r * B_LD + c, g, ok);
    }
    cp_async_commit();
  };

  if (steps > 0) load_stage(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) {
      load_stage(s + 1, buf ^ 1);  // buf ^ 1 was released by the barrier ending step s - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a = As + buf * BM * A_LD;
    const __nv_bfloat16* bs = Bs + buf * BK * B_LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the C tile reuses the A/B stages: every cp.async group has completed and
  // the barrier ending the last step ordered all fragment reads before this
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();
  __nv_bfloat16* ob = out + (size_t)b * M * Rout;
  for (int e = tid; e < BM * (BN / 8); e += THREADS) {
    const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < Rout) {
      const float* src = Cs + r * C_LD + c;
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = __float2bfloat16_rn(src[t]);
      *reinterpret_cast<uint4*>(ob + (size_t)m * Rout + n) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
banded_conv_f32_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                       const float* __restrict__ w, float* __restrict__ out,
                       int Mb, int R, int Q, int M, int Rout) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* sidx = reinterpret_cast<int*>(smem);  // [Q][BM]
  int* flags = sidx + Q * BM;
  int* sact = flags + Q;
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BK][BN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const float* tbl = table + (size_t)b * Mb * R;

  const int nact = stage_rulebook(idx + (size_t)b * Q * M, Q, M, m0, sidx, flags, sact);
  const int nk = (R + BK - 1) / BK;
  const int tx = tid % 16, ty = tid / 16;  // columns tx*4..+3, rows ty*8..+7
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < nact * nk; ++s) {
    const int q = sact[s / nk];
    const int k0 = (s % nk) * BK;
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int src = sidx[q * BM + r];
      As[r][c] = (src >= 0 && k0 + c < R) ? tbl[(size_t)src * R + k0 + c] : 0.0f;
    }
    const float* wq = w + (size_t)q * R * Rout;
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      Bs[r][c] = (k0 + r < R && n0 + c < Rout) ? wq[(size_t)(k0 + r) * Rout + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
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

}  // namespace

extern "C" int banded_conv_bf16(const void* table, const void* idx, const void* w, void* out,
                                int B, int Mb, int R, int Q, int M, int Rout, void* stream) {
  const size_t smem = kTileBytes + (size_t)Q * BM * 4 + 2 * (size_t)Q * 4;
  if (B == 0 || M == 0 || Rout == 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(banded_conv_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((M + BM - 1) / BM, (Rout + BN - 1) / BN, B);
  banded_conv_bf16_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(table), static_cast<const int*>(idx),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), Mb, R, Q, M, Rout);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int banded_conv_f32(const void* table, const void* idx, const void* w, void* out,
                               int B, int Mb, int R, int Q, int M, int Rout, void* stream) {
  const size_t smem = (size_t)Q * BM * 4 + 2 * (size_t)Q * 4;
  if (B == 0 || M == 0 || Rout == 0) return 0;
  const size_t static_smem = sizeof(float) * (BM * (BK + 1) + BK * BN) + sizeof(int);
  if (smem + static_smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(banded_conv_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((M + BM - 1) / BM, (Rout + BN - 1) / BN, B);
  banded_conv_f32_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), Mb, R, Q, M, Rout);
  return static_cast<int>(cudaGetLastError());
}
