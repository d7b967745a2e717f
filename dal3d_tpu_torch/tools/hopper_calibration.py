#!/usr/bin/env python
"""Calibration of the building blocks of the banded kernels on the card.

    python -m dal3d_tpu_torch.tools.hopper_calibration

Builds one small CUDA program from the port's device helpers
(``ops/csrc/common.cuh``) into ``build/calibration/`` and prints, on the
CUDA card, what each piece of the banded kernels' main loop sustains alone
and together:

  - ``mma.sync`` m16n8k16 (bf16 in, f32 accumulate) from registers;
  - ``mma.sync`` m16n8k8 (TF32 in, f32 accumulate) from registers, alone and
    as the fused gather-GEMM's 3xTF32 step (operands split into big and
    small TF32 parts, three products into fresh accumulators, added to the
    sums in f32), with the split by cvt.rna or by integer operations: the
    ceiling of that kernel's inner loop, in TFLOP/s of TF32 work and of the
    f32 work it stands for;
  - TF32 ``wgmma`` m64n128k8 from 128-byte-swizzled shared tiles (two
    warpgroups a block), chained into one accumulator, and as the pairwise
    L2 kernel's 3xTF32 chunk (twelve instructions into a fresh accumulator,
    waited for, then added to the f32 sums): the ceiling of that kernel's
    consumer loop;
  - ``ldmatrix.trans`` + ``mma.sync`` from a swizzled shared tile, for the
    warp tiles the kernels use (32 x 32, 64 x 32, 64 x 64);
  - gathers of random rows into a 4-stage shared ring (16-byte ``cp.async``,
    or global loads through registers), for row pieces of 64-512 bytes;
  - a K1-shaped main loop (128 x 64 tile, 8 warps of 32 x 32, the port's
    ``cp_async_pipeline``): compute alone, the pipeline without copies, and
    with copies of random rows from a 2.3 MB and a 115 MB table;
  - the assignment kernel's dependent step (``ops/csrc/lsa.cu``) alone:
    one warp, 7 columns a lane (201 columns), each step reading the row
    that the previous step's argmin chose from shared memory, relaxing and
    masking by selects, taking the warp's argmin (``redux.sync.min`` on an
    order key, a ballot, four shuffles), updating, and reading the next
    row's index and u from shared memory: the latency floor of a relax
    step, in ns a step.

Each line gives TFLOP/s of bf16 work or TB/s of gathered bytes, from CUDA
events around one launch. Needs the CUDA card and nvcc; exits nonzero
without them. Development numbers for ``PERF.md``, not part of any path.
"""
import os
import subprocess
import sys
from pathlib import Path

from ..ops import _build

SOURCE = r'''
#include "common.cuh"
#include <cstdio>
#include <cuda_bf16.h>
using namespace dal3d;

static float elapsed(cudaEvent_t a, cudaEvent_t b) {
  float ms;
  cudaEventSynchronize(b);
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

// mma.sync from registers: 8 independent accumulators a warp
__global__ void __launch_bounds__(256, 2) mma_regs(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_bf16_16816(acc[j], a, b0, b1);
  float s = 0;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// TF32 mma.sync from registers: 8 independent accumulators a warp
__global__ void __launch_bounds__(256, 2) mma_tf32_regs(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(acc[j], a, b0, b1);
  float s = 0;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// big + small with round-to-nearest-away TF32 parts: both by cvt.rna (MODE
// 0), or big by integer operations on the f32 word that give the same bits
// (MODE 1, the fused gather-GEMM's split)
template <int MODE>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = MODE == 0 ? tf32_rna(x) : (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = tf32_rna(x - __uint_as_float(big));
}

// the fused gather-GEMM's 3xTF32 step on a 32 x 64 warp tile, operands from
// registers (changing every iteration, so nothing is hoisted): A and B split
// into big and small, for each pair of 8-column tiles small*big, big*small,
// big*big into fresh accumulators, then added to the f32 sums
template <int MODE>
__global__ void __launch_bounds__(256, 2) tf32x3_step(float* out, int iters) {
  float acc[2][8][4] = {};
  const float base = 1.0f + threadIdx.x * 1e-3f;
  for (int it = 0; it < iters; ++it) {
    const float x = base + it * 1e-6f;
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) split<MODE>(x * (i * 4 + q + 1), ab[i][q], as[i][q]);
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += 2) {
      uint32_t bb[2][2], bs[2][2];
      float part[2][2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) split<MODE>(x * (j0 + jj + h + 0.5f), bb[jj][h], bs[jj][h]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][jj][q] = 0.0f;
          mma_tf32(part[i][jj], as[i], bb[jj][0], bb[jj][1]);
        }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(part[i][jj], ab[i], bs[jj][0], bs[jj][1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(part[i][jj], ab[i], bb[jj][0], bb[jj][1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j0 + jj][q] += part[i][jj][q];
    }
  }
  float s = 0;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j][0] + acc[i][j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// TF32 wgmma m64n128k8 from shared memory: A [128][32] and B [128][32]
// f32 tiles (128-byte rows, 1024-byte aligned), two warpgroups a block, each
// on its 64 rows of A. CHUNK 0: every instruction chained into one
// accumulator; CHUNK 1: the pairwise L2 kernel's step, 3 x 4 instructions
// into a fresh accumulator, waited for, then added to the f32 sums.
template <int CHUNK>
__global__ void __launch_bounds__(256, 1) wgmma_tf32(float* out, int iters) {
  extern __shared__ unsigned char raw[];
  unsigned char* sm = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
  for (int i = threadIdx.x; i < 256 * 32; i += 256)
    reinterpret_cast<float*>(sm)[i] = (i % 7) * 0.25f;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  const int wg = threadIdx.x / 128;
  const uint64_t a = wgmma_desc_sw128(sm + wg * 64 * 128), b = wgmma_desc_sw128(sm + 128 * 128);
  float acc[64], part[64];
  for (int q = 0; q < 64; ++q) acc[q] = part[q] = 0.0f;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence_operands(part);
    wgmma_fence();
    if (CHUNK) {
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k8_tf32(part, a + 2 * kk, b + 2 * kk, p > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(part);
#pragma unroll
      for (int q = 0; q < 64; ++q) acc[q] = __fadd_rn(acc[q], part[q]);
    } else {
#pragma unroll
      for (int kk = 0; kk < 12; ++kk) wgmma_m64n128k8_tf32(part, a + 2 * (kk % 4), b + 2 * (kk % 4), 1);
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
  wgmma_fence_operands(part);
  float s = 0;
  for (int q = 0; q < 64; ++q) s += acc[q] + part[q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// ldmatrix.trans + mma.sync from [32][256] swizzled tiles; 8 warps of
// (16 MT) x (16 NP) as 2 x 4
template <int MT, int NP>
__global__ void __launch_bounds__(256, 1) mma_smem(float* out, int iters) {
  __shared__ __align__(128) __nv_bfloat16 sa[32 * 256], sb[32 * 256];
  for (int i = threadIdx.x; i < 32 * 256; i += 256) {
    sa[i] = __float2bfloat16(i * 1e-3f);
    sb[i] = sa[i];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wr = warp / 4, wo = warp % 4;
  float acc[MT][NP * 2][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int kk = 0; kk < 32; kk += 16) {
      uint32_t af[MT][4], bf[NP][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4_trans(af[mt], sa + swz<32>(kk + lane % 8 + (lane / 16) * 8,
                                               (wr * MT * 16 + mt * 16) / 8 + (lane / 8) % 2));
#pragma unroll
      for (int np = 0; np < NP; ++np)
        ldmatrix_x4_trans(bf[np], sb + swz<32>(kk + lane % 8 + ((lane / 8) % 2) * 8,
                                               (wo * NP * 16 + np * 16) / 8 + lane / 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NP * 2; ++nt)
          mma_bf16_16816(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2], bf[nt / 2][(nt % 2) * 2 + 1]);
    }
  }
  float s = 0;
  for (int mt = 0; mt < MT; ++mt)
    for (int nt = 0; nt < NP * 2; ++nt) s += acc[mt][nt][0] + acc[mt][nt][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ unsigned row_hash(unsigned h) {
  h ^= h >> 13;
  h *= 3266489917u;
  return h ^ (h >> 16);
}

// gathers of ROWS random rows x SEG bytes a step into a 4-stage ring;
// LDG: through registers instead of cp.async
template <bool LDG, int SEG, int ROWS>
__global__ void __launch_bounds__(256, 2)
gather(const unsigned char* __restrict__ src, int nrows, int rowb, float* out, int steps) {
  extern __shared__ __align__(128) unsigned char sm[];
  constexpr int TILE = ROWS * SEG, STG = 4;
  const int tid = threadIdx.x;
  float acc = 0;
  for (int s = 0; s < steps + STG - 1; ++s) {
    if (s < steps) {
      unsigned char* dst = sm + (s % STG) * TILE;
      for (int e = tid; e < TILE / 16; e += 256) {
        const int r = e / (SEG / 16), c = e % (SEG / 16);
        const unsigned row = row_hash(blockIdx.x * 7919u + (s * ROWS + r) * 2246822519u) % nrows;
        const unsigned char* g = src + (size_t)row * rowb + c * 16;
        if (LDG) {
          *reinterpret_cast<uint4*>(dst + e * 16) = __ldg(reinterpret_cast<const uint4*>(g));
        } else {
          cp_async16(dst + e * 16, g, true);
        }
      }
      if (!LDG) cp_async_commit();
    }
    const int t = s - (STG - 1);
    if (t >= 0) {
      if (!LDG) cp_async_wait<STG - 1>();
      __syncthreads();
      acc += reinterpret_cast<const float*>(sm + (t % STG) * TILE)[tid % (TILE / 4)];
      __syncthreads();
    }
  }
  out[blockIdx.x * 256 + tid] = acc;
}

// K1-shaped main loop: A [128][32] of random rows, B [32][64]; MODE 0: compute
// alone on one stage; 1: pipeline without copies; 2: pipeline with copies
template <int MODE>
__global__ void __launch_bounds__(256, 2)
k1_loop(const __nv_bfloat16* __restrict__ src, int nrows, float* out, int iters) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
  constexpr int STAGE = 128 * 32 + 32 * 64;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, wm = warp / 2, wn = warp % 2;
  float acc[2][4][4] = {};
  auto load = [&](int s, int buf) {
    if (MODE < 2) return;
    __nv_bfloat16* a = st + buf * STAGE;
    __nv_bfloat16* bs = a + 128 * 32;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int c16 = tid + it * 256, r = c16 / 4, c = c16 % 4;
      const unsigned row = row_hash(blockIdx.x * 7919u + (s * 128 + r) * 2246822519u) % nrows;
      cp_async16(a + swz<4>(r, c), src + (size_t)row * 288 + c * 8, true);
    }
    cp_async16(bs + swz<8>(tid / 8, tid % 8), src + (size_t)(tid / 8) * 288 + (tid % 8) * 8, true);
  };
  auto compute = [&](int buf) {
    const __nv_bfloat16* a = st + buf * STAGE;
    const __nv_bfloat16* bs = a + 128 * 32;
#pragma unroll
    for (int kk = 0; kk < 32; kk += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], a + swz<4>(wm * 32 + mt * 16 + lane % 16, kk / 8 + lane / 16));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bf[np], bs + swz<8>(kk + lane % 8 + ((lane / 8) % 2) * 8,
                                              (wn * 32 + np * 16) / 8 + lane / 16));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16_16816(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2], bf[nt / 2][(nt % 2) * 2 + 1]);
    }
  };
  if (MODE == 0) {
    for (int i = 0; i < iters; ++i) compute(0);
  } else {
    cp_async_pipeline<6, 2>([&](int s) { return s < iters; }, load, compute);
  }
  float s = 0;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) s += acc[i][j][0] + acc[i][j][3];
  out[blockIdx.x * 256 + tid] = s;
}

// the assignment kernel's relax step as a chain (ops/csrc/lsa.cu's body):
// R cost values a lane from a [ROWS][R][32] shared table at the row the
// previous step chose, relax / mask / first least by selects, the warp's
// argmin (redux.sync.min on an order key, a ballot, four shuffles), the
// updates by selects, then the next row's index and u from shared memory
template <int R>
__global__ void __launch_bounds__(32) lsa_chain(float* out, int steps) {
  constexpr int ROWS = 32;
  __shared__ float tbl[ROWS * R * 32];
  __shared__ float u[ROWS + 1];
  __shared__ int pcol[R * 32];
  const int lane = threadIdx.x, jl = lane * R;
  for (int e = lane; e < ROWS * R * 32; e += 32) tbl[e] = (e * 2654435761u % 1000) * 1e-3f;
  for (int e = lane; e <= ROWS; e += 32) u[e] = 0.0f;
  for (int e = lane; e < R * 32; e += 32) pcol[e] = 1 + (e * 7 + 3) % ROWS;
  __syncwarp();
  float v[R], minv[R], uc[R];
  int way[R];
  for (int r = 0; r < R; ++r) {
    v[r] = uc[r] = 0.0f;
    minv[r] = 1e30f;
    way[r] = 0;
  }
  unsigned used = 0;
  int i0 = 1, j0 = 0;
  float ui0 = 0.0f;
  for (int s = 0; s < steps; ++s) {
    float cv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cv[r] = tbl[((i0 - 1) * R + r) * 32 + lane];
    float best = __int_as_float(0x7f800000), bu = 0.0f;
    int br = 0, bused = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool now = j0 == jl + r;
      uc[r] = now ? ui0 : uc[r];
      const bool fr = !((used >> r) & 1u);
      const float cur = cv[r] - ui0 - v[r];
      const bool upd = fr && cur < minv[r];
      minv[r] = upd ? cur : minv[r];
      way[r] = upd ? j0 : way[r];
      const float masked = fr ? minv[r] : 1e30f;
      const bool take = masked < best;
      best = take ? masked : best;
      br = take ? r : br;
      bused = take ? !fr : bused;
      bu = take ? uc[r] : bu;
    }
    const unsigned b = __float_as_uint(best == 0.0f ? 0.0f : best);
    const unsigned key = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    const unsigned least = __reduce_min_sync(0xffffffffu, key);
    const int win = __ffs(__ballot_sync(0xffffffffu, key == least)) - 1;
    const int j1 = __shfl_sync(0xffffffffu, jl + br, win);
    const float delta = __shfl_sync(0xffffffffu, best, win);
    const int wused = __shfl_sync(0xffffffffu, bused, win);
    const float wu = __shfl_sync(0xffffffffu, bu, win);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ur = (used >> r) & 1u;
      uc[r] = ur ? uc[r] + delta : uc[r];
      v[r] = ur ? v[r] - delta : v[r];
      minv[r] = ur ? minv[r] : minv[r] - delta + 1e-3f;
    }
    j0 = j1;
    i0 = pcol[j1];
    ui0 = wused ? wu + delta : u[i0];
  }
  out[lane] = minv[0] + v[0] + uc[0] + way[0] + i0;
}

int main() {
  const int sms = 132;
  float* out;
  cudaMalloc(&out, 4096 * 256 * 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  {
    const int iters = 4096, blocks = sms * 2;
    mma_regs<<<blocks, 256>>>(out, 16);
    cudaEventRecord(a);
    mma_regs<<<blocks, 256>>>(out, iters);
    cudaEventRecord(b);
    const double f = 8.0 * 4096 * iters * blocks * 8;
    printf("mma.sync from registers: %.1f TFLOP/s\n", f / elapsed(a, b) / 1e9);
  }
  {
    const int iters = 4096, blocks = sms * 2;
    mma_tf32_regs<<<blocks, 256>>>(out, 16);
    cudaEventRecord(a);
    mma_tf32_regs<<<blocks, 256>>>(out, iters);
    cudaEventRecord(b);
    const double f = 8.0 * 2048 * iters * blocks * 8;
    printf("mma.sync TF32 m16n8k8 from registers: %.1f TFLOP/s\n", f / elapsed(a, b) / 1e9);
  }
#define TF32X3(MODE, NAME)                                                              \
  {                                                                                     \
    const int iters = 2048, blocks = sms * 2;                                           \
    tf32x3_step<MODE><<<blocks, 256>>>(out, 16);                                        \
    cudaEventRecord(a);                                                                 \
    tf32x3_step<MODE><<<blocks, 256>>>(out, iters);                                     \
    cudaEventRecord(b);                                                                 \
    const double f = 3.0 * 16 * 2048 * iters * blocks * 8; /* 3 passes, 16 tiles */     \
    const float ms = elapsed(a, b);                                                     \
    printf("3xTF32 step, 32 x 64 warp tile, %s: %.1f TFLOP/s of TF32 work, %.1f TFLOP/s " \
           "of f32 work\n", NAME, f / ms / 1e9, f / 3 / ms / 1e9);                      \
  }
  TF32X3(0, "both parts by cvt.rna")
  TF32X3(1, "big by integer operations")
#define WGMMA(CHUNK, NAME)                                                               \
  {                                                                                      \
    const int iters = 4096, blocks = sms, smem = 256 * 128 + 1024;                       \
    cudaFuncSetAttribute(wgmma_tf32<CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         smem);                                                          \
    wgmma_tf32<CHUNK><<<blocks, 256, smem>>>(out, 16);                                    \
    cudaEventRecord(a);                                                                  \
    wgmma_tf32<CHUNK><<<blocks, 256, smem>>>(out, iters);                                 \
    cudaEventRecord(b);                                                                  \
    const double f = 2.0 * 64 * 128 * 8 * 12 * 2 * (double)iters * blocks;               \
    const float ms = elapsed(a, b);                                                      \
    printf("wgmma TF32 m64n128k8 from shared memory, %s: %.1f TFLOP/s of TF32 work, "    \
           "%.1f TFLOP/s of f32 work as 3xTF32\n", NAME, f / ms / 1e9, f / 3 / ms / 1e9);  \
  }
  WGMMA(0, "chained into one accumulator")
  WGMMA(1, "the pairwise L2 kernel's chunk (12 into a fresh accumulator, wait, add)")
#define SMEM(MT, NP, NAME)                                                        \
  {                                                                               \
    const int iters = 4096, blocks = sms;                                          \
    mma_smem<MT, NP><<<blocks, 256>>>(out, 16);                                    \
    cudaEventRecord(a);                                                           \
    mma_smem<MT, NP><<<blocks, 256>>>(out, iters);                                 \
    cudaEventRecord(b);                                                           \
    const double f = 2.0 * MT * NP * 2 * 4096 * iters * blocks * 8;               \
    printf("ldmatrix.trans + mma.sync, warp tile %s: %.1f TFLOP/s\n", NAME,        \
           f / elapsed(a, b) / 1e9);                                               \
  }
  SMEM(2, 2, "32 x 32")
  SMEM(4, 2, "64 x 32")
  SMEM(4, 4, "64 x 64")
  const size_t rowb = 1536, nrows = 40000;
  unsigned char* src;
  cudaMalloc(&src, rowb * 80000 * 2);
  cudaMemset(src, 0, rowb * 80000 * 2);
#define GATHER(LDG, SEG, ROWS, NAME)                                                   \
  {                                                                                    \
    const int steps = 512, blocks = sms * 2, smem = 4 * ROWS * SEG;                    \
    cudaFuncSetAttribute(gather<LDG, SEG, ROWS>,                                       \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);           \
    gather<LDG, SEG, ROWS><<<blocks, 256, smem>>>(src, nrows, rowb, out, 8);           \
    cudaEventRecord(a);                                                                \
    gather<LDG, SEG, ROWS><<<blocks, 256, smem>>>(src, nrows, rowb, out, steps);       \
    cudaEventRecord(b);                                                                \
    printf("gather %s, %d B x %d rows a step: %.2f TB/s\n", NAME, SEG, ROWS,            \
           (double)SEG * ROWS * steps * blocks / elapsed(a, b) / 1e9);                 \
  }
  GATHER(false, 64, 128, "cp.async 16 B")
  GATHER(false, 256, 32, "cp.async 16 B")
  GATHER(false, 512, 32, "cp.async 16 B")
  GATHER(true, 64, 128, "ld.global + st.shared 16 B")
#define LOOP(MODE, NROWS, NAME)                                                          \
  {                                                                                      \
    const int iters = 2048, blocks = sms * 2, smem = 6 * (128 * 32 + 32 * 64) * 2;       \
    cudaFuncSetAttribute(k1_loop<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                         smem);                                                          \
    k1_loop<MODE><<<blocks, 256, smem>>>((const __nv_bfloat16*)src, NROWS, out, 8);      \
    cudaEventRecord(a);                                                                  \
    k1_loop<MODE><<<blocks, 256, smem>>>((const __nv_bfloat16*)src, NROWS, out, iters);  \
    cudaEventRecord(b);                                                                  \
    const float ms = elapsed(a, b);                                                      \
    printf("K1-shaped loop, %s: %.1f TFLOP/s, %.2f TB/s gathered\n", NAME,               \
           2.0 * 128 * 64 * 32 * iters * blocks / ms / 1e9,                              \
           MODE == 2 ? 12288.0 * iters * blocks / ms / 1e9 : 0.0);                       \
  }
  LOOP(0, 4000, "compute alone")
  LOOP(1, 4000, "pipeline without copies")
  LOOP(2, 4000, "pipeline, copies from 2.3 MB")
  LOOP(2, 200000, "pipeline, copies from 115 MB")
  {
    const int steps = 200000;
    lsa_chain<7><<<1, 32>>>(out, 100);
    cudaEventRecord(a);
    lsa_chain<7><<<1, 32>>>(out, steps);
    cudaEventRecord(b);
    printf("assignment relax step, one warp, 7 columns a lane, as a dependent chain: %.1f ns a "
           "step\n", elapsed(a, b) * 1e6 / steps);
  }
  const cudaError_t e = cudaDeviceSynchronize();
  printf("status: %s\n", cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("hopper_calibration: needs the CUDA card", file=sys.stderr)
        return 1
    out_dir = _build.BUILD_DIR.parent / "calibration"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, exe = out_dir / "calibration.cu", out_dir / "calibration"
    src.write_text(SOURCE)
    cmd = [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", f"-I{_build.CSRC}",
           "-o", str(exe), str(src)]
    build = subprocess.run(cmd, capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return build.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {torch.cuda.get_device_name(0)} | {smi.stdout.strip()}")
    run = subprocess.run([str(exe)], env=dict(os.environ), text=True)
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
