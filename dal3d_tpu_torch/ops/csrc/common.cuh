// Shared by the port's CUDA kernels: each .cu builds into its own shared
// library with a plain C interface (see ops/_build.py). Launch functions
// return the cudaError_t of the launch as an int; 0 is success.
//
// The device helpers below (namespace dal3d) are the building blocks of the
// banded engine's tensor-core kernels (banded_conv.cu, banded_dw.cu):
// 16-byte cp.async copies, ldmatrix loads, the bf16 mma.sync.m16n8k16 and the
// XOR swizzle of shared-memory tiles.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* dal3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace dal3d {

// 16-byte global -> shared copy; src-size 0 (valid false) zero-fills the 16
// bytes without reading gmem
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8, row
// l % 8. Without .trans lane l receives row l / 4, columns 2 (l % 4) + {0, 1}
// of each matrix; with .trans, column l / 4, rows 2 (l % 4) + {0, 1}.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of 16-byte chunk c of row r in a tile of CH chunks per row
// (CH 4: 64-byte rows; CH >= 8: rows of 128 bytes or more). The chunk index
// is XORed with bits of the row so that the 8 rows an ldmatrix matrix reads,
// at one logical chunk, land in 8 different 16-byte bank groups.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CH == 4 || (CH >= 8 && CH % 8 == 0), "swizzle: 4 or a multiple of 8 chunks");
  const int p = CH == 4 ? (c ^ ((r >> 1) & 3)) : (c ^ (r & 7));
  return (r * CH + p) * 8;  // in 2-byte elements
}

// The main loop of a kernel that streams tiles through a ring of STAGES
// shared-memory stages filled by cp.async: ready(t) says whether step t
// exists (steps are issued in order; once false, false for every later t),
// load(t, stage) issues step t's copies, compute(stage) consumes a landed
// stage. SPS steps share one commit group and one barrier; STAGES / SPS - 1
// groups are in flight while SPS stages are consumed. Called by every thread
// of the block together.
template <int STAGES, int SPS, typename Ready, typename Load, typename Compute>
__device__ __forceinline__ void cp_async_pipeline(Ready ready, Load load, Compute compute) {
  static_assert(STAGES % SPS == 0 && STAGES / SPS >= 2, "pipeline: STAGES = k * SPS, k >= 2");
  int issued = 0;
#pragma unroll 1
  for (int p = 0; p < STAGES / SPS - 1; ++p) {
#pragma unroll
    for (int u = 0; u < SPS; ++u)
      if (ready(issued)) {
        load(issued, issued % STAGES);
        ++issued;
      }
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < issued; t += SPS) {
    cp_async_wait<STAGES / SPS - 2>();  // the group of steps t.. has landed
    __syncthreads();  // ... for every thread; the stages of the previous group are free
#pragma unroll
    for (int u = 0; u < SPS; ++u)
      if (ready(issued)) {
        load(issued, issued % STAGES);
        ++issued;
      }
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < SPS; ++u)
      if (t + u < issued) compute((t + u) % STAGES);
  }
  cp_async_wait<0>();
}

}  // namespace dal3d
