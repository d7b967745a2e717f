// Pairwise L2 distance matrix of frame embeddings on the tensor cores, for
// Hopper (sm_90a), in 3xTF32.
//
//   out[i, j] = sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0))   (or squared)
//
// x [N, C], y [M, C] f32 (any strides), out [N, M] f32, N > 8 (the
// streaming k-center's rows, N <= 8, go to the row kernel of
// pairwise_distance.cu).
//
// Replaces the TPU kernel dal3d_tpu/ops/pallas_distance.py::_l2_kernel
// (launched by pairwise_l2_pallas), which takes x . y on the MXU with
// dot_general and the norms from the same blocks. Here the product is a GEMM
// with both operands K-major, which is how x and y are stored and the only
// layout TF32 wgmma takes.
//
// Bound on the card. At the selection's band, [4096, 512] x [28130, 512]:
// 5.9e10 multiply-adds. On the f32 FMA units (2 operations each at 67
// TFLOP/s) that is 1.761 ms, the floor of the tile kernel this one replaces;
// as three TF32 products (3 x 2 operations each at 495 TFLOP/s) 0.715 ms.
// The bytes (inputs once, the 461 MB output) take 0.157 ms, so operations
// bound it; for the whole [28130]^2 map 4.91 ms against 0.95 ms of bytes.
//
// Design:
//   - a pre-pass (l2_split_kernel, one warp per row) reads x and y through
//     their strides and writes per row the f32 squared norm and the TF32
//     planes big = rna(v) and small = rna(v - big) (ties away from zero;
//     big by two integer operations that give cvt.rna's bits), with C
//     zero-padded to Cp, a multiple of the 32-float k tile. Zero columns add
//     exact zeros. When x is y the wrapper splits it once.
//   - the main kernel: one block per 128 x 128 output tile, blocks in
//     groups of 16 row tiles walked column by column, so that the x and y
//     tiles in flight stay in the 50 MB L2 (y is read from memory about once
//     per group). One producer warp issues TMA loads of the four 128 x 32
//     tiles of a k step (x big, x small, y big, y small; 64 KB) into a ring
//     of 3 stages, 128-byte swizzled, each guarded by a full and an empty
//     mbarrier. Two consumer warpgroups (64 rows each) run
//     wgmma.m64n128k8.f32.tf32.tf32 on the landed stage: small*big, then
//     big*small, then big*big (the small terms first, while the sum is
//     small), twelve instructions, into a fresh accumulator (scale-d 0 on
//     the first). The tensor cores' own f32 sum truncates (a chain of ~1300
//     products through one accumulator drifted 1.9e-5 of scale in the
//     fused gather-GEMM), so the chunk is one k step of 32 and each chunk's
//     accumulator is added to the f32 sums with round-to-nearest adds:
//     tests/test_torch_distance_tf32.py emulates this sum and holds it
//     to the tolerances; chunks of 8 or 16 gave no smaller error there.
//   - the epilogue stages the dot products in the (drained) ring, then
//     each consumer warp writes whole 128-float row pieces of the output,
//     max(xx + yy - 2 dot, 0) and sqrt unless squared: coalesced stores (M
//     is odd at the band, so the rows are not 16-byte aligned for a TMA
//     store).
// Sums run in a fixed order, so repeated calls give the same bits.

#include "common.cuh"

#include <stdint.h>

namespace {

using namespace dal3d;

constexpr int BM = 128, BN = 128, BK = 32;  // output tile, k step (floats) = one chunk
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 32;     // and one producer warp
constexpr int GROUP = 16;                   // row tiles walked together
constexpr int TILE_BYTES = 128 * BK * 4;    // one 128 x 32 f32 tile
constexpr int STAGE_BYTES = 4 * TILE_BYTES;
constexpr int LDO = BN + 4;                 // epilogue staging pitch (floats)
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(BM * LDO * 4 <= STAGES * STAGE_BYTES, "epilogue staging fits the ring");
constexpr int SPLIT_WARPS = 8;

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__global__ void __launch_bounds__(SPLIT_WARPS * 32)
l2_split_kernel(const float* __restrict__ x, int rows, int C, long long sr, long long sc, int Cp,
                float* __restrict__ norm, uint32_t* __restrict__ big, uint32_t* __restrict__ small) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * SPLIT_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float* xr = x + r * sr;
  uint32_t* br = big + (size_t)r * Cp;
  uint32_t* sm = small + (size_t)r * Cp;
  float s = 0.0f;
  for (int c = lane; c < Cp; c += 32) {
    const float v = c < C ? __ldg(xr + c * sc) : 0.0f;
    const uint32_t b = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
    br[c] = b;
    sm[c] = tf32_rna(v - __uint_as_float(b));
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) norm[r] = s;
}

__global__ void __launch_bounds__(THREADS, 1)
l2_tf32_kernel(const __grid_constant__ CUtensorMap mxb, const __grid_constant__ CUtensorMap mxs,
               const __grid_constant__ CUtensorMap myb, const __grid_constant__ CUtensorMap mys,
               const float* __restrict__ xn, const float* __restrict__ yn,
               float* __restrict__ out, int N, int M, int KT, int squared) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // grouped raster: GROUP row tiles, column by column
  const int nrow = (N + BM - 1) / BM, ncol = (M + BN - 1) / BN;
  const int per_group = GROUP * ncol;
  const int first = (blockIdx.x / per_group) * GROUP;
  const int gsize = min(GROUP, nrow - first);
  const int local = blockIdx.x - first * ncol;
  const int i0 = (first + local % gsize) * BM, j0 = (local / gsize) * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == CONSUMERS / 32) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        unsigned char* st = smem + s * STAGE_BYTES;
        tma_load_2d(st, &mxb, &full[s], kt * BK, i0);
        tma_load_2d(st + TILE_BYTES, &mxs, &full[s], kt * BK, i0);
        tma_load_2d(st + 2 * TILE_BYTES, &myb, &full[s], kt * BK, j0);
        tma_load_2d(st + 3 * TILE_BYTES, &mys, &full[s], kt * BK, j0);
      }
    }
    return;
  }

  const int wg = warp >> 2;  // rows 64 wg ..
  float acc[64], part[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = part[q] = 0.0f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* st = smem + s * STAGE_BYTES;
    const uint64_t ab = wgmma_desc_sw128(st + wg * 64 * 128);
    const uint64_t as = wgmma_desc_sw128(st + TILE_BYTES + wg * 64 * 128);
    const uint64_t bb = wgmma_desc_sw128(st + 2 * TILE_BYTES);
    const uint64_t bs = wgmma_desc_sw128(st + 3 * TILE_BYTES);
    wgmma_fence_operands(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) wgmma_m64n128k8_tf32(part, as + 2 * kk, bb + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) wgmma_m64n128k8_tf32(part, ab + 2 * kk, bs + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) wgmma_m64n128k8_tf32(part, ab + 2 * kk, bb + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(part);
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] = __fadd_rn(acc[q], part[q]);
  }

  // epilogue: both warpgroups are done with the ring; stage the dots there
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  float* so = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x & 127;
  const int row = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * (t & 3);
    *reinterpret_cast<float2*>(&so[row * LDO + col]) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(&so[(row + 8) * LDO + col]) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  for (int r = warp; r < BM; r += CONSUMERS / 32) {
    const int i = i0 + r;
    if (i >= N) break;
    const float xi = __ldg(xn + i);
    float* orow = out + (size_t)i * M;
#pragma unroll
    for (int c = lane; c < BN; c += 32) {
      const int j = j0 + c;
      if (j < M) {
        float v = fmaxf(xi + __ldg(yn + j) - 2.0f * so[r * LDO + c], 0.0f);
        if (!squared) v = sqrtf(v);
        orow[j] = v;
      }
    }
  }
}

}  // namespace

// norm [rows], big / small [rows, Cp] (TF32 bit patterns) of x [rows, C]
// with element strides (sr, sc); Cp % 32 == 0, Cp >= C
extern "C" int pairwise_l2_split_f32(const void* x, int rows, int C, long long sr, long long sc,
                                     int Cp, void* norm, void* big, void* small, void* stream) {
  if (rows <= 0) return 0;
  l2_split_kernel<<<(rows + SPLIT_WARPS - 1) / SPLIT_WARPS, SPLIT_WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, C, sr, sc, Cp, static_cast<float*>(norm),
      static_cast<uint32_t*>(big), static_cast<uint32_t*>(small));
  return static_cast<int>(cudaGetLastError());
}

// out [N, M] from the pre-pass results of x (xn, xb, xs) and y (yn, yb, ys)
extern "C" int pairwise_l2_tf32_f32(const void* xn, const void* xb, const void* xs,
                                    const void* yn, const void* yb, const void* ys, void* out,
                                    int N, int M, int Cp, int squared, void* stream) {
  if (N <= 0 || M <= 0) return 0;
  if (Cp <= 0 || Cp % BK) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const void* planes[4] = {xb, xs, yb, ys};
  for (int m = 0; m < 4; ++m) {
    const int err = make_tma_2d(&maps[m], planes[m], m < 2 ? N : M, Cp, m < 2 ? BM : BN);
    if (err) return err;
  }
  cudaError_t e = cudaFuncSetAttribute(l2_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = ((N + BM - 1) / BM) * ((M + BN - 1) / BN);
  l2_tf32_kernel<<<blocks, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(xn),
      static_cast<const float*>(yn), static_cast<float*>(out), N, M, Cp / BK, squared);
  return static_cast<int>(cudaGetLastError());
}
