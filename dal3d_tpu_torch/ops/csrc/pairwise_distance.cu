// Pairwise L1 / L2 distance matrices of frame embeddings, for Hopper (sm_90a).
//
//   L1: out[i, j] = sum_c |x[i, c] - y[j, c]|
//   L2: out[i, j] = sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0))   (or squared)
//
// x [N, C], y [M, C] f32 row-major, out [N, M] f32.
//
// Replaces the TPU kernels dal3d_tpu/ops/pallas_distance.py::_l1_kernel
// (launched by pairwise_l1_pallas) and, for N <= 8, ::_l2_kernel
// (pairwise_l2_pallas); the L2 matrix for N > 8 is the 3xTF32 tensor-core
// kernel of pairwise_l2_tf32.cu. They compute the function, not the TPU's
// blocks: N and M need no padding to 256 and C none to 128; ragged edges are
// masked here.
//
// Two kernels, chosen by N:
//  - L1 tile kernel (N > ROW_MAX_N): one block per 128 x 64 output tile, 256
//    threads, an 8 x 4 register micro-tile per thread. x and y tiles of a
//    16-wide slice of C are staged transposed in shared memory (the next
//    slice is prefetched into registers while the current one is used), so
//    per slice a thread reads 2 float4 of x (broadcast) and 4 floats of y
//    for 32 accumulator updates. A thread's 4 columns are 16 apart, so a
//    half-warp stores 16 consecutive floats of an output row.
//  - row kernel, L1 and L2 (N <= ROW_MAX_N, the streaming k-center's
//    [1, C] x [M, C]): one warp per output element (i, j), lanes stride over
//    C with float4 loads where C % 4 == 0 and both bases are 16-byte
//    aligned, a shuffle reduction at the end. A 128-row tile would waste
//    127/128 of its work here.
//
// Bound on the card. L1 tile launch at N = M = 28130, C = 512: 4.05e11
// element steps of 3 f32 operations (subtract, abs, add) against the 67
// TFLOP/s f32 peak outside the tensor cores: 18.1 ms; the 3.17 GB output
// takes 0.95 ms at 3.35 TB/s, so operations bound it. Row launch (N = 1): y
// is read once, 57.6 MB, 0.017 ms: bytes bound it.

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int TM = 128;      // tile rows (i)
constexpr int TN = 64;       // tile columns (j)
constexpr int CK = 16;       // slice of C staged per step
constexpr int THREADS = 256; // 16 x 16
constexpr int LDX = TM + 4;  // padded leading dimensions (floats), 16-byte rows
constexpr int LDY = TN + 4;
constexpr int ROW_MAX_N = 8; // at most this many x rows go to the row kernel
constexpr int ROW_WARPS = 8; // warps (output elements) per block of the row kernel

enum Metric { kL1 = 0, kL2 = 1 };

// Loads 4 consecutive floats of row `r` (of `rows`) starting at column k of a
// [rows, C] matrix; zero beyond either edge. vec4: C % 4 == 0 and a 16-byte
// aligned base, so the address is 16-byte aligned and k + 3 < C whenever k < C.
__device__ __forceinline__ float4 load4(const float* __restrict__ a, int r, int rows, int k, int C,
                                        bool vec4) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= rows) return v;
  const float* p = a + (size_t)r * C + k;
  if (vec4) {
    if (k < C) v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (k + 0 < C) v.x = __ldg(p + 0);
    if (k + 1 < C) v.y = __ldg(p + 1);
    if (k + 2 < C) v.z = __ldg(p + 2);
    if (k + 3 < C) v.w = __ldg(p + 3);
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
l1_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ out, int N, int M, int C, bool vec4) {
  __shared__ __align__(16) float xs[CK][LDX];
  __shared__ __align__(16) float ys[CK][LDY];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;

  // staging roles: 4 consecutive lanes cover 16 consecutive floats of a row
  const int lk = (tid & 3) * 4;   // column offset inside the slice
  const int lr = tid >> 2;        // 0..63: x rows lr and lr + 64, y row lr

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  float4 px0 = load4(x, i0 + lr, N, lk, C, vec4);
  float4 px1 = load4(x, i0 + lr + 64, N, lk, C, vec4);
  float4 py = load4(y, j0 + lr, M, lk, C, vec4);

  for (int k0 = 0; k0 < C; k0 += CK) {
    xs[lk + 0][lr] = px0.x; xs[lk + 1][lr] = px0.y; xs[lk + 2][lr] = px0.z; xs[lk + 3][lr] = px0.w;
    xs[lk + 0][lr + 64] = px1.x; xs[lk + 1][lr + 64] = px1.y;
    xs[lk + 2][lr + 64] = px1.z; xs[lk + 3][lr + 64] = px1.w;
    ys[lk + 0][lr] = py.x; ys[lk + 1][lr] = py.y; ys[lk + 2][lr] = py.z; ys[lk + 3][lr] = py.w;
    __syncthreads();
    if (k0 + CK < C) {  // prefetch the next slice while this one is used
      px0 = load4(x, i0 + lr, N, k0 + CK + lk, C, vec4);
      px1 = load4(x, i0 + lr + 64, N, k0 + CK + lk, C, vec4);
      py = load4(y, j0 + lr, M, k0 + CK + lk, C, vec4);
    }
#pragma unroll
    for (int k = 0; k < CK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][ty * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ys[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += fabsf(a[r] - b[c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + ty * 8 + r;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= M) continue;
      out[(size_t)i * M + j] = acc[r][c];
    }
  }
}

template <int METRIC>
__global__ void __launch_bounds__(ROW_WARPS * 32)
pairwise_row_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ out, int N, int M, int C, int squared, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int i = blockIdx.y;
  if (j >= M) return;  // whole warps leave together
  const float* xi = x + (size_t)i * C;
  const float* yj = y + (size_t)j * C;
  float s = 0.f, sx = 0.f, sy = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xi);
    const float4* y4 = reinterpret_cast<const float4*>(yj);
    for (int k = lane; k < (C >> 2); k += 32) {
      const float4 a = __ldg(x4 + k), b = __ldg(y4 + k);
      if (METRIC == kL1) {
        s += fabsf(a.x - b.x) + fabsf(a.y - b.y) + fabsf(a.z - b.z) + fabsf(a.w - b.w);
      } else {
        s = fmaf(a.x, b.x, s); s = fmaf(a.y, b.y, s); s = fmaf(a.z, b.z, s); s = fmaf(a.w, b.w, s);
        sx = fmaf(a.x, a.x, sx); sx = fmaf(a.y, a.y, sx); sx = fmaf(a.z, a.z, sx); sx = fmaf(a.w, a.w, sx);
        sy = fmaf(b.x, b.x, sy); sy = fmaf(b.y, b.y, sy); sy = fmaf(b.z, b.z, sy); sy = fmaf(b.w, b.w, sy);
      }
    }
  } else {
    for (int k = lane; k < C; k += 32) {
      const float a = __ldg(xi + k), b = __ldg(yj + k);
      if (METRIC == kL1) {
        s += fabsf(a - b);
      } else {
        s = fmaf(a, b, s);
        sx = fmaf(a, a, sx);
        sy = fmaf(b, b, sy);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    if (METRIC == kL2) {
      sx += __shfl_xor_sync(0xffffffffu, sx, o);
      sy += __shfl_xor_sync(0xffffffffu, sy, o);
    }
  }
  if (lane == 0) {
    float v = s;
    if (METRIC == kL2) {
      v = fmaxf(sx + sy - 2.0f * s, 0.0f);
      if (!squared) v = sqrtf(v);
    }
    out[(size_t)i * M + j] = v;
  }
}

template <int METRIC>
int launch(const void* x, const void* y, void* out, int N, int M, int C, int squared,
           void* stream) {
  if (N <= 0 || M <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // float4 loads where every row starts on a 16-byte boundary
  const bool vec4 = (C & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  if (N <= ROW_MAX_N) {
    dim3 grid((M + ROW_WARPS - 1) / ROW_WARPS, N);
    pairwise_row_kernel<METRIC><<<grid, ROW_WARPS * 32, 0, st>>>(xf, yf, of, N, M, C, squared,
                                                                 vec4);
  } else if (METRIC == kL1) {
    dim3 grid((M + TN - 1) / TN, (N + TM - 1) / TM);
    l1_tile_kernel<<<grid, THREADS, 0, st>>>(xf, yf, of, N, M, C, vec4);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // L2 matrices: pairwise_l2_tf32.cu
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pairwise_l1_f32(const void* x, const void* y, void* out, int N, int M, int C,
                               void* stream) {
  return launch<kL1>(x, y, out, N, M, C, 0, stream);
}

extern "C" int pairwise_l2_f32(const void* x, const void* y, void* out, int N, int M, int C,
                               int squared, void* stream) {
  return launch<kL2>(x, y, out, N, M, C, squared, stream);
}
