// Rotated BEV IoU matrix for the batched NMS, for Hopper (sm_90a).
//
//   out[g, i, j] = IoU(box i of rows[g], box j of cols[g])
//
// rows [G, N, 32] and cols [G, M, 32] are the per-box records of
// ops/iou_matrix.py::_pack_rowdat (corners, edge vectors, inward clip
// planes, area; 29 floats used); out [G, N, M] f32.
//
// Replaces the TPU kernel dal3d_tpu/ops/pallas_iou.py::_iou_kernel (launched
// by _iou_pallas), with the same arithmetic: a Cyrus-Beck clip of the edges
// of box i against the planes of box j and the reverse, summed by Green's
// theorem; eps 1e-4; an edge lying on a plane weighs 0.5; an edge outside a
// parallel plane is dropped; the intersection is clamped to the smaller area.
// Padded (zero) boxes give IoU 0.
//
// Design: one thread per (i, j) pair in 32 x 8 blocks (32 j along the warp,
// so the stores coalesce). The block stages its 8 row records and 32 column
// records in shared memory; each thread runs both clip directions in
// registers. Everything stays f32 with IEEE division, and this file is built
// with -fmad=false: the eps branches (par, on_b, killed) must see the same
// rounding as the plain version, which contracts nothing.
//
// Bound on the card: about 530 f32 operations per pair (2 directions x 4
// edges x 4 planes of ~12 operations, plus the per-edge clip and cross
// terms), G*N*M pairs against the 67 TFLOP/s f32 peak outside the tensor
// cores; at G=12, N=M=1000 that is 6.4e9 operations, 0.095 ms. The output
// (48 MB) takes 0.014 ms at 3.35 TB/s, so operations bound it.

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int TJ = 32;   // columns (j) per block, one warp wide
constexpr int TI = 8;    // rows (i) per block
constexpr int REC = 32;  // floats per record
constexpr float kEps = 1e-4f;

// One clip direction: edges of E (lanes 0-15: p0x, p0y, dx, dy per edge)
// against the planes of P (lanes 16-27: nx, ny, an per plane). Returns the
// Green's boundary sum over E's edges of weight * cross(u, v).
__device__ __forceinline__ float clip_dir(const float* E, const float* P) {
  float contrib = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p0x = E[e], p0y = E[4 + e], dx = E[8 + e], dy = E[12 + e];
    float t_lo = 0.0f, t_hi = 1.0f;
    bool on_b = false, killed = false;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float nx = P[16 + p], ny = P[20 + p], an = P[24 + p];
      const float num = p0x * nx + p0y * ny - an;
      const float den = dx * nx + dy * ny;
      const bool par = fabsf(den) < kEps;
      const float t_at = -num / (par ? 1.0f : den);
      const bool entry = den > 0.0f;
      t_lo = fmaxf(t_lo, (entry && !par) ? t_at : 0.0f);
      t_hi = fminf(t_hi, (!entry && !par) ? t_at : 1.0f);
      on_b = on_b || (par && fabsf(num) <= kEps);
      killed = killed || (par && num < -kEps);
    }
    const float weight = on_b ? 0.5f : 1.0f;
    t_lo = fminf(fmaxf(t_lo, 0.0f), 1.0f);
    t_hi = fminf(fmaxf(t_hi, 0.0f), 1.0f);
    const bool ok = (t_hi > t_lo) && !killed;
    const float ux = p0x + t_lo * dx;
    const float uy = p0y + t_lo * dy;
    const float vx = p0x + t_hi * dx;
    const float vy = p0y + t_hi * dy;
    const float cr = ux * vy - vx * uy;
    contrib = contrib + (ok ? cr : 0.0f) * weight;
  }
  return contrib;
}

__global__ void __launch_bounds__(TJ * TI)
iou_matrix_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
                  float* __restrict__ out, int N, int M) {
  __shared__ float rs[TI][REC + 1];
  __shared__ float cs[TJ][REC + 1];
  const int g = blockIdx.z;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  const int tid = threadIdx.y * TJ + threadIdx.x;
  const float* rg = rows + (size_t)g * N * REC;
  const float* cg = cols + (size_t)g * M * REC;
  for (int e = tid; e < TI * REC; e += TI * TJ) {
    const int r = e / REC, k = e % REC;
    rs[r][k] = (i0 + r < N) ? rg[(size_t)(i0 + r) * REC + k] : 0.0f;
  }
  for (int e = tid; e < TJ * REC; e += TI * TJ) {
    const int r = e / REC, k = e % REC;
    cs[r][k] = (j0 + r < M) ? cg[(size_t)(j0 + r) * REC + k] : 0.0f;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= N || j >= M) return;
  const float* ri = rs[threadIdx.y];
  const float* cj = cs[threadIdx.x];
  const float t1 = clip_dir(ri, cj);  // edges of i clipped to the planes of j
  const float t2 = clip_dir(cj, ri);  // edges of j clipped to the planes of i
  float inter = 0.5f * fabsf(t1 + t2);
  const float ai = ri[28], aj = cj[28];
  inter = fminf(inter, fminf(ai, aj));
  const float uni = ai + aj - inter;
  out[((size_t)g * N + i) * M + j] = uni > 0.0f ? inter / uni : 0.0f;
}

}  // namespace

extern "C" int iou_matrix_f32(const void* rows, const void* cols, void* out, int G, int N, int M,
                              void* stream) {
  if (G == 0 || N == 0 || M == 0) return 0;
  dim3 grid((M + TJ - 1) / TJ, (N + TI - 1) / TI, G);
  dim3 block(TJ, TI);
  iou_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(cols), static_cast<float*>(out),
      N, M);
  return static_cast<int>(cudaGetLastError());
}
