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
// Padded (zero) boxes give IoU 0. Everything stays f32 with IEEE division,
// and this file is built with -fmad=false: the eps branches (par, on_b,
// killed) must see the same rounding as the plain version, which contracts
// nothing. Every pair the kernel computes is bit-equal to iou_matrix_plain.
//
// Bound on the card. The clip is about 536 f32 operations a pair (2
// directions x 4 edges x 4 planes of ~12 operations, plus the per-edge clip
// and cross terms): for all 12 M pairs of [12, 1000, 1000] 0.096 ms at 67
// TFLOP/s, against 0.015 ms for the 48 MB output and 3 MB of records. But
// among 1000 NMS candidates over a +-54 m scene most pairs lie far apart,
// and for them the plain version gives exactly +0.0 (every edge of one box
// is clipped away by a plane of the other). So the work the inputs need is
// the cull of every pair (about 12 operations) plus the clip of the pairs
// that survive it (about 3 % on uniform boxes), and the output's bytes bound
// the kernel.
//
// Design:
//   - the cull: while staging a record, the block derives the box's centre
//     (mean of its corners, lanes 0-7) and its reach, the circumradius about
//     that centre plus kCullRel x (|cx| + |cy| + r) for the rounding of far
//     coordinates; a record with a lane 0-28 that is not finite gets a NaN
//     reach. A pair is written +0.0 without the clip when its centres lie
//     farther apart than reach_i + reach_j + kCullMargin (the test fails on
//     NaN and on an overflowing distance), or when either area is +0.0 and
//     both reaches are finite. ops/iou_matrix.py::iou_cull_plain is the plain
//     twin of this predicate, in the same order of operations; the CPU test
//     tests/test_torch_iou_cull.py shows that the plain version is +0.0 on
//     every pair it culls (adversarial pairs at the cull distance, thin boxes,
//     parallel edges, zero records, coordinates to 1e3 m).
//   - compaction, so that the cull pays: with 3 % survivors, 62 % of warps
//     of 32 pairs would still hold one. A block stages 64 row and 128 column
//     records; each warp walks its 8 rows, 32 columns at a time: it writes
//     the culled zeros coalesced, ballots the survivors into its queue in
//     shared memory, and clips them 32 at a time (one pair a lane), each
//     value stored at its place; the rest of the queue at the end.
//   - one set against itself (the NMS passes the same records twice): the
//     result is bit-symmetric (the cull's test is; t1 + t2, the areas' min
//     and sum commute in IEEE), so a survivor with j < i is left to the
//     pair (j, i), which writes both places. This halves the clips where
//     the survivors set the pace: the predict's candidates cluster (about
//     20 % of pairs survive on the main path against 3 % on uniform boxes).

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int TI = 64;      // rows (i) of a block
constexpr int TJ = 128;     // columns (j) of a block
constexpr int WARPS = 8;    // each walks TI / WARPS rows
constexpr int REC = 32;     // floats per record
constexpr int LDR = REC + 1;
constexpr float kEps = 1e-4f;
constexpr float kCullMargin = 1e-2f;  // ops/iou_matrix.py::_CULL_MARGIN, meters
constexpr float kCullRel = 1e-5f;     // ops/iou_matrix.py::_CULL_REL
constexpr float kF32Max = 3.402823466e38f;
static_assert(TI + TJ <= WARPS * 32, "one thread derives each staged record's cull key");

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

struct Key {
  float cx, cy, reach;
  bool zero_area;
};

// centre, reach and zero-area flag of one record (iou_cull_plain's order)
__device__ __forceinline__ Key cull_key(const float* rec) {
  Key k;
  k.cx = ((rec[0] + rec[1]) + (rec[2] + rec[3])) * 0.25f;
  k.cy = ((rec[4] + rec[5]) + (rec[6] + rec[7])) * 0.25f;
  float r2 = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float ex = rec[c] - k.cx, ey = rec[4 + c] - k.cy;
    r2 = fmaxf(r2, ex * ex + ey * ey);
  }
  const float r = sqrtf(r2);
  float nonfinite = 0.0f;  // 0, or NaN if a lane is inf or NaN
#pragma unroll
  for (int c = 0; c < 29; ++c) nonfinite += rec[c] * 0.0f;
  k.reach = r + kCullRel * ((fabsf(k.cx) + fabsf(k.cy)) + r) + nonfinite;
  k.zero_area = __float_as_uint(rec[28]) == 0u;
  return k;
}

__device__ __forceinline__ bool culled(const Key& a, const Key& b) {
  const float dx = a.cx - b.cx, dy = a.cy - b.cy;
  const float d2 = dx * dx + dy * dy;
  const float s = (a.reach + b.reach) + kCullMargin;
  const bool apart = d2 > s * s && d2 <= kF32Max;
  const bool empty = (a.zero_area || b.zero_area) && (a.reach + b.reach) <= kF32Max;
  return apart || empty;
}

__device__ __forceinline__ float iou_pair(const float* ri, const float* cj) {
  const float t1 = clip_dir(ri, cj);  // edges of i clipped to the planes of j
  const float t2 = clip_dir(cj, ri);  // edges of j clipped to the planes of i
  float inter = 0.5f * fabsf(t1 + t2);
  const float ai = ri[28], aj = cj[28];
  inter = fminf(inter, fminf(ai, aj));
  const float uni = ai + aj - inter;
  return uni > 0.0f ? inter / uni : 0.0f;
}

__global__ void __launch_bounds__(WARPS * 32)
iou_matrix_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
                  float* __restrict__ out, int N, int M, bool same) {
  __shared__ float rs[TI][LDR];
  __shared__ float cs[TJ][LDR];
  __shared__ Key rk[TI];
  __shared__ Key ck[TJ];
  __shared__ int queue[WARPS][64];
  const int g = blockIdx.z;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* rg = rows + (size_t)g * N * REC;
  const float* cg = cols + (size_t)g * M * REC;
  for (int e = tid; e < TI * REC; e += WARPS * 32) {
    const int r = e / REC, k = e % REC;
    rs[r][k] = (i0 + r < N) ? rg[(size_t)(i0 + r) * REC + k] : 0.0f;
  }
  for (int e = tid; e < TJ * REC; e += WARPS * 32) {
    const int r = e / REC, k = e % REC;
    cs[r][k] = (j0 + r < M) ? cg[(size_t)(j0 + r) * REC + k] : 0.0f;
  }
  __syncthreads();
  if (tid < TJ) ck[tid] = cull_key(cs[tid]);
  else if (tid - TJ < TI) rk[tid - TJ] = cull_key(rs[tid - TJ]);
  __syncthreads();

  float* og = out + (size_t)g * N * M;
  int* q = queue[warp];
  int n = 0;  // entries in the warp's queue: (row << 8) | column of the tile
  const unsigned below = (1u << lane) - 1u;
  auto clip = [&](int e) {
    const int r = e >> 8, c = e & 255;
    const float v = iou_pair(rs[r], cs[c]);
    og[(size_t)(i0 + r) * M + j0 + c] = v;
    if (same && i0 + r != j0 + c) og[(size_t)(j0 + c) * M + i0 + r] = v;
  };
  for (int r = warp; r < TI && i0 + r < N; r += WARPS) {
    const Key a = rk[r];
    float* orow = og + (size_t)(i0 + r) * M + j0;
    for (int c0 = 0; c0 < TJ; c0 += 32) {
      const int c = c0 + lane;
      const bool valid = j0 + c < M;
      const bool cut = valid && culled(a, ck[c]);
      if (cut) orow[c] = 0.0f;
      // of one set against itself, the pairs j >= i only (j < i: the mirror)
      const unsigned keep =
          __ballot_sync(0xffffffffu, valid && !cut && (!same || j0 + c >= i0 + r));
      if (keep & (1u << lane)) q[n + __popc(keep & below)] = (r << 8) | c;
      n += __popc(keep);
      __syncwarp();
      if (n >= 32) {
        clip(q[lane]);
        const int rest = lane + 32 < n ? q[lane + 32] : 0;
        __syncwarp();
        if (lane + 32 < n) q[lane] = rest;
        n -= 32;
        __syncwarp();
      }
    }
  }
  if (lane < n) clip(q[lane]);
}

}  // namespace

// same: cols is rows (the same records; N == M)
extern "C" int iou_matrix_f32(const void* rows, const void* cols, void* out, int G, int N, int M,
                              int same, void* stream) {
  if (G == 0 || N == 0 || M == 0) return 0;
  dim3 grid((M + TJ - 1) / TJ, (N + TI - 1) / TI, G);
  iou_matrix_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(cols), static_cast<float*>(out),
      N, M, same != 0 && N == M);
  return static_cast<int>(cudaGetLastError());
}
