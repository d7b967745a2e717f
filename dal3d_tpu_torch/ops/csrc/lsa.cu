// Linear sum assignment (Jonker-Volgenant shortest augmenting path) for
// TransFusion's Hungarian matching, for Hopper (sm_90a).
//
//   col4row[b, g] = the column given to row g of cost[b] [G, P] (G <= P) at
//                   the least total cost
//
// There is no Pallas kernel to replace: the JAX package solves it with a
// lax.while_loop program (dal3d_tpu/ops/lsa.py::linear_sum_assignment, vmapped
// over the batch), whose every augmenting step is a vectorised O(P) relax
// and argmin. In plain PyTorch on the card each step's data-dependent loop
// condition is a host sync: some 13k of them a train step at G = P = 200.
//
// Bound on the card: neither bytes (G * P * 4 bytes of cost) nor operations
// (about 8 per column a step) but the chain of dependent steps: each step's
// row is known only after the previous step's argmin. So the time is steps x
// the latency of one step. The first version (one block of 256 threads, a
// column a thread) paid four block barriers and a cost row from global
// memory on that chain: 0.54 us a step.
//
// Design:
//   - one warp solves one problem; the block's other warps only help copy
//     the problem's cost into shared memory once, at the start, in a layout
//     where lane l's columns sit at 32 r + l of the row (conflict-free);
//     no relax step touches global memory;
//   - lane l owns the contiguous run of R = ceil((P + 1) / 32) columns
//     l R .. l R + R - 1 (column 0 is the virtual source) and keeps their
//     v, minv, way and used in registers, and the u of each used column's
//     row (a row's u changes only while its column is used; it goes back to
//     shared memory when the row's search ends); u and p, indexed by row,
//     stay in shared memory;
//   - the step is branch-free: the lane's R cost values are loaded at once,
//     and the relax, mask and update are selects. A first draft with a
//     divergent branch per column (and u updated in shared memory) ran
//     slower than the block version it replaced; the chain of selects is
//     what tools/hopper_calibration.py times as a relax step's floor;
//   - the argmin: each lane's first least over its run, then redux.sync.min
//     on an order-preserving uint32 key of the value (-0 keyed as +0) and a
//     ballot of the lanes that hold it; the least such lane holds the least
//     index, because the runs ascend with the lane: the plain version's tie
//     rule, the first least. The step's delta is the winner's value itself;
//   - no block barrier in the loop, only __syncwarp; the augmenting walk
//     runs on one lane over way[] written to shared memory once per row;
//   - a cost that does not fit shared memory (about 227 KB with u and p) is
//     read row by row from global memory by the same loop.
//
// The arithmetic is JAX's, in the same order, so that the kernel, the plain
// version (ops/lsa.py) and JAX give the same col4row: cur = (cost - u[i0]) -
// v[j] with column 0 at BIG, updates where cur < minv (strict), the argmin
// the first index of the least masked minv, then u[p[j]] += delta and
// v[j] -= delta on used columns and minv[j] -= delta on the others; each
// row's search stops at a free column or after i + 2 steps; the augmenting
// walk goes back along way[] to column 0. Built with -fmad=false: there is
// no product to contract, and none may appear.

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // the copy of the cost; warp 0 solves
constexpr float BIG = 1e30f;
constexpr int SMEM_MAX = 232448;

// x < y <=> key(x) < key(y) for numbers; -0 and +0 get one key
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__host__ __device__ constexpr size_t lsa_smem(int G, int P, int R, bool cost_in_smem) {
  return (size_t)(G + 1) * 4 + (size_t)(P + 1) * 8 + (cost_in_smem ? (size_t)G * 32 * R * 4 : 0);
}

template <int R, bool SMEM_COST>
__global__ void __launch_bounds__(THREADS)
lsa_kernel(const float* __restrict__ cost, int* __restrict__ col4row, int G, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem);        // [G + 1]
  int* p = reinterpret_cast<int*>(u + (G + 1));     // [P + 1]: 1-indexed row of column j
  int* wayx = p + (P + 1);                          // [P + 1]: way[] for the augmenting walk
  float* cs = reinterpret_cast<float*>(wayx + (P + 1));  // [G][R][32] (SMEM_COST)

  const int tid = threadIdx.x;
  const float* c = cost + (size_t)blockIdx.x * G * P;
  for (int e = tid; e <= G; e += THREADS) u[e] = 0.0f;
  for (int e = tid; e <= P; e += THREADS) p[e] = 0;
  if constexpr (SMEM_COST) {
    for (int e = tid; e < G * P; e += THREADS) {
      const int i = e / P, j = e - i * P + 1;  // column j of row i: lane j / R, slot j % R
      cs[(i * R + j % R) * 32 + j / R] = c[e];
    }
  }
  __syncthreads();
  if (tid >= 32) return;
  const int lane = tid, jl = lane * R;  // this lane's first column

  // per column of the lane: v; minv, way and used for the row being
  // inserted; uc, the u of the column's row while the column is used (the
  // rows of used columns are distinct; u of a row changes only while its
  // column is used, and is written back when the row's search ends)
  float v[R], minv[R], uc[R];
  int way[R];
  unsigned valid = 0;  // bit r: column jl + r exists
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = uc[r] = 0.0f;
    valid |= (jl + r <= P ? 1u : 0u) << r;
  }

#pragma unroll 1
  for (int i = 0; i < G; ++i) {
    unsigned used = 0;  // bit r: column jl + r
#pragma unroll
    for (int r = 0; r < R; ++r) {
      minv[r] = BIG;
      way[r] = 0;
    }
    if (lane == 0) p[0] = i + 1;
    __syncwarp();
    // branch-free relax steps (selects, not divergent branches): column 0
    // is used from the first step on, so its cost is never read for real
    int j0 = 0, i0 = i + 1;
    float ui0 = u[i0];
#pragma unroll 1
    for (int it = 0; i0 != 0 && it <= i + 1; ++it) {
      float cv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (SMEM_COST) {
          cv[r] = cs[((i0 - 1) * R + r) * 32 + lane];
        } else {
          const int j = min(max(jl + r, 1), P);
          cv[r] = c[(size_t)(i0 - 1) * P + j - 1];
        }
      }
      // the lane's first least masked minv (its columns ascend), and whether
      // that column is used (only when every masked value is BIG), with its u
      float best = __int_as_float(0x7f800000);  // +inf: only a missing column is above BIG
      float bu = 0.0f;
      int br = 0, bused = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool now = j0 == jl + r;  // the column this step marks used
        uc[r] = now ? ui0 : uc[r];
        used |= (now ? 1u : 0u) << r;
        const bool fr = !((used >> r) & 1u);
        const float cur = __fsub_rn(__fsub_rn(cv[r], ui0), v[r]);
        const bool upd = fr && cur < minv[r];
        minv[r] = upd ? cur : minv[r];
        way[r] = upd ? j0 : way[r];
        const float masked = fr ? minv[r] : BIG;
        const bool take = ((valid >> r) & 1u) && masked < best;
        best = take ? masked : best;
        br = take ? r : br;
        bused = take ? !fr : bused;
        bu = take ? uc[r] : bu;
      }
      const unsigned key = order_key(best);
      const unsigned least = __reduce_min_sync(0xffffffffu, key);
      const int win = __ffs(__ballot_sync(0xffffffffu, key == least)) - 1;
      const int j1 = __shfl_sync(0xffffffffu, jl + br, win);
      const float delta = __shfl_sync(0xffffffffu, best, win);
      const int wused = __shfl_sync(0xffffffffu, bused, win);
      const float wu = __shfl_sync(0xffffffffu, bu, win);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool ur = (used >> r) & 1u;
        uc[r] = ur ? __fadd_rn(uc[r], delta) : uc[r];
        v[r] = ur ? __fsub_rn(v[r], delta) : v[r];
        minv[r] = ur ? minv[r] : __fsub_rn(minv[r], delta);
      }
      j0 = j1;
      i0 = p[j0];
      // a row first visited now: its u in shared memory is current; a used
      // column's row (all masked values BIG): its u in the winner's register
      ui0 = wused ? __fadd_rn(wu, delta) : u[i0];
    }
    // the visited rows' u back to shared memory, then augment: walk the
    // predecessor columns back to the source
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((used >> r) & 1u) u[p[jl + r]] = uc[r];
      if ((valid >> r) & 1u) wayx[jl + r] = way[r];
    }
    __syncwarp();
    if (lane == 0) {
      while (j0 != 0) {
        const int j1 = wayx[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncwarp();
  }
  int* out = col4row + (size_t)blockIdx.x * G;
  for (int g = lane; g < G; g += 32) out[g] = 0;
  __syncwarp();
  for (int j = lane + 1; j <= P; j += 32)
    if (p[j] > 0) out[p[j] - 1] = j - 1;
}

template <int R>
int launch_lsa(const float* cost, int* col4row, int B, int G, int P, cudaStream_t stream) {
  const bool in_smem = lsa_smem(G, P, R, true) <= (size_t)SMEM_MAX;
  const size_t smem = lsa_smem(G, P, R, in_smem);
  auto kernel = in_smem ? lsa_kernel<R, true> : lsa_kernel<R, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, THREADS, smem, stream>>>(cost, col4row, G, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cost [B, G, P] f32 contiguous with G <= P < 1024, col4row [B, G] int32;
// one block (one solving warp) per batch element.
extern "C" int lsa_f32(const void* cost, void* col4row, int B, int G, int P, void* stream) {
  if (B == 0 || G == 0) return 0;
  if (G > P || P >= 1024) return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(cost);
  int* out = static_cast<int*>(col4row);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = (P + 1 + 31) / 32;  // columns a lane: run lengths above 8 rounded up
  switch (R) {
    case 1: return launch_lsa<1>(c, out, B, G, P, s);
    case 2: return launch_lsa<2>(c, out, B, G, P, s);
    case 3: return launch_lsa<3>(c, out, B, G, P, s);
    case 4: return launch_lsa<4>(c, out, B, G, P, s);
    case 5: return launch_lsa<5>(c, out, B, G, P, s);
    case 6: return launch_lsa<6>(c, out, B, G, P, s);
    case 7: return launch_lsa<7>(c, out, B, G, P, s);
    case 8: return launch_lsa<8>(c, out, B, G, P, s);
    default:
      if (R <= 12) return launch_lsa<12>(c, out, B, G, P, s);
      if (R <= 16) return launch_lsa<16>(c, out, B, G, P, s);
      if (R <= 24) return launch_lsa<24>(c, out, B, G, P, s);
      return launch_lsa<32>(c, out, B, G, P, s);
  }
}
