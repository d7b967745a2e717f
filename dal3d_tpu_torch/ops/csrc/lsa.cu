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
// condition is a host sync: some 20k of them a train step at G = P = 200.
// Here one block solves one batch element: the rows are visited in order by
// the whole block, each step's relax, update and argmin are spread over the
// threads, and u, v, p, minv, way and used stay in shared memory. The bound
// is the latency of the sequential steps (a few barriers each), not bytes or
// operations: G * P * 4 bytes of cost are read, a row per step.
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

constexpr int THREADS = 256;
constexpr float BIG = 1e30f;

__global__ void __launch_bounds__(THREADS)
lsa_kernel(const float* __restrict__ cost, int* __restrict__ col4row, int G, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem);           // [G + 1]
  float* v = u + (G + 1);                               // [P + 1]
  float* minv = v + (P + 1);                            // [P + 1]
  int* p = reinterpret_cast<int*>(minv + (P + 1));      // [P + 1]: 1-indexed row of column j
  int* way = p + (P + 1);                               // [P + 1]
  unsigned char* used = reinterpret_cast<unsigned char*>(way + (P + 1));  // [P + 1]
  __shared__ float wbest[THREADS / 32];
  __shared__ int wj[THREADS / 32];
  __shared__ int s_j1;
  __shared__ float s_delta;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* c = cost + (size_t)blockIdx.x * G * P;
  for (int j = tid; j <= G; j += THREADS) u[j] = 0.0f;
  for (int j = tid; j <= P; j += THREADS) {
    v[j] = 0.0f;
    p[j] = 0;
  }
  __syncthreads();

#pragma unroll 1
  for (int i = 0; i < G; ++i) {
    for (int j = tid; j <= P; j += THREADS) {
      minv[j] = BIG;
      way[j] = 0;
      used[j] = 0;
    }
    if (tid == 0) p[0] = i + 1;
    __syncthreads();
    int j0 = 0;
#pragma unroll 1
    for (int it = 0; p[j0] != 0 && it <= i + 1; ++it) {
      const int i0 = p[j0];
      __syncthreads();  // every thread has read p[j0] before used[] changes
      if (tid == 0) used[j0] = 1;
      __syncthreads();
      const float ui0 = u[i0];
      const float* row = c + (size_t)(i0 - 1) * P;
      float best = 0.0f;
      int bj = -1;
      for (int j = tid; j <= P; j += THREADS) {
        float m = minv[j];
        float masked = BIG;
        if (!used[j]) {
          const float cur = j == 0 ? BIG : __fsub_rn(__fsub_rn(row[j - 1], ui0), v[j]);
          if (cur < m) {
            m = cur;
            minv[j] = cur;
            way[j] = j0;
          }
          masked = m;
        }
        if (bj < 0 || masked < best) {  // a thread's columns ascend: the first least
          best = masked;
          bj = j;
        }
      }
      // block argmin: least value, then least index
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oj = __shfl_down_sync(0xffffffffu, bj, off);
        if (oj >= 0 && (bj < 0 || ob < best || (ob == best && oj < bj))) {
          best = ob;
          bj = oj;
        }
      }
      if (lane == 0) {
        wbest[warp] = best;
        wj[warp] = bj;
      }
      __syncthreads();
      if (tid == 0) {
        float b0 = wbest[0];
        int j1 = wj[0];
        for (int w = 1; w < THREADS / 32; ++w)
          if (wj[w] >= 0 && (j1 < 0 || wbest[w] < b0 || (wbest[w] == b0 && wj[w] < j1))) {
            b0 = wbest[w];
            j1 = wj[w];
          }
        s_j1 = j1;
        s_delta = b0;
      }
      __syncthreads();
      const float delta = s_delta;
      for (int j = tid; j <= P; j += THREADS) {
        if (used[j]) {
          u[p[j]] = __fadd_rn(u[p[j]], delta);  // the used columns' rows are distinct
          v[j] = __fsub_rn(v[j], delta);
        } else {
          minv[j] = __fsub_rn(minv[j], delta);
        }
      }
      j0 = s_j1;
      __syncthreads();
    }
    if (tid == 0) {  // augment: walk the predecessor columns back to the source
      while (j0 != 0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }
  int* out = col4row + (size_t)blockIdx.x * G;
  for (int g = tid; g < G; g += THREADS) out[g] = 0;
  __syncthreads();
  for (int j = tid + 1; j <= P; j += THREADS)
    if (p[j] > 0) out[p[j] - 1] = j - 1;
}

}  // namespace

// cost [B, G, P] f32 contiguous with G <= P, col4row [B, G] int32; one block
// per batch element.
extern "C" int lsa_f32(const void* cost, void* col4row, int B, int G, int P, void* stream) {
  if (B == 0 || G == 0) return 0;
  if (G > P) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)(G + 1) * 4 + (size_t)(P + 1) * (4 * 4 + 1);
  cudaError_t e = cudaFuncSetAttribute(lsa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  lsa_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<int*>(col4row), G, P);
  return static_cast<int>(cudaGetLastError());
}
