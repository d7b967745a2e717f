// Fused gather-GEMM of the gather sparse-conv engine, and a row gather, for
// Hopper (sm_90a).
//
// gather_gemm_f32:
//   out[b, m, :] = sum_{k : idx[b, k, m] >= 0} feat[b, idx[b, k, m], :] @ w[k]
// feat [B, N, Cin], idx [B, K, M] int32 (-1 = miss), w [K, Cin, Cout], out
// [B, M, Cout], all f32; products accumulate in f32 with FMAs (no TF32, as
// the f32 JAX reference has none).
//
// Replaces the TPU kernel dal3d_tpu/ops/pallas_gather.py::gather_gemm_pallas
// (inner `kernel` + `_gather_tile`). That kernel walks a (batch, row tile,
// tap) grid in order, issues one DMA per gathered row into VMEM, contracts
// the tile on the MXU and carries the sum in VMEM scratch from one tap to the
// next; misses point at an appended zero row and the channels are padded to
// 128 lanes. Here blocks run in parallel with no order, so a block loops over
// the taps itself and keeps the sum in registers; a miss is a zero-filled
// copy (it adds exactly 0), and channels are padded to 4 only (16 bytes).
//
// Bound on the card: 2 * hits * Cin * Cout operations against the 67 TFLOP/s
// f32 peak outside the tensor cores; the bytes (table, rulebook, weights,
// output; about 60 MB for an L0 conv of the BEVFusion encoder) take far less
// at 3.35 TB/s. The design keeps the FMA units fed: each thread holds a
// TM x TN register tile and reads its operands from shared memory as float4.
//
// Design (a simple, right first version; 3xTF32 / wgmma come later):
//   - one block of 256 threads per (BM output rows, COUT columns, batch),
//     COUT in {16, 32, 64, 128}: a block covers every output column of the
//     BEVFusion encoder's convs, so a gathered row is read once per tap;
//   - the block stages its [K, BM] rulebook slice in shared memory and skips
//     every tap with no hit among its rows (rows past the active set and
//     missing neighbours are common);
//   - per (active tap, BK-wide Cin chunk) it gathers the BM indexed rows and
//     the w[k] chunk into shared memory with 16-byte cp.async (zero fill for
//     misses and the Cin edge), double-buffered;
//   - BK = 8, 16 or 32 follows Cin (the stem's 5 channels are padded to 8).
//
// gather_rows: out[m] = table[idx[m]] for rows of any byte width, one warp
// per row, 16-byte copies where the row width allows. Replaces
// dal3d_tpu/ops/pallas_gather.py::gather_rows (inner `kernel`). It moves a
// few hundred KB on the path, so it is bound by the launch, not the bytes.
// An index outside [0, N) gives a zero row (never an out-of-bounds read).
//
// Alignment contract (checked by the Python wrapper): Cin % 4 == 0, Cout is
// 16, 32, 64 or a multiple of 128, pointers 16-byte aligned, contiguous.

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

// Tile geometry: TX x TY threads, each with a TM x TN register tile; the
// rows of a thread are ty, ty + TY, ... so that a warp reads neighbouring
// shared-memory rows (conflict-free with the BK + 4 row pitch).
template <int COUT, int BK>
struct Tile {
  static constexpr int TN = COUT >= 64 ? 8 : 4;
  static constexpr int TM = 4;
  static constexpr int TX = COUT / TN;
  static constexpr int TY = THREADS / TX;
  static constexpr int BM = TY * TM;
  static constexpr int A_LD = BK + 4;
  static constexpr int A_STAGE = BM * A_LD;  // floats
  static constexpr int W_STAGE = BK * COUT;  // floats
  static constexpr int TILE_BYTES = 2 * (A_STAGE + W_STAGE) * 4;
  static_assert(THREADS % TX == 0 && BK % 4 == 0 && TN % 4 == 0, "tile shape");
};

template <int COUT, int BK>
__global__ void __launch_bounds__(THREADS)
gather_gemm_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                   const float* __restrict__ w, float* __restrict__ out,
                   int N, int Cin, int K, int M, int Cout) {
  using T = Tile<COUT, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);           // [2][BM][A_LD]
  float* Ws = As + 2 * T::A_STAGE;                       // [2][BK][COUT]
  int* sidx = reinterpret_cast<int*>(smem + T::TILE_BYTES);  // [K][BM]
  int* sact = sidx + K * T::BM;                          // [K]
  __shared__ int nact;

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * COUT;
  const int tid = threadIdx.x;
  const float* fb = feat + (size_t)b * N * Cin;
  const int* ib = idx + (size_t)b * K * M;

  // the block's rulebook slice, then the taps with at least one hit
  for (int e = tid; e < K * T::BM; e += THREADS) {
    const int k = e / T::BM, r = e - k * T::BM;
    const int m = m0 + r;
    sidx[e] = m < M ? ib[(size_t)k * M + m] : -1;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int k = warp; k < K; k += THREADS / 32) {
    bool hit = false;
    for (int r = lane; r < T::BM; r += 32) hit |= sidx[k * T::BM + r] >= 0;
    hit = __any_sync(0xffffffffu, hit);
    if (lane == 0) sact[k] = hit ? 1 : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < K; ++k)
      if (sact[k]) sact[n++] = k;  // n <= k: compacting in place reads before it writes
    nact = n;
  }
  __syncthreads();

  const int nk = (Cin + BK - 1) / BK;
  const int steps = nact * nk;
  const int tx = tid % T::TX, ty = tid / T::TX;
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

  auto load_stage = [&](int s, int buf) {
    const int k = sact[s / nk];
    const int c0 = (s % nk) * BK;
    float* a = As + buf * T::A_STAGE;
    for (int e = tid; e < T::BM * (BK / 4); e += THREADS) {
      const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
      const int src = sidx[k * T::BM + r];
      const bool ok = src >= 0 && c0 + c < Cin;
      cp_async16(a + r * T::A_LD + c, ok ? fb + (size_t)src * Cin + c0 + c : fb, ok);
    }
    float* ws = Ws + buf * T::W_STAGE;
    const float* wk = w + (size_t)k * Cin * Cout + n0;
    for (int e = tid; e < BK * (COUT / 4); e += THREADS) {
      const int r = e / (COUT / 4), c = (e % (COUT / 4)) * 4;
      const bool ok = c0 + r < Cin;
      cp_async16(ws + r * COUT + c, ok ? wk + (size_t)(c0 + r) * Cout + c : w, ok);
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
    const float* a = As + buf * T::A_STAGE;
    const float* ws = Ws + buf * T::W_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float av[T::TM][4];
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(a + (ty + i * T::TY) * T::A_LD + kk);
        av[i][0] = v.x;
        av[i][1] = v.y;
        av[i][2] = v.z;
        av[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[T::TN];
#pragma unroll
        for (int j = 0; j < T::TN; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(ws + (kk + q) * COUT + tx * T::TN + j);
          bv[j] = v.x;
          bv[j + 1] = v.y;
          bv[j + 2] = v.z;
          bv[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < T::TM; ++i)
#pragma unroll
          for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(av[i][q], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* ob = out + (size_t)b * M * Cout + n0 + tx * T::TN;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + ty + i * T::TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < T::TN; j += 4)
      *reinterpret_cast<float4*>(ob + (size_t)m * Cout + j) =
          make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  }
}

template <int COUT, int BK>
int launch_gather_gemm(const float* feat, const int* idx, const float* w, float* out, int B,
                       int N, int Cin, int K, int M, int Cout, cudaStream_t stream) {
  using T = Tile<COUT, BK>;
  const size_t smem = T::TILE_BYTES + (size_t)K * T::BM * 4 + (size_t)K * 4;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gather_gemm_kernel<COUT, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((M + T::BM - 1) / T::BM, Cout / COUT, B);
  gather_gemm_kernel<COUT, BK><<<grid, THREADS, smem, stream>>>(feat, idx, w, out, N, Cin, K,
                                                                M, Cout);
  return static_cast<int>(cudaGetLastError());
}

template <int COUT>
int dispatch_bk(const float* feat, const int* idx, const float* w, float* out, int B, int N,
                int Cin, int K, int M, int Cout, cudaStream_t stream) {
  if (Cin <= 8) return launch_gather_gemm<COUT, 8>(feat, idx, w, out, B, N, Cin, K, M, Cout, stream);
  if (Cin <= 16)
    return launch_gather_gemm<COUT, 16>(feat, idx, w, out, B, N, Cin, K, M, Cout, stream);
  return launch_gather_gemm<COUT, 32>(feat, idx, w, out, B, N, Cin, K, M, Cout, stream);
}

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                                   V* __restrict__ out, int N, int M, int row_vecs) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const int src = idx[row];
  V* o = out + (size_t)row * row_vecs;
  if (src < 0 || src >= N) {
    for (int c = lane; c < row_vecs; c += 32) o[c] = V{};
    return;
  }
  const V* s = table + (size_t)src * row_vecs;
  for (int c = lane; c < row_vecs; c += 32) o[c] = s[c];
}

template <typename V>
int launch_gather_rows(const void* table, const int* idx, void* out, int N, int M,
                       long long row_bytes, cudaStream_t stream) {
  const int per_block = THREADS / 32;
  dim3 grid((M + per_block - 1) / per_block);
  gather_rows_kernel<V><<<grid, THREADS, 0, stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), N, M,
      static_cast<int>(row_bytes / sizeof(V)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_gemm_f32(const void* feat, const void* idx, const void* w, void* out,
                               int B, int N, int Cin, int K, int M, int Cout, void* stream) {
  if (B == 0 || M == 0 || Cout == 0) return 0;
  if (Cin % 4 != 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* f = static_cast<const float*>(feat);
  const int* i = static_cast<const int*>(idx);
  const float* ww = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cout) {
    case 16: return dispatch_bk<16>(f, i, ww, o, B, N, Cin, K, M, Cout, s);
    case 32: return dispatch_bk<32>(f, i, ww, o, B, N, Cin, K, M, Cout, s);
    case 64: return dispatch_bk<64>(f, i, ww, o, B, N, Cin, K, M, Cout, s);
    default:
      if (Cout % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_bk<128>(f, i, ww, o, B, N, Cin, K, M, Cout, s);
  }
}

extern "C" int gather_rows(const void* table, const void* idx, void* out, int N, int M,
                           long long row_bytes, void* stream) {
  if (M == 0 || row_bytes == 0) return 0;
  const int* i = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch_gather_rows<uint4>(table, i, out, N, M, row_bytes, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch_gather_rows<uint32_t>(table, i, out, N, M, row_bytes, s);
  if (row_bytes % 2 == 0 && align % 2 == 0)
    return launch_gather_rows<uint16_t>(table, i, out, N, M, row_bytes, s);
  return launch_gather_rows<uint8_t>(table, i, out, N, M, row_bytes, s);
}
