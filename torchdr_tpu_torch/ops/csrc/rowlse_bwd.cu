// Backward of the row log-sum of the pairwise embedding kernel (K3) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel torchdr_tpu/ops/pallas/reduce_kernel.py
// (rowlse_bwd_pallas_general / _bwd_kernel), through its square wrapper
// rowlse_bwd_pallas. Given Z (n, d), the forward's out = lse (n,) and its
// cotangent g (n,), the TPU kernel recomputes each tile's weights
//
//   c_ij = g_i * exp(log k_ij - lse_i) * dlog k / dd^2
//        = -(g_i e^-lse_i) q_ij^2        (student, q = 1 / (1 + d^2))
//        = -g_i exp(-d^2_ij - lse_i)     (gaussian)
//
// and returns dZq_i = 2 sum_j c_ij (z_i - z_j) and dZdb_j = 2 sum_i c_ij
// (z_j - z_i), which it writes as (query tiles, n, d) partials and sums
// afterwards. For Zq = Zdb = Z the two combine into one row-wise sum,
//
//   dZ_m = 2 sum_{j != m} (c_mj + c_jm) (z_m - z_j),
//
// which is what this kernel computes, row by row, with no atomics and no
// query-tiles-times buffer: student (c_mj + c_jm) = (u_m + u_j) q_mj^2 with
// u_i = -g_i e^-lse_i; gaussian -(g_m exp(-d^2 - lse_m) + g_j exp(-d^2 -
// lse_j)), each weight formed as one exp of (-d^2 - lse), as the XLA tier
// does (ops/reduce.py), so that a row whose exp(-d^2) underflows keeps its
// weights. The j == m term is zero, so the diagonal mask of the forward
// does not enter here.
//
// Bound. Reads Z, lse and g, writes dZ: 0.24 MB at n = 10,000, d = 2. The
// term (c_mj + c_jm)(z_m - z_j) is antisymmetric, so the least work
// evaluates each of the n(n - 1)/2 unordered pairs once, adds it to row m
// and subtracts it from row j: 6d + 4 float32 operations per pair (gaussian
// one fewer), plus u_i and the factor 2 per row: 8.0e8 operations, 12 us at
// 67 TFLOP/s, so it is bound by operations. This kernel evaluates both
// orders of each pair, with one call of the special-function unit per
// ordered pair (student: the reciprocal) or two (gaussian: the two
// weights). At 16 results per clock per SM, 132 SMs and 1.98 GHz, 1.0e8
// ordered pairs take 24 us (48 us gaussian): the floor of this design.
//
// What the design does about it, as rowlse_fwd.cu:
//
// - A register tile per thread: kRows rows (4 for d <= 4, else 2), kThreads
//   apart, against kUnroll = 8 staged columns at a time. A staged column is one
//   aligned record (z_j, then u_j, or g_j and lse_j, padded to float4s: one
//   LDS.128 at d = 2), so one load serves kRows pairs.
// - Student: 1 + d^2 by d fused multiply-adds, rcp.approx.ftz, and the
//   accumulation a += coef * diff as d more: 10.5 instructions per pair at
//   d = 2, the reciprocal among them (14.5 in the gaussian mode), so the
//   kernel is bound by instruction issue (four warp instructions per clock
//   per SM), not by the special-function unit.
// - Gaussian: each weight is ex2.approx.ftz((d^2 + lse) * -log2 e): the sum
//   in float32 as the plain version forms it, so that the two agree where
//   d^2 and -lse are large and nearly cancel.
// - Compiled with -fmad=false as the other sources; the fused
//   multiply-adds are written by hand.
// - The tile loop is instantiated twice; only the tiles whose columns meet
//   the block's rows run the one that zeroes the j == m coefficient. There
//   the difference is zero but the coefficient need not be finite (a row
//   with lse = -inf, or the gaussian weight exp(-lse) of a far-off row).
// - The block stages its whole column chunk once, in dynamic shared memory,
//   with one __syncthreads() before the loop.
// - Grid: (row tiles of kRows * kThreads rows) x (column chunks), whole
//   waves of kBlocksPerSM = 6 blocks per SM, resident by construction (the
//   launch bounds hold the registers to 80 a thread, a chunk stages at most
//   kMaxStaged bytes; rowlse_fwd.cu has the other sizes' times); the chunk
//   partials ((n_chunks, n, d) doubles, allocated by the wrapper) are
//   merged by a second small kernel.
//
// Tensor cores and TMA are not the tools here, for rowlse_fwd.cu's reasons:
// a contraction of depth d <= 8, TF32 forbidden for distances, the cost in
// the kernel value and not in the gram, and an input of 160 KB.
//
// Accumulation as in rowlse_fwd.cu: each staged tile of at most kTile = 256
// columns is summed in float32 and added to double accumulators. The terms
// of a force have both signs and partly cancel, so the error is relative to
// the sum of |terms|, not to the result.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
// Blocks the grid counts on per SM (the wrapper sizes its waves by it): the
// launch bounds keep the registers, and kMaxStaged the shared memory (227 KB
// per SM, 1 KB of it reserved per block), within what that many blocks need.
constexpr int kBlocksPerSM = 6;
constexpr size_t kMaxStaged = 227 * 1024 / kBlocksPerSM - 1024;
constexpr int kUnroll = 8;  // staged columns per step of the inner loop
constexpr int kTile = 256;  // longest float32 run of one accumulator
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int kRows = D <= 4 ? 4 : 2;  // rows of the thread's register tile
  // floats of one staged column: z_j, then u_j (student) or g_j and lse_j
  // (gaussian), padded to whole float4s
  static constexpr int kRec = (D + 2 + 3) / 4 * 4;
};

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Student: u_i = -g_i e^(-lse_i).
__device__ __forceinline__ float student_weight(float g, float lse) { return -g * expf(-lse); }

// G staged columns, starting at cols (global column j), against the
// thread's R rows; wi is u_i (student) or g_i (gaussian), li is lse_i. The
// gaussian sums carry the opposite sign, which the caller takes back.
template <int D, int G, bool kGaussian, bool kDiag>
__device__ __forceinline__ void pair_group(const float* cols, int j,
                                           const float (&zi)[Shape<D>::kRows][D],
                                           const float (&wi)[Shape<D>::kRows],
                                           const float (&li)[Shape<D>::kRows],
                                           const int (&row)[Shape<D>::kRows],
                                           float (&a)[Shape<D>::kRows][D]) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  float rec[G][P];
#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int k = 0; k < P / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(cols + u * P)[k];
      rec[u][4 * k] = t.x;
      rec[u][4 * k + 1] = t.y;
      rec[u][4 * k + 2] = t.z;
      rec[u][4 * k + 3] = t.w;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      float diff[D];
      float coef;
      if (!kGaussian) {
        float s = 1.0f;  // 1 + d^2
#pragma unroll
        for (int c = 0; c < D; ++c) {
          diff[c] = zi[r][c] - rec[u][c];
          s = fmaf(diff[c], diff[c], s);
        }
        const float q = rcp_approx(s);
        coef = (wi[r] + rec[u][D]) * (q * q);
      } else {
        diff[0] = zi[r][0] - rec[u][0];
        float s = diff[0] * diff[0];  // d^2
#pragma unroll
        for (int c = 1; c < D; ++c) {
          diff[c] = zi[r][c] - rec[u][c];
          s = fmaf(diff[c], diff[c], s);
        }
        const float ei = ex2_approx((s + li[r]) * -kLog2e);
        const float ej = ex2_approx((s + rec[u][D + 1]) * -kLog2e);
        coef = fmaf(wi[r], ei, rec[u][D] * ej);
      }
      if (kDiag) coef = (j + u == row[r]) ? 0.0f : coef;
#pragma unroll
      for (int c = 0; c < D; ++c) a[r][c] = fmaf(coef, diff[c], a[r][c]);
    }
  }
}

// One staged tile of len <= kTile columns: a float32 run per row and
// coordinate, added to the double sums at its end.
template <int D, bool kGaussian, bool kDiag>
__device__ __forceinline__ void pair_tile(const float* cols, int j0, int len,
                                          const float (&zi)[Shape<D>::kRows][D],
                                          const float (&wi)[Shape<D>::kRows],
                                          const float (&li)[Shape<D>::kRows],
                                          const int (&row)[Shape<D>::kRows],
                                          double (&acc)[Shape<D>::kRows][D]) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  float a[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < D; ++c) a[r][c] = 0.0f;
  }
  int t = 0;
  for (; t + kUnroll <= len; t += kUnroll)
    pair_group<D, kUnroll, kGaussian, kDiag>(cols + t * P, j0 + t, zi, wi, li, row, a);
  for (; t < len; ++t)
    pair_group<D, 1, kGaussian, kDiag>(cols + t * P, j0 + t, zi, wi, li, row, a);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < D; ++c)
      acc[r][c] += static_cast<double>(kGaussian ? -a[r][c] : a[r][c]);
  }
}

template <int D, bool kGaussian>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
rowlse_bwd_partial_kernel(const float* __restrict__ Z, const float* __restrict__ lse,
                          const float* __restrict__ g, double* __restrict__ part, int n,
                          int chunk) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  extern __shared__ float4 staged[];
  float* cols = reinterpret_cast<float*>(staged);

  const int r0 = blockIdx.x * (R * kThreads);
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(n, c0 + chunk);
  for (int t = threadIdx.x; t < c1 - c0; t += kThreads) {
    const int j = c0 + t;
#pragma unroll
    for (int c = 0; c < D; ++c) cols[t * P + c] = Z[static_cast<size_t>(j) * D + c];
    cols[t * P + D] = kGaussian ? g[j] : student_weight(g[j], lse[j]);
    cols[t * P + D + 1] = lse[j];
  }

  int row[R];  // the ragged last row tile: rows >= n are computed and not written
  float zi[R][D], wi[R], li[R];
  double acc[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = r0 + r * kThreads + threadIdx.x;
    const bool live = row[r] < n;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      zi[r][c] = live ? Z[static_cast<size_t>(row[r]) * D + c] : 0.0f;
      acc[r][c] = 0.0;
    }
    li[r] = live ? lse[row[r]] : 0.0f;
    wi[r] = !live ? 0.0f : kGaussian ? g[row[r]] : student_weight(g[row[r]], li[r]);
  }
  __syncthreads();

  for (int j0 = c0; j0 < c1; j0 += kTile) {
    const int len = min(kTile, c1 - j0);
    const float* tile = cols + (j0 - c0) * P;
    // only a tile whose columns meet the block's rows can hold a j == m term
    if (j0 < r0 + R * kThreads && r0 < j0 + len)
      pair_tile<D, kGaussian, true>(tile, j0, len, zi, wi, li, row, acc);
    else
      pair_tile<D, kGaussian, false>(tile, j0, len, zi, wi, li, row, acc);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row[r] < n) {
      const size_t at = (static_cast<size_t>(blockIdx.y) * n + row[r]) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) part[at + c] = acc[r][c];
    }
  }
}

// dZ[e] = 2 * sum_k part[k][e] over the n * d entries e.
__global__ void rowlse_bwd_merge_kernel(const double* __restrict__ part,
                                        float* __restrict__ out, int nd, int n_chunks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nd) return;
  double s = 0.0;
  for (int k = 0; k < n_chunks; ++k) s += part[static_cast<size_t>(k) * nd + e];
  out[e] = static_cast<float>(2.0 * s);
}

template <int D>
int launch(const float* Z, const float* lse, const float* g, float* out, double* part, int n,
           int n_chunks, int chunk, bool gaussian, cudaStream_t stream) {
  const size_t staged_bytes = static_cast<size_t>(chunk) * Shape<D>::kRec * sizeof(float);
  if (staged_bytes > kMaxStaged) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = Shape<D>::kRows * kThreads;
  const dim3 grid((n + rows - 1) / rows, n_chunks);
  if (gaussian) {
    rowlse_bwd_partial_kernel<D, true><<<grid, kThreads, staged_bytes, stream>>>(
        Z, lse, g, part, n, chunk);
  } else {
    rowlse_bwd_partial_kernel<D, false><<<grid, kThreads, staged_bytes, stream>>>(
        Z, lse, g, part, n, chunk);
  }
  const int nd = n * D;
  rowlse_bwd_merge_kernel<<<(nd + 255) / 256, 256, 0, stream>>>(part, out, nd, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. Z (n, d), lse (n,), g (n,) and out (n, d)
// are contiguous float32 on the device; part (n_chunks, n, d) float64 is
// scratch. Column chunk k covers columns [k * chunk, min(n, (k + 1) *
// chunk)), and a chunk's staged columns must fit kMaxStaged bytes. Returns the first
// CUDA error (0 on success).
extern "C" int rowlse_bwd(const void* Z, const void* lse, const void* g, void* out,
                          void* part, int n, int d, int n_chunks, int chunk,
                          int gaussian, void* stream) {
  if (n <= 0) return 0;
  if (n_chunks <= 0 || chunk <= 0 || static_cast<long long>(n_chunks) * chunk < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* z = static_cast<const float*>(Z);
  const auto* l = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  auto* o = static_cast<float*>(out);
  auto* p = static_cast<double*>(part);
  const bool gs = gaussian != 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 2: return launch<2>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 3: return launch<3>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 4: return launch<4>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 5: return launch<5>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 6: return launch<6>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 7: return launch<7>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 8: return launch<8>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
