// Backward of the row log-sum of the pairwise embedding kernel (K3) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel torchdr_tpu/ops/pallas/reduce_kernel.py
// (rowlse_bwd_pallas_general / _bwd_kernel), in its square form through
// the wrapper rowlse_bwd_pallas. Given Z (n, d), the forward's out = lse (n,) and its
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
// The general form (entry point rowlse_bwd_general) takes a query shard
// Zq (m rows, global ids row_off + i) against the first n_cols rows of Zdb,
// and returns the TPU kernel's two outputs, dZq (m, d) and dZdb (n_cols,
// d). The two do not combine there, so it makes two launches of the same
// row-wise, atomic-free pair loop with one-sided weights (kSides):
//
//   pass A, rows Zq, columns Zdb, the row's weight only (u_i, or g_i and
//     lse_i): dZq_i = 2 sum_j c_ij (zq_i - zdb_j);
//   pass B, rows Zdb, columns Zq staged with their weights (the shard's
//     global ids as column ids): dZdb_j = 2 sum_i c_ij (zdb_j - zq_i).
//
// Together they evaluate the 2 m n_cols ordered pairs that the TPU kernel
// does, and need none of its (query tiles, n_db, d) partial buffer. The
// square form is the same loop with both weights (c_mj + c_jm), row and
// column ids offset by 0. A term whose row and column global ids are equal
// is zeroed in all forms. Each pass has its own chunk partials and merge,
// summed in a fixed order, so a result repeats bit for bit. The wrapper
// passes only the rows and columns whose global ids lie below n_total.
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

// Which weights a pair's coefficient takes: the row's and the column's
// (the square form), the row's only (pass A) or the column's only (pass B).
constexpr int kRowSide = 1;
constexpr int kColSide = 2;
constexpr int kBothSides = kRowSide | kColSide;

// G staged columns, starting at cols (global column j), against the
// thread's R rows; wi is u_i (student) or g_i (gaussian), li is lse_i. The
// gaussian sums carry the opposite sign, which the caller takes back.
template <int D, int G, bool kGaussian, bool kDiag, int kSides>
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
        const float w = kSides == kBothSides ? wi[r] + rec[u][D]
                        : kSides == kRowSide ? wi[r] : rec[u][D];
        coef = w * (q * q);
      } else {
        diff[0] = zi[r][0] - rec[u][0];
        float s = diff[0] * diff[0];  // d^2
#pragma unroll
        for (int c = 1; c < D; ++c) {
          diff[c] = zi[r][c] - rec[u][c];
          s = fmaf(diff[c], diff[c], s);
        }
        if (kSides == kBothSides) {
          const float ei = ex2_approx((s + li[r]) * -kLog2e);
          const float ej = ex2_approx((s + rec[u][D + 1]) * -kLog2e);
          coef = fmaf(wi[r], ei, rec[u][D] * ej);
        } else if (kSides == kRowSide) {
          coef = wi[r] * ex2_approx((s + li[r]) * -kLog2e);
        } else {
          coef = rec[u][D] * ex2_approx((s + rec[u][D + 1]) * -kLog2e);
        }
      }
      if (kDiag) coef = (j + u == row[r]) ? 0.0f : coef;
#pragma unroll
      for (int c = 0; c < D; ++c) a[r][c] = fmaf(coef, diff[c], a[r][c]);
    }
  }
}

// One staged tile of len <= kTile columns: a float32 run per row and
// coordinate, added to the double sums at its end.
template <int D, bool kGaussian, bool kDiag, int kSides>
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
    pair_group<D, kUnroll, kGaussian, kDiag, kSides>(cols + t * P, j0 + t, zi, wi, li, row, a);
  for (; t < len; ++t)
    pair_group<D, 1, kGaussian, kDiag, kSides>(cols + t * P, j0 + t, zi, wi, li, row, a);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < D; ++c)
      acc[r][c] += static_cast<double>(kGaussian ? -a[r][c] : a[r][c]);
  }
}

// Rows: m rows of Zr (global ids row_off + i) with their g and lse; columns:
// n_cols rows of Zc (global ids col_off + j) with theirs. The weights a
// side does not take are not read (their pointers may be null).
template <int D, bool kGaussian, int kSides>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
rowlse_bwd_partial_kernel(const float* __restrict__ Zr, const float* __restrict__ lse_r,
                          const float* __restrict__ g_r, const float* __restrict__ Zc,
                          const float* __restrict__ lse_c, const float* __restrict__ g_c,
                          double* __restrict__ part, int m, int n_cols, int row_off,
                          int col_off, int chunk) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  extern __shared__ float4 staged[];
  float* cols = reinterpret_cast<float*>(staged);

  const int r0 = blockIdx.x * (R * kThreads);
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(n_cols, c0 + chunk);
  for (int t = threadIdx.x; t < c1 - c0; t += kThreads) {
    const int j = c0 + t;
#pragma unroll
    for (int c = 0; c < D; ++c) cols[t * P + c] = Zc[static_cast<size_t>(j) * D + c];
    if (kSides & kColSide) {
      cols[t * P + D] = kGaussian ? g_c[j] : student_weight(g_c[j], lse_c[j]);
      cols[t * P + D + 1] = lse_c[j];
    } else {
      cols[t * P + D] = 0.0f;
      cols[t * P + D + 1] = 0.0f;
    }
  }

  // global row ids, which the diagonal test compares with column ids; the
  // ragged last row tile: rows >= m are computed and not written
  int row[R];
  float zi[R][D], wi[R], li[R];
  double acc[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r0 + r * kThreads + threadIdx.x;
    row[r] = row_off + i;
    const bool live = i < m;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      zi[r][c] = live ? Zr[static_cast<size_t>(i) * D + c] : 0.0f;
      acc[r][c] = 0.0;
    }
    const bool weighted = live && (kSides & kRowSide);
    li[r] = weighted ? lse_r[i] : 0.0f;
    wi[r] = !weighted ? 0.0f : kGaussian ? g_r[i] : student_weight(g_r[i], li[r]);
  }
  __syncthreads();

  const int g0 = row_off + r0;  // the block's first global row id
  for (int j0 = c0; j0 < c1; j0 += kTile) {
    const int len = min(kTile, c1 - j0);
    const float* tile = cols + (j0 - c0) * P;
    const int gj0 = col_off + j0;  // the tile's first global column id
    // only a tile whose global columns meet the block's global rows can
    // hold a term of equal ids
    if (gj0 < g0 + R * kThreads && g0 < gj0 + len)
      pair_tile<D, kGaussian, true, kSides>(tile, gj0, len, zi, wi, li, row, acc);
    else
      pair_tile<D, kGaussian, false, kSides>(tile, gj0, len, zi, wi, li, row, acc);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row[r] - row_off;
    if (i < m) {
      const size_t at = (static_cast<size_t>(blockIdx.y) * m + i) * D;
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

// One pass: the partial kernel over (row tiles x column chunks), then the
// merge of its chunk partials into out (m, d).
template <int D, int kSides>
int pass(const float* Zr, const float* lse_r, const float* g_r, const float* Zc,
         const float* lse_c, const float* g_c, float* out, double* part, int m, int n_cols,
         int row_off, int col_off, int n_chunks, int chunk, bool gaussian,
         cudaStream_t stream) {
  if (n_chunks <= 0 || chunk <= 0 || static_cast<long long>(n_chunks) * chunk < n_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t staged_bytes = static_cast<size_t>(chunk) * Shape<D>::kRec * sizeof(float);
  if (staged_bytes > kMaxStaged) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = Shape<D>::kRows * kThreads;
  const dim3 grid((m + rows - 1) / rows, n_chunks);
  if (gaussian) {
    rowlse_bwd_partial_kernel<D, true, kSides><<<grid, kThreads, staged_bytes, stream>>>(
        Zr, lse_r, g_r, Zc, lse_c, g_c, part, m, n_cols, row_off, col_off, chunk);
  } else {
    rowlse_bwd_partial_kernel<D, false, kSides><<<grid, kThreads, staged_bytes, stream>>>(
        Zr, lse_r, g_r, Zc, lse_c, g_c, part, m, n_cols, row_off, col_off, chunk);
  }
  const int nd = m * D;
  rowlse_bwd_merge_kernel<<<(nd + 255) / 256, 256, 0, stream>>>(part, out, nd, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int square(const float* Z, const float* lse, const float* g, float* out, double* part, int n,
           int n_chunks, int chunk, bool gaussian, cudaStream_t stream) {
  return pass<D, kBothSides>(Z, lse, g, Z, lse, g, out, part, n, n, 0, 0, n_chunks, chunk,
                             gaussian, stream);
}

template <int D>
int general(const float* Zq, const float* Zdb, const float* lse, const float* g, float* dzq,
            float* dzdb, double* part, int m, int n_cols, int row_off, int n_chunks_a,
            int chunk_a, int n_chunks_b, int chunk_b, bool gaussian, cudaStream_t stream) {
  const int rc = pass<D, kRowSide>(Zq, lse, g, Zdb, nullptr, nullptr, dzq, part, m, n_cols,
                                   row_off, 0, n_chunks_a, chunk_a, gaussian, stream);
  if (rc != 0) return rc;
  double* part_b = part + static_cast<size_t>(n_chunks_a) * m * D;
  return pass<D, kColSide>(Zdb, nullptr, nullptr, Zq, lse, g, dzdb, part_b, n_cols, m, 0,
                           row_off, n_chunks_b, chunk_b, gaussian, stream);
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
  const auto* z = static_cast<const float*>(Z);
  const auto* l = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  auto* o = static_cast<float*>(out);
  auto* p = static_cast<double*>(part);
  const bool gs = gaussian != 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return square<1>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 2: return square<2>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 3: return square<3>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 4: return square<4>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 5: return square<5>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 6: return square<6>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 7: return square<7>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    case 8: return square<8>(z, l, gp, o, p, n, n_chunks, chunk, gs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The general form: Zq (m, d) with its lse (m,) and g (m,) holds the rows
// of global ids row_off + i; Zdb's first n_cols rows are the columns. Writes
// dzq (m, d) and dzdb (n_cols, d). part is scratch of (n_chunks_a m +
// n_chunks_b n_cols) d doubles: pass A's chunks cut the n_cols columns,
// pass B's the m rows of Zq. Every row and column passed is live.
extern "C" int rowlse_bwd_general(const void* Zq, const void* Zdb, const void* lse,
                                  const void* g, void* dzq, void* dzdb, void* part, int m,
                                  int n_cols, int row_off, int d, int n_chunks_a, int chunk_a,
                                  int n_chunks_b, int chunk_b, int gaussian, void* stream) {
  if (m <= 0 || n_cols <= 0) return 0;
  if (row_off < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* zq = static_cast<const float*>(Zq);
  const auto* zd = static_cast<const float*>(Zdb);
  const auto* l = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  auto* oq = static_cast<float*>(dzq);
  auto* od = static_cast<float*>(dzdb);
  auto* p = static_cast<double*>(part);
  const bool gs = gaussian != 0;
  auto st = static_cast<cudaStream_t>(stream);
#define TDR_GENERAL(D)                                                                      \
  case D:                                                                                   \
    return general<D>(zq, zd, l, gp, oq, od, p, m, n_cols, row_off, n_chunks_a, chunk_a, \
                      n_chunks_b, chunk_b, gs, st);
  switch (d) {
    TDR_GENERAL(1)
    TDR_GENERAL(2)
    TDR_GENERAL(3)
    TDR_GENERAL(4)
    TDR_GENERAL(5)
    TDR_GENERAL(6)
    TDR_GENERAL(7)
    TDR_GENERAL(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TDR_GENERAL
}
