// Backward of the row log-sum of the pairwise embedding kernel (K3) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel torchdr_tpu/ops/pallas/reduce_kernel.py
// (rowlse_bwd_pallas_general / _bwd_kernel), through its square wrapper
// rowlse_bwd_pallas and in its general form (below). Given Z (n, d), the
// forward's out = lse (n,) and its
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
// Where the wrapper's rule takes it (below), the student mode evaluates
// each unordered pair once instead.
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
// Zq (m rows, global ids row_off + i) with its lse and g against the first
// n_cols rows of Zdb, and returns the TPU kernel's two outputs, dZq (m, d)
// and dZdb (n_cols, d), with the one-sided coefficient c_ij (the row's
// weight only). It evaluates each of the m n_cols pairs once, in one pass:
// the pair's term c_ij (zq_i - zdb_j) is added to row i's register sums
// (dZq) and to column j's sum (dZdb, with the sign taken back at the end).
//
// Bound. The pairs' arithmetic, as above: 6d + 3 float32 operations a pair
// (gaussian one fewer; a pair with both ends in the shard counted once):
// 0.124 ms at 12,500 x 50,000 (one shard of a 4-way mesh, 6.25e8 pairs) at
// 67 TFLOP/s; the bytes are 1.2 MB. This design makes one special-function
// call a pair (the reciprocal, or the exp2 of the row's weight), 0.15 ms at
// 16 a clock per SM, and 11.75 instructions a pair at d = 2 (cuobjdump),
// 0.22 ms at four warp instructions a clock per SM: issue is its floor.
//
// What the design does about the column sums, with no atomics:
// - A warp walks each block of 32 staged columns in 32 steps; at step t lane
//   l takes column (l + t) mod 32 against its kRows rows, and holds that
//   column's running sum, which then moves one lane down (one __shfl_sync a
//   coordinate per kRows pairs). After the 32 steps lane l holds column l's
//   sum over the warp's 32 kRows rows, a float32 run of at most 128 terms,
//   and stores it in the warp's own shared-memory slot for that column. The
//   column side so costs d fused multiply-adds a pair and d / kRows
//   shuffles: 2.5 instructions a pair at d = 2. (Two running sums a
//   column, each fed by half the rows, shortened the chain and ran 3 %
//   slower.)
// - Each block of 32 columns is staged twice in a row, so that lane l's
//   record at step t lies at a constant offset t from its own base: one
//   LDS a step, with no index arithmetic.
// - At the end of the chunk the block's warps' column sums are added in
//   double in warp order, and each (row tile, column) pair of the grid
//   writes its partial; rows keep the float32 runs of at most kTile
//   columns into doubles and write one partial a column chunk.
// - One merge kernel sums both: dZq over the chunks (a warp a row), dZdb
//   over the row tiles, each in a fixed order, so a call repeats bit for
//   bit. The
//   scratch is (n_chunks, m, d) + (row tiles, n_cols, d) doubles: 18.4 MB
//   + 20.0 MB at 12,500 x 50,000, d = 2 (92 chunks of 544, 25 row tiles).
// - The grid is the square form's: (row tiles) x (column chunks, here
//   multiples of 32 columns) in whole waves, sized by the wrapper. A block
//   of 32 columns that is ragged (past n_cols) or meets the block's global
//   rows takes the masked step, which zeroes those terms.
// - The square form keeps its own kernel above: sharing its loop with the
//   general form slowed it by 4.5 to 8.6 % (PERF.md section 6).
//
// The square form's symmetric walk (student, kSym of
// rowlse_bwd_partial_kernel and rowlse_bwd_merge_kernel), which the
// wrapper's rule (reduce_kernel.square_grid) takes for the student kernel
// while its scratch stays within 1 GiB (n up to 134,756 at d = 2 on 132
// SMs), in three waves of chunks of 32-column blocks. The student
// coefficient is symmetric, (u_i + u_j) q_ij^2, so the term
// f = (u_i + u_j) q^2 (z_i - z_j) of each
// unordered pair (i, j), i < j, is evaluated once, added to row i's
// register sums and subtracted from column j's running sum, which the
// general form's walk passes from lane to lane (symmetric_block). A staged
// record holds z_j and u_j (one LDS.128 at d = 2), each block of 32 twice.
// 12.75 instructions a pair at d = 2 (the general form's 11.75 and the add
// u_i + u_j), where both orders cost 21. Blocks of 32 columns wholly below
// the row tile are skipped, and a grid block whose chunk lies wholly below
// its row tile returns at once and writes nothing; the rest take the
// masked step where they meet the tile's rows or are ragged. The merge adds
// an entry's row sums over the chunks that reach its tile, then its column
// sums over the row tiles that reach its chunk, in that order: no atomics,
// the same bits every call. Staging: 64 bytes a column at d = 2 (chunks of
// 576). Scratch: (n_chunks + row tiles, n, d) doubles, 0.290 GB at
// n = 70,000 (122 chunks, 137 row tiles), of which the merge reads the
// live half: 0.059 ms of the call's 1.27 ms, against 1.84 ms for both
// orders (an H100 80GB HBM3 at 700 W, PERF.md section 6).
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
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMergeThreads = 256;

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

// One staged column into registers, by the widest aligned loads.
template <int P>
__device__ __forceinline__ void load_record(const float* rec, float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int k = 0; k < P / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(rec)[k];
      v[4 * k] = t.x;
      v[4 * k + 1] = t.y;
      v[4 * k + 2] = t.z;
      v[4 * k + 3] = t.w;
    }
  } else if constexpr (P == 2) {
    const float2 t = *reinterpret_cast<const float2*>(rec);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = rec[0];
  }
}

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

// The square form, both orders of every pair: row tile blockIdx.x against
// column chunk blockIdx.y, each row's chunk sum into part (chunk, row, d).
template <int D, bool kGaussian>
__device__ __forceinline__ void ordered_chunk(const float* __restrict__ Z,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ g,
                                              double* __restrict__ part, int n, int chunk) {
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

// The square form's symmetric walk (student): a staged column's record,
// z_j then u_j, padded to an aligned vector, and the shared floats a column
// takes: its record twice and each warp's column sum.
template <int D>
struct Sym {
  static constexpr int kRec = D + 1 <= 2 ? 2 : (D + 1 + 3) / 4 * 4;
  static constexpr int kColFloats = 2 * kRec + kWarps * D;
};

// A block of 32 staged columns (global ids j0 + k, those of k >= live
// padding) against the thread's R rows in 32 steps, as column_block below
// walks them: at step t the lane takes column k = (lane + t) mod 32 and
// holds its running sum, passed one lane down after the step. The pair's
// term f = (u_i + u_j) q^2 (z_i - z_j) is added to the row's sums and to the
// column's, which stands for -f. kMask: a pair counts only where its column
// is live and lies above its row (j > i; the j == i term is zero, its
// coefficient need not be finite).
template <int D, bool kMask>
__device__ __forceinline__ void symmetric_block(const float* zb, int j0, int live, int lane,
                                                const float (&zi)[Shape<D>::kRows][D],
                                                const float (&wi)[Shape<D>::kRows],
                                                const int (&row)[Shape<D>::kRows],
                                                float (&a)[Shape<D>::kRows][D], float (&ca)[D]) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Sym<D>::kRec;
  const int from = (lane + 1) & (kLanes - 1);
#pragma unroll
  for (int c = 0; c < D; ++c) ca[c] = 0.0f;
#pragma unroll
  for (int t = 0; t < kLanes; ++t) {
    float zj[P];
    load_record<P>(zb + t * P, zj);
    const int k = (lane + t) & (kLanes - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float diff[D];
      float s = 1.0f;  // 1 + d^2
#pragma unroll
      for (int c = 0; c < D; ++c) {
        diff[c] = zi[r][c] - zj[c];
        s = fmaf(diff[c], diff[c], s);
      }
      const float q = rcp_approx(s);
      float coef = (wi[r] + zj[D]) * (q * q);
      if (kMask) coef = (k < live && j0 + k > row[r]) ? coef : 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        a[r][c] = fmaf(coef, diff[c], a[r][c]);
        ca[c] = fmaf(coef, diff[c], ca[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < D; ++c) ca[c] = __shfl_sync(kFullMask, ca[c], from);
  }
}

// The square form's symmetric walk (student): each unordered pair (i, j),
// i < j, once, its term added to row i and subtracted from column j. The
// chunk is staged as blocks of 32 records, each twice; a block of 32
// columns wholly below the row tile is skipped (the transposed block counts
// its pairs), as is the whole chunk where every column lies below every row:
// such a block writes nothing, and the merge reads none of its slots. Row
// sums go to part (chunk, row, d), column sums, added over the warps in
// order, to part_col (row tile, column, d).
template <int D>
__device__ __forceinline__ void symmetric_chunk(const float* __restrict__ Z,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ g,
                                                double* __restrict__ part,
                                                double* __restrict__ part_col, int n, int chunk) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Sym<D>::kRec;
  const int r0 = blockIdx.x * (R * kThreads);
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(n, c0 + chunk);
  if (c1 <= r0) return;
  extern __shared__ float4 staged[];
  const int len = c1 - c0;
  const int n_blk = (len + kLanes - 1) / kLanes;
  float* zs = reinterpret_cast<float*>(staged);  // record e of block b: column 32 b + e mod 32
  float* cs = zs + n_blk * 2 * kLanes * P;       // [warp][column][coordinate] sums
  for (int e = threadIdx.x; e < n_blk * 2 * kLanes; e += kThreads) {
    const int col = (e / (2 * kLanes)) * kLanes + (e & (kLanes - 1));
    const bool in = col < len;
    const size_t j = static_cast<size_t>(c0 + col);
#pragma unroll
    for (int c = 0; c < P; ++c)
      zs[e * P + c] = !in ? 0.0f : c < D ? Z[j * D + c] : c == D ? student_weight(g[j], lse[j]) : 0.0f;
  }

  int row[R];  // the ragged last row tile: rows >= n take no pair and are not written
  float zi[R][D], wi[R], a[R][D];
  double acc[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = r0 + r * kThreads + threadIdx.x;
    const bool live = row[r] < n;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      zi[r][c] = live ? Z[static_cast<size_t>(row[r]) * D + c] : 0.0f;
      a[r][c] = 0.0f;
      acc[r][c] = 0.0;
    }
    wi[r] = live ? student_weight(g[row[r]], lse[row[r]]) : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & (kLanes - 1);
  float* own = cs + (threadIdx.x / kLanes) * (n_blk * kLanes * D);
  for (int b = 0; b < n_blk; ++b) {
    const int j0 = c0 + b * kLanes;
    const int live = len - b * kLanes;
    const float* zb = zs + (b * 2 * kLanes + lane) * P;
    float ca[D];
    if (live >= kLanes && j0 > r0 + R * kThreads - 1) {
      symmetric_block<D, false>(zb, j0, live, lane, zi, wi, row, a, ca);
    } else if (j0 + kLanes - 1 >= r0) {
      symmetric_block<D, true>(zb, j0, live, lane, zi, wi, row, a, ca);
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) ca[c] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < D; ++c) own[(b * kLanes + lane) * D + c] = ca[c];
    if ((b + 1) % (kTile / kLanes) == 0 || b + 1 == n_blk) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          acc[r][c] += static_cast<double>(a[r][c]);
          a[r][c] = 0.0f;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row[r] < n) {
      const size_t at = (static_cast<size_t>(blockIdx.y) * n + row[r]) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) part[at + c] = acc[r][c];
    }
  }
  __syncthreads();
  double* out = part_col + (static_cast<size_t>(blockIdx.x) * n + c0) * D;
  for (int e = threadIdx.x; e < len * D; e += kThreads) {
    double sum = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += static_cast<double>(cs[w * (n_blk * kLanes * D) + e]);
    out[e] = -sum;
  }
}

// The square form's pair loop: both orders of every pair, or (kSym, student
// only) each unordered pair once, its column sums into part_col.
template <int D, bool kGaussian, bool kSym>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
rowlse_bwd_partial_kernel(const float* __restrict__ Z, const float* __restrict__ lse,
                          const float* __restrict__ g, double* __restrict__ part,
                          double* __restrict__ part_col, int n, int chunk) {
  static_assert(!(kSym && kGaussian), "the symmetric walk is the student mode's");
  if constexpr (kSym)
    symmetric_chunk<D>(Z, lse, g, part, part_col, n, chunk);
  else
    ordered_chunk<D, kGaussian>(Z, lse, g, part, n, chunk);
}

// dZ[e] = 2 * sum_k part[k][e] over the n * d entries e. kSym: the partials
// of the chunks that reach row e / d's tile (of `rows` rows), then the column
// sums of the row tiles that reach its chunk, in order: the slots the pair
// loop wrote, and no other.
template <bool kSym>
__global__ void rowlse_bwd_merge_kernel(const double* __restrict__ part,
                                        const double* __restrict__ part_col,
                                        float* __restrict__ out, int n, int d, int n_chunks,
                                        int chunk, int rows) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nd = n * d;
  if (e >= nd) return;
  const int i = e / d;
  double s = 0.0;
  const int k0 = kSym ? i / rows * rows / chunk : 0;
#pragma unroll 4
  for (int k = k0; k < n_chunks; ++k) s += part[static_cast<size_t>(k) * nd + e];
  if (kSym) {
    const int tiles = (min(n, (i / chunk + 1) * chunk) - 1) / rows + 1;
#pragma unroll 4
    for (int t = 0; t < tiles; ++t) s += part_col[static_cast<size_t>(t) * nd + e];
  }
  out[e] = static_cast<float>(2.0 * s);
}

template <int D>
int launch(const float* Z, const float* lse, const float* g, float* out, double* part, int n,
           int n_chunks, int chunk, bool gaussian, bool symmetric, cudaStream_t stream) {
  if (symmetric && (gaussian || chunk % kLanes != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t staged_bytes =
      static_cast<size_t>(chunk) * (symmetric ? Sym<D>::kColFloats : Shape<D>::kRec) * sizeof(float);
  if (staged_bytes > kMaxStaged) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = Shape<D>::kRows * kThreads;
  const dim3 grid((n + rows - 1) / rows, n_chunks);
  // symmetric: the chunks' row sums, then the row tiles' column sums
  double* part_col = symmetric ? part + static_cast<size_t>(n_chunks) * n * D : nullptr;
  if (gaussian) {
    rowlse_bwd_partial_kernel<D, true, false><<<grid, kThreads, staged_bytes, stream>>>(
        Z, lse, g, part, nullptr, n, chunk);
  } else if (symmetric) {
    rowlse_bwd_partial_kernel<D, false, true><<<grid, kThreads, staged_bytes, stream>>>(
        Z, lse, g, part, part_col, n, chunk);
  } else {
    rowlse_bwd_partial_kernel<D, false, false><<<grid, kThreads, staged_bytes, stream>>>(
        Z, lse, g, part, nullptr, n, chunk);
  }
  const int merge_blocks = (n * D + 255) / 256;
  if (symmetric)
    rowlse_bwd_merge_kernel<true><<<merge_blocks, 256, 0, stream>>>(part, part_col, out, n, D,
                                                                     n_chunks, chunk, rows);
  else
    rowlse_bwd_merge_kernel<false><<<merge_blocks, 256, 0, stream>>>(part, nullptr, out, n, D,
                                                                      n_chunks, chunk, rows);
  return static_cast<int>(cudaGetLastError());
}


// ---- The general form: one evaluation per pair (rowlse_bwd_general) ----


template <int D>
struct General {
  static constexpr int kRows = Shape<D>::kRows;
  // floats of one staged z_j, padded to an aligned vector (as rowlse_fwd.cu)
  static constexpr int kRec = D == 1 ? 1 : D == 2 ? 2 : D <= 4 ? 4 : 8;
  // shared floats a column takes: z_j twice and each warp's column sum
  static constexpr int kColFloats = 2 * kRec + kWarps * D;
};

// A block of 32 staged columns (global ids j0 + k; those of k >= live are
// padding) against the thread's R rows, in 32 steps: at step t the lane
// takes column k = (lane + t) mod 32, whose running sum it holds in ca,
// and passes that sum one lane down. zb is the lane's first record in the
// doubled block. After the last step the lane holds column lane's sum.
// kMask zeroes the terms of padding columns and of equal global ids (there
// the difference is zero but the coefficient need not be finite).
template <int D, bool kGaussian, bool kMask>
__device__ __forceinline__ void column_block(const float* zb, int j0, int live, int lane,
                                             const float (&zi)[General<D>::kRows][D],
                                             const float (&wi)[General<D>::kRows],
                                             const float (&li)[General<D>::kRows],
                                             const int (&row)[General<D>::kRows],
                                             float (&a)[General<D>::kRows][D], float (&ca)[D]) {
  constexpr int R = General<D>::kRows;
  constexpr int P = General<D>::kRec;
  const int from = (lane + 1) & (kLanes - 1);
#pragma unroll
  for (int c = 0; c < D; ++c) ca[c] = 0.0f;
#pragma unroll
  for (int t = 0; t < kLanes; ++t) {
    float zj[P];
    load_record<P>(zb + t * P, zj);
    const int k = (lane + t) & (kLanes - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float diff[D];
      float coef;
      if (!kGaussian) {
        float s = 1.0f;  // 1 + d^2
#pragma unroll
        for (int c = 0; c < D; ++c) {
          diff[c] = zi[r][c] - zj[c];
          s = fmaf(diff[c], diff[c], s);
        }
        const float q = rcp_approx(s);
        coef = wi[r] * (q * q);
      } else {
        diff[0] = zi[r][0] - zj[0];
        float s = diff[0] * diff[0];  // d^2
#pragma unroll
        for (int c = 1; c < D; ++c) {
          diff[c] = zi[r][c] - zj[c];
          s = fmaf(diff[c], diff[c], s);
        }
        coef = wi[r] * ex2_approx((s + li[r]) * -kLog2e);
      }
      if (kMask) coef = (k >= live || j0 + k == row[r]) ? 0.0f : coef;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        a[r][c] = fmaf(coef, diff[c], a[r][c]);
        ca[c] = fmaf(coef, diff[c], ca[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < D; ++c) ca[c] = __shfl_sync(kFullMask, ca[c], from);
  }
}

// Rows: the m rows of Zq (global ids row_off + i) with their lse and g;
// columns: chunk blockIdx.y of the n_cols rows of Zdb. Writes this chunk's
// partial of dZq rows and this row tile's partial of dZdb columns.
template <int D, bool kGaussian>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
rowlse_bwd_general_kernel(const float* __restrict__ Zq, const float* __restrict__ Zdb,
                          const float* __restrict__ lse, const float* __restrict__ g,
                          double* __restrict__ part_q, double* __restrict__ part_db, int m,
                          int n_cols, int row_off, int chunk) {
  constexpr int R = General<D>::kRows;
  constexpr int P = General<D>::kRec;
  extern __shared__ float4 staged[];
  const int c0 = blockIdx.y * chunk;
  const int len = min(n_cols, c0 + chunk) - c0;
  const int n_blk = (len + kLanes - 1) / kLanes;
  float* zs = reinterpret_cast<float*>(staged);  // 2 * 32 records a block of columns
  float* cs = zs + n_blk * 2 * kLanes * P;       // [warp][column][coordinate] sums
  // record e of block b holds column 32 b + (e mod 32): the block twice
  for (int e = threadIdx.x; e < n_blk * 2 * kLanes; e += kThreads) {
    const int col = (e / (2 * kLanes)) * kLanes + (e & (kLanes - 1));
#pragma unroll
    for (int c = 0; c < P; ++c)
      zs[e * P + c] = (c < D && col < len) ? Zdb[static_cast<size_t>(c0 + col) * D + c] : 0.0f;
  }

  const int lane = threadIdx.x & (kLanes - 1);
  const int r0 = blockIdx.x * (R * kThreads);
  // global row ids, which the mask compares with column ids; the ragged
  // last row tile: rows >= m have weight 0 and are not written
  int row[R];
  float zi[R][D], wi[R], li[R], a[R][D];
  double acc[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r0 + r * kThreads + threadIdx.x;
    row[r] = row_off + i;
    const bool live = i < m;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      zi[r][c] = live ? Zq[static_cast<size_t>(i) * D + c] : 0.0f;
      a[r][c] = 0.0f;
      acc[r][c] = 0.0;
    }
    li[r] = live ? lse[i] : 0.0f;
    wi[r] = !live ? 0.0f : kGaussian ? g[i] : student_weight(g[i], li[r]);
  }
  __syncthreads();

  const int g0 = row_off + r0;  // the block's first global row id
  float* own = cs + (threadIdx.x / kLanes) * (n_blk * kLanes * D);
  for (int b = 0; b < n_blk; ++b) {
    const int j0 = c0 + b * kLanes;
    const int live = len - b * kLanes;
    const float* zb = zs + (b * 2 * kLanes + lane) * P;
    float ca[D];
    if (live < kLanes || (j0 < g0 + R * kThreads && g0 < j0 + kLanes))
      column_block<D, kGaussian, true>(zb, j0, live, lane, zi, wi, li, row, a, ca);
    else
      column_block<D, kGaussian, false>(zb, j0, live, lane, zi, wi, li, row, a, ca);
#pragma unroll
    for (int c = 0; c < D; ++c) own[(b * kLanes + lane) * D + c] = ca[c];
    if ((b + 1) % (kTile / kLanes) == 0 || b + 1 == n_blk) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          acc[r][c] += static_cast<double>(a[r][c]);
          a[r][c] = 0.0f;
        }
      }
    }
  }

  // the gaussian sums carry the opposite sign; a column's term is the
  // row's with the difference reversed
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row[r] - row_off;
    if (i < m) {
      const size_t at = (static_cast<size_t>(blockIdx.y) * m + i) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) part_q[at + c] = kGaussian ? -acc[r][c] : acc[r][c];
    }
  }
  __syncthreads();
  double* out = part_db + (static_cast<size_t>(blockIdx.x) * n_cols + c0) * D;
  for (int e = threadIdx.x; e < len * D; e += kThreads) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += static_cast<double>(cs[w * (n_blk * kLanes * D) + e]);
    out[e] = kGaussian ? s : -s;
  }
}

// dZq: a warp a row, lane l summing chunks l, l + 32, ... in order, then
// the lanes' sums by a fixed xor tree (many chunks of few rows would leave
// a thread a row latency-bound); dZdb: a thread an entry, the row tiles in
// order. All in double. Blocks below q_blocks take dZq.
template <int D>
__global__ void rowlse_bwd_general_merge_kernel(const double* __restrict__ part_q,
                                                const double* __restrict__ part_db,
                                                float* __restrict__ dzq, float* __restrict__ dzdb,
                                                int m, int nd, int n_chunks, int n_tiles,
                                                int q_blocks) {
  if (static_cast<int>(blockIdx.x) < q_blocks) {
    const int i = blockIdx.x * (kMergeThreads / kLanes) + threadIdx.x / kLanes;
    const int lane = threadIdx.x & (kLanes - 1);
    if (i >= m) return;  // the whole warp
    double s[D];
#pragma unroll
    for (int c = 0; c < D; ++c) s[c] = 0.0;
    for (int k = lane; k < n_chunks; k += kLanes) {
#pragma unroll
      for (int c = 0; c < D; ++c) s[c] += part_q[(static_cast<size_t>(k) * m + i) * D + c];
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2) {
#pragma unroll
      for (int c = 0; c < D; ++c) s[c] += __shfl_xor_sync(kFullMask, s[c], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < D; ++c) dzq[static_cast<size_t>(i) * D + c] = static_cast<float>(2.0 * s[c]);
    }
    return;
  }
  const int f = (blockIdx.x - q_blocks) * kMergeThreads + threadIdx.x;
  if (f >= nd) return;
  double s = 0.0;
  for (int t = 0; t < n_tiles; ++t) s += part_db[static_cast<size_t>(t) * nd + f];
  dzdb[f] = static_cast<float>(2.0 * s);
}

template <int D>
int general(const float* Zq, const float* Zdb, const float* lse, const float* g, float* dzq,
            float* dzdb, double* part, int m, int n_cols, int row_off, int n_chunks, int chunk,
            bool gaussian, cudaStream_t stream, int* kernels) {
  if (n_chunks <= 0 || chunk <= 0 || chunk % kLanes != 0 ||
      static_cast<long long>(n_chunks) * chunk < n_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t staged_bytes =
      static_cast<size_t>(chunk) * General<D>::kColFloats * sizeof(float);
  if (staged_bytes > kMaxStaged) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = General<D>::kRows * kThreads;
  const int n_tiles = (m + rows - 1) / rows;
  const dim3 grid(n_tiles, n_chunks);
  double* part_db = part + static_cast<size_t>(n_chunks) * m * D;
  if (gaussian) {
    rowlse_bwd_general_kernel<D, true><<<grid, kThreads, staged_bytes, stream>>>(
        Zq, Zdb, lse, g, part, part_db, m, n_cols, row_off, chunk);
  } else {
    rowlse_bwd_general_kernel<D, false><<<grid, kThreads, staged_bytes, stream>>>(
        Zq, Zdb, lse, g, part, part_db, m, n_cols, row_off, chunk);
  }
  ++*kernels;
  const int q_blocks = (m + kMergeThreads / kLanes - 1) / (kMergeThreads / kLanes);
  const int nd = n_cols * D;
  rowlse_bwd_general_merge_kernel<D>
      <<<q_blocks + (nd + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, stream>>>(
          part, part_db, dzq, dzdb, m, nd, n_chunks, n_tiles, q_blocks);
  ++*kernels;
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// C interface, loaded with ctypes. Z (n, d), lse (n,), g (n,) and out (n, d)
// are contiguous float32 on the device; part (n_chunks, n, d) float64 is
// scratch. Column chunk k covers columns [k * chunk, min(n, (k + 1) *
// chunk)), and a chunk's staged columns must fit kMaxStaged bytes. symmetric
// (student only, chunk a multiple of 32): each unordered pair once, part
// then (n_chunks + row tiles, n, d), the chunks' row sums and the row
// tiles' column sums. Returns the first CUDA error (0 on success).
extern "C" int rowlse_bwd(const void* Z, const void* lse, const void* g, void* out,
                          void* part, int n, int d, int n_chunks, int chunk,
                          int gaussian, int symmetric, void* stream) {
  if (n <= 0) return 0;
  if (n_chunks <= 0 || chunk <= 0 || static_cast<long long>(n_chunks) * chunk < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* z = static_cast<const float*>(Z);
  const auto* l = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  auto* o = static_cast<float*>(out);
  auto* p = static_cast<double*>(part);
  const bool gs = gaussian != 0, sy = symmetric != 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(z, l, gp, o, p, n, n_chunks, chunk, gs, sy, st);
    case 2: return launch<2>(z, l, gp, o, p, n, n_chunks, chunk, gs, sy, st);
    case 3: return launch<3>(z, l, gp, o, p, n, n_chunks, chunk, gs, sy, st);
    case 4: return launch<4>(z, l, gp, o, p, n, n_chunks, chunk, gs, sy, st);
    case 5: return launch<5>(z, l, gp, o, p, n, n_chunks, chunk, gs, sy, st);
    case 6: return launch<6>(z, l, gp, o, p, n, n_chunks, chunk, gs, sy, st);
    case 7: return launch<7>(z, l, gp, o, p, n, n_chunks, chunk, gs, sy, st);
    case 8: return launch<8>(z, l, gp, o, p, n, n_chunks, chunk, gs, sy, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The general form: Zq (m, d) with its lse (m,) and g (m,) holds the rows
// of global ids row_off + i; Zdb's first n_cols rows are the columns. Writes
// dzq (m, d) and dzdb (n_cols, d). part is scratch of (n_chunks m + row
// tiles n_cols) d doubles, the row tiles being of kRows * kThreads rows;
// column chunk k covers [k * chunk, min(n_cols, (k + 1) * chunk)), chunk a
// multiple of 32 whose staging fits kMaxStaged bytes. Every row and column
// passed is live. Adds the kernels it launched to *kernels.
extern "C" int rowlse_bwd_general(const void* Zq, const void* Zdb, const void* lse,
                                  const void* g, void* dzq, void* dzdb, void* part, int m,
                                  int n_cols, int row_off, int d, int n_chunks, int chunk,
                                  int gaussian, int* kernels, void* stream) {
  if (m <= 0 || n_cols <= 0) return 0;
  if (row_off < 0 || kernels == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto* zq = static_cast<const float*>(Zq);
  const auto* zd = static_cast<const float*>(Zdb);
  const auto* l = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  auto* oq = static_cast<float*>(dzq);
  auto* od = static_cast<float*>(dzdb);
  auto* p = static_cast<double*>(part);
  const bool gs = gaussian != 0;
  auto st = static_cast<cudaStream_t>(stream);
#define TDR_GENERAL(D)                                                                   \
  case D:                                                                                \
    return general<D>(zq, zd, l, gp, oq, od, p, m, n_cols, row_off, n_chunks, chunk, gs, \
                      st, kernels);
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
