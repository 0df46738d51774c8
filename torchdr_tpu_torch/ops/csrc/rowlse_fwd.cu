// Row log-sum of the pairwise embedding kernel (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel torchdr_tpu/ops/pallas/reduce_kernel.py
// (rowlse_fwd_pallas_general / _fwd_kernel), in its square form through
// the wrapper rowlse_fwd_pallas: for the embedding Z (n, d),
//
//   out_i = log sum_{j < n, j != i} k(||z_i - z_j||^2)
//
// with the student kernel k = 1 / (1 + d^2) or the gaussian kernel
// k = exp(-d^2). The diagonal term is dropped when exclude_diag is set.
//
// The general form (entry point rowlse_fwd_general) takes a query shard:
// m rows of Zq whose global ids are row_off + i, against the first n_cols
// rows of Zdb, and drops the term whose column id equals the row's global
// id. The wrapper narrows m and n_cols to the rows and columns whose global
// ids lie below n_total, and fills the rows past it itself. Its kernel
// (rowlse_shard_kernel) is the square one with the row offset, two inputs
// and the two counts; both share the tile loop (pair_tile, pair_group). With
// a shard of m << n rows (m = 2,500 of n = 10,000 on a 4-way mesh) the grid
// has fewer row tiles and the wrapper cuts the columns into more chunks, to
// keep whole waves. Two things differ from the square form:
//
// - Gaussian: each exp2 is issued against its row's current shift as soon
//   as its d^2 is known (kEager), each row's least d^2 kept alongside, and
//   one test of the thread's rows against move_below follows a group; a
//   row whose reference moves (rare after its first group, which keeps the
//   serial order) sums the group again against the new shift. The serial
//   order made every exp2 of a group wait on its row's fminf chain and
//   branch: 2.1x the one-exp2-a-pair floor at 12,500 x 50,000 (PERF.md
//   section 6). The terms, and the overflow argument below, are those of
//   the serial order.
// - The merge takes a warp a row (rowlse_shard_merge_kernel): with many
//   chunks of few rows, a thread a row waited on its chunks one by one.
// - Student, where the caller's rows are the database's rows row_off ...
//   row_off + m - 1 and the wrapper's rule (reduce_kernel.k2_general_grid)
//   takes it (kShared): the shard's own m x m block evaluates each unordered
//   pair once. A block of 32 own columns is walked as the general K3 walks
//   its columns (rowlse_bwd.cu: lane l takes column (l + t) mod 32 at step
//   t, the column's running sum passed one lane down), a pair of rows
//   sharing one reciprocal; the pair's value goes to its row and to its
//   column. Blocks of 32 columns wholly below the row tile are skipped (the
//   transposed block counts them), those above take no mask. Column sums
//   are added over the warps in order and written per (row tile, own
//   column); the merge adds them to the rows' sums. About 8 instructions
//   a pair (a step's arithmetic, one shuffle and one load for 4 pairs), for
//   the two orders the plain loop pays 12.8 for. The rule takes
//   it only where the grid has three waves or more: the skipped blocks free
//   their slots to later waves, while in one wave the heavier blocks set
//   the time (PERF.md section 6: 10 % faster at 12,500 x 50,000, 40 % slower
//   at 2,500 x 10,000). The gaussian mode keeps both orders: a term's
//   value is relative to its row's shift, so a column would need one more
//   exp2.
//
// The square form's symmetric walk (student, kSym of rowlse_partial_kernel
// and rowlse_merge_kernel), which the wrapper's rule
// (reduce_kernel.square_grid) takes for the student kernel while its
// scratch stays within 1 GiB (n up to 217,885 at d = 2 on 132 SMs), in
// three waves of chunks of 32-column blocks: the square form
// is its own shard, so every chunk is walked as own_block walks the shard's
// own block, each unordered pair (i, j), i < j, once, its value added to
// row i in registers and to column j through the running column sums. A
// block of 32 columns wholly below the row tile is skipped, and a grid
// block whose chunk lies wholly below its row tile returns at once and
// writes nothing; the merge adds row i's sums over the chunks that reach
// its tile, then its column sums over the row tiles that reach its chunk,
// in that order, so a call repeats bit for bit. Staging: each block of 32
// columns twice and the warps' column sums, 32 bytes a column at d = 2
// (chunks of 1,152). Scratch: (n_chunks + row tiles) x n doubles, 0.111 GB
// at n = 70,000 (61 chunks, 137 row tiles), of which the merge reads the
// live half. 1.7x fewer instructions a pair than both orders (7.5 against
// 12.8); at n = 70,000 the call took 0.76 ms against 1.10 (an H100 80GB
// HBM3 at 700 W, PERF.md section 6).
//
// Bound. The kernel reads Z (n d floats) and writes n floats: 0.12 MB at
// n = 10,000, d = 2, a few hundredths of a microsecond of memory time. The
// kernel value is symmetric in (i, j), so the least work evaluates each of
// the n(n - 1)/2 unordered pairs once, in 3d + 3 float32 operations, plus one
// log per row: 4.5e8 operations, 6.7 us at 67 TFLOP/s. So it is bound by
// operations. This kernel evaluates each ordered pair, and a kernel value
// needs the special-function unit (a reciprocal or an exp2), which gives 16
// results per clock per SM: one call per ordered pair is 24 us for 1.0e8
// pairs at 132 SMs and 1.98 GHz, and that, not the 6.7 us, is the floor of
// such a design. The student mode here makes one call per two pairs (12 us)
// and is bound by instruction issue instead: 6.4 instructions per pair at
// d = 2, four warp instructions per clock per SM. The symmetric walk (above)
// evaluates each unordered pair once, in 7.5 instructions at d = 2.
//
// What the design does about it: it spends as few issue slots and
// special-function calls per pair as it can.
//
// - A register tile per thread. A thread owns kRows rows (4 for d <= 4,
//   else 2), kThreads apart, and walks the staged columns kUnroll = 8 at a
//   time: one shared-memory load (a column is one aligned record, an LDS.64
//   at d = 2, which the compiler pairs into LDS.128) serves kRows pairs,
//   and kRows * kUnroll independent chains hide the special-function
//   unit's latency.
// - Student: a = 1 + d^2 by d fused multiply-adds, and one rcp.approx.ftz
//   (1 ulp) for two columns, 1/a0 + 1/a1 = (a0 + a1) rcp(a0 a1), in place
//   of two IEEE divides (each a reciprocal, Newton steps and a slow path).
//   The product a0 a1 overflows to a zero term only beyond d^2 ~ 1e19, and
//   each term keeps ~3e-7 relative error. An infinite d^2 would give NaN
//   where the plain version gives a zero term; a finite Z cannot reach it.
// - Gaussian: a reference distance per (row, chunk), kept in the log2
//   domain as the shift c = d_ref^2 * log2(e); each term is one
//   ex2.approx.ftz of fma(d^2, -log2 e, c). The reference is the least d^2
//   seen when it was last moved, and it moves (the sums rescaled by
//   2^(c_new - c_old)) only when the least d^2 of kUnroll columns (one FMNMX
//   per pair) falls more than kSlack = 44 below it: a term is then at most
//   2^63.5 and a tile's float32 sum at most 2^71.5, while the reference's
//   own term is 1, so nothing overflows and the sum never underflows as a
//   whole. A test against the running minimum itself would be taken by some
//   lane of a warp at most groups of a 371-column chunk; this one is taken
//   once. So a row whose every exp(-d^2) underflows keeps its exact
//   log-sum, as the JAX package's XLA tier does (ops/reduce.py) and its TPU
//   kernel does not (it clamps at log(1e-30) = -69). The shift enters the
//   result as (log2 S - c) ln 2, so its own rounding cancels; what is left
//   is log2(e) in float32, 1.3e-8 relative to d^2.
// - The file is compiled with -fmad=false as the other sources are, so
//   every fused multiply-add here is written by hand (fmaf).
// - The diagonal test is out of the inner loop: the loop over a staged tile
//   is instantiated twice, and a block takes the masked one only for the
//   tiles whose columns meet its rows.
// - The block stages its whole column chunk once, in dynamic shared memory,
//   with one __syncthreads() before the loop.
// - Grid: (row tiles of kRows * kThreads rows) x (column chunks), sized by
//   the wrapper to whole waves of kBlocksPerSM = 6 resident blocks per SM
//   and never a little over one (the blocks are equal, so a few over a wave
//   would cost a whole one). That many blocks are resident by construction:
//   the launch bounds hold the registers to 80 a thread (no spill at d = 2
//   and d = 3), and a chunk stages at most kMaxStaged bytes. Sized for 8
//   (64 registers, which spill at d = 3) the kernels ran 2 to 8 % slower,
//   sized for 4 up to 20 % slower. A second small kernel merges each
//   row's chunk partials (n_chunks x n doubles of scratch; no n x n array
//   exists anywhere). An earlier design of each unordered pair once (tile
//   pairs I <= J, row sums in registers, column sums in per-warp shared
//   memory, no lane rotation) was dropped: 17 % faster at n = 50,000 but
//   twice as slow at n = 10,000, where 512-row tiles leave 210 blocks for
//   132 SMs. The symmetric walk above is another design, with the general
//   form's lane-rotated column sums, in a grid of three waves of chunks of
//   32-column blocks, and faster at 10,000 too (PERF.md section 6).
//
// Tensor cores and TMA are not the tools here. The contraction depth of the
// gram is d <= 8, wgmma/mma on float32 inputs means TF32 (10-bit mantissa),
// which this package forbids for distances, and the cost of a pair is the
// kernel value, not the gram. The whole input is 80 KB: there is no copy
// worth a TMA descriptor.
//
// Accumulation: each thread sums one staged tile (at most kTile = 256
// terms per row) in float32, then adds that tile sum to a double; the chunks
// are merged in double. The float32 run is short, so the relative error of
// a row sum is at most 256 * 2^-24 ~ 1.5e-5 and typically sqrt(256) * 2^-24
// ~ 1e-6, where one float32 sum over all 10k terms would reach 6e-4 and
// 6e-6; one conversion per tile keeps double arithmetic out of the inner
// loop. Gaussian: squared distances beyond 1e37 count as no term.

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
constexpr float kNoTerm = 1.0e38f;   // gaussian: the reference d^2 before any term
constexpr float kSlack = 44.0f;      // gaussian: how far d^2 may fall below the reference
constexpr float kNoTermShift = 1.0e37f;  // a merged shift above this: a row with no term
constexpr int kLanes = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMergeThreads = 256;  // the general form's merge: a warp a row

template <int D>
struct Shape {
  static constexpr int kRows = D <= 4 ? 4 : 2;  // rows of the thread's register tile
  // floats of one staged column: d, padded to an aligned vector
  static constexpr int kRec = D == 1 ? 1 : D == 2 ? 2 : D <= 4 ? 4 : 8;
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

// The running state of one thread: per owned row, the float32 sum of the
// current tile, the double sum of the chunk so far and, for the gaussian
// kernel, the shift c = d_ref^2 * log2(e) and the d^2 below which the
// reference moves.
template <int R>
struct RowState {
  float s[R];
  double S[R];
  float shift[R];
  float move_below[R];
};

// d^2 of a row and a staged column, the coordinates summed in order.
template <int D, int P>
__device__ __forceinline__ float sq_dist(const float (&zi)[D], const float (&zj)[P]) {
  const float d0 = zi[0] - zj[0];
  float a = d0 * d0;
#pragma unroll
  for (int c = 1; c < D; ++c) {
    const float diff = zi[c] - zj[c];
    a = fmaf(diff, diff, a);
  }
  return a;
}

// G staged columns, starting at cols (global column j), against the
// thread's R rows. kEager (the general form's gaussian mode): every row's
// exp2s are issued against its current shift as soon as their d^2 are
// known, each row's least d^2 is kept alongside, and one test of the rows
// against move_below follows the group; a row whose reference moves (rare
// after its first group) sums its group again against the new shift. The
// terms are those of the serial order below, where each exp2 waits on its
// row's fminf chain and branch; a row's group is summed before it is added.
template <int D, int G, bool kGaussian, bool kDiag, bool kEager = false>
__device__ __forceinline__ void pair_group(const float* cols, int j,
                                           const float (&zi)[Shape<D>::kRows][D],
                                           const int (&row)[Shape<D>::kRows],
                                           RowState<Shape<D>::kRows>& st) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  float zj[G][P];
#pragma unroll
  for (int u = 0; u < G; ++u) load_record<P>(cols + u * P, zj[u]);
  if constexpr (kGaussian && kEager) {
    float t[R], least[R];
    bool moved = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      t[r] = 0.0f;
      least[r] = INFINITY;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float a = sq_dist<D, P>(zi[r], zj[u]);
        if (kDiag) a = (j + u == row[r]) ? INFINITY : a;
        least[r] = fminf(least[r], a);
        t[r] += ex2_approx(fmaf(a, -kLog2e, st.shift[r]));
      }
      moved |= least[r] < st.move_below[r];
    }
    if (moved) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (least[r] < st.move_below[r]) {  // move the reference, sum the group again
          const float shift = least[r] * kLog2e;
          const float scale = ex2_approx(shift - st.shift[r]);
          st.s[r] *= scale;
          st.S[r] *= static_cast<double>(scale);
          st.shift[r] = shift;
          st.move_below[r] = least[r] - kSlack;
          t[r] = 0.0f;
#pragma unroll
          for (int u = 0; u < G; ++u) {
            float a = sq_dist<D, P>(zi[r], zj[u]);
            if (kDiag) a = (j + u == row[r]) ? INFINITY : a;
            t[r] += ex2_approx(fmaf(a, -kLog2e, shift));
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) st.s[r] += t[r];
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!kGaussian && !kDiag && G % 2 == 0) {
#pragma unroll
      for (int u = 0; u < G; u += 2) {
        float a0 = 1.0f, a1 = 1.0f;  // 1 + d^2 of two columns
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float d0 = zi[r][c] - zj[u][c];
          const float d1 = zi[r][c] - zj[u + 1][c];
          a0 = fmaf(d0, d0, a0);
          a1 = fmaf(d1, d1, a1);
        }
        // 1/a0 + 1/a1 = (a0 + a1) / (a0 a1): one reciprocal for two pairs
        st.s[r] = fmaf(a0 + a1, rcp_approx(a0 * a1), st.s[r]);
      }
    } else if (!kGaussian) {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float a = 1.0f;  // 1 + d^2
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float diff = zi[r][c] - zj[u][c];
          a = fmaf(diff, diff, a);
        }
        float q = rcp_approx(a);
        if (kDiag) q = (j + u == row[r]) ? 0.0f : q;
        st.s[r] += q;
      }
    } else {
      float dist[G];
      float m = INFINITY;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float d0 = zi[r][0] - zj[u][0];
        float a = d0 * d0;
#pragma unroll
        for (int c = 1; c < D; ++c) {
          const float diff = zi[r][c] - zj[u][c];
          a = fmaf(diff, diff, a);
        }
        if (kDiag) a = (j + u == row[r]) ? INFINITY : a;
        dist[u] = a;
        m = fminf(m, a);
      }
      if (m < st.move_below[r]) {  // move the reference: rescale what was summed so far
        const float shift = m * kLog2e;
        const float scale = ex2_approx(shift - st.shift[r]);
        st.s[r] *= scale;
        st.S[r] *= static_cast<double>(scale);
        st.shift[r] = shift;
        st.move_below[r] = m - kSlack;
      }
#pragma unroll
      for (int u = 0; u < G; ++u) st.s[r] += ex2_approx(fmaf(dist[u], -kLog2e, st.shift[r]));
    }
  }
}

// One staged tile of len <= kTile columns: a float32 run per row, added to
// the double sums at its end. With kEager, the chunk's first group (first)
// takes the serial order: there every row's reference moves from kNoTerm.
template <int D, bool kGaussian, bool kDiag, bool kEager = false>
__device__ __forceinline__ void pair_tile(const float* cols, int j0, int len,
                                          const float (&zi)[Shape<D>::kRows][D],
                                          const int (&row)[Shape<D>::kRows],
                                          RowState<Shape<D>::kRows>& st, bool first = false) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  int t = 0;
  if (kEager && first && kUnroll <= len) {
    pair_group<D, kUnroll, kGaussian, kDiag>(cols, j0, zi, row, st);
    t = kUnroll;
  }
  for (; t + kUnroll <= len; t += kUnroll)
    pair_group<D, kUnroll, kGaussian, kDiag, kEager>(cols + t * P, j0 + t, zi, row, st);
  for (; t < len; ++t) pair_group<D, 1, kGaussian, kDiag>(cols + t * P, j0 + t, zi, row, st);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    st.S[r] += static_cast<double>(st.s[r]);
    st.s[r] = 0.0f;
  }
}

// The shard's own columns, each unordered pair once (student, kShared): a
// block of 32 own columns (local ids jl0 + k, k < live) against the
// thread's R rows (local ids rl), in 32 steps as rowlse_bwd.cu's general
// kernel walks them: the lane takes column k = (lane + t) mod 32 and holds
// its running sum, passed one lane down after the step. Two rows share one
// reciprocal: 1/a0 = a1 rcp(a0 a1), 1/a1 = a0 rcp(a0 a1), and the column
// takes their sum (a0 + a1) rcp(a0 a1). Unmasked: every column lies above
// every row. kMask: a pair counts for its row where jl > i (or jl == i and
// the diagonal is kept) and for its column where jl > i; padding neither.
template <int D, bool kMask>
__device__ __forceinline__ float own_block(const float* zb, int jl0, int live, int lane,
                                           const float (&zi)[Shape<D>::kRows][D],
                                           const int (&rl)[Shape<D>::kRows], bool keep_diag,
                                           RowState<Shape<D>::kRows>& st) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  const int from = (lane + 1) & (kLanes - 1);
  float ca = 0.0f;
#pragma unroll
  for (int t = 0; t < kLanes; ++t) {
    float zj[P];
    load_record<P>(zb + t * P, zj);
    const int k = (lane + t) & (kLanes - 1);
    const int jl = jl0 + k;
#pragma unroll
    for (int r = 0; r < R; r += 2) {
      float a0 = 1.0f, a1 = 1.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float d0 = zi[r][c] - zj[c];
        const float d1 = zi[r + 1][c] - zj[c];
        a0 = fmaf(d0, d0, a0);
        a1 = fmaf(d1, d1, a1);
      }
      const float rc = rcp_approx(a0 * a1);
      if (!kMask) {
        st.s[r] = fmaf(a1, rc, st.s[r]);
        st.s[r + 1] = fmaf(a0, rc, st.s[r + 1]);
        ca = fmaf(a0 + a1, rc, ca);
      } else {
        // bitwise, so that the tests are predicates and not branches
        const float q0 = a1 * rc, q1 = a0 * rc;
        const bool in = k < live;
        const bool up0 = in & (jl > rl[r]), up1 = in & (jl > rl[r + 1]);
        const bool diag0 = in & keep_diag & (jl == rl[r]);
        const bool diag1 = in & keep_diag & (jl == rl[r + 1]);
        st.s[r] += (up0 | diag0) ? q0 : 0.0f;
        st.s[r + 1] += (up1 | diag1) ? q1 : 0.0f;
        ca += (up0 ? q0 : 0.0f) + (up1 ? q1 : 0.0f);
      }
    }
    ca = __shfl_sync(kFullMask, ca, from);
  }
  return ca;
}

// The square form, both orders of every pair: row tile blockIdx.x against
// column chunk blockIdx.y, each row's chunk sum (and gaussian shift) into
// part_s (part_c).
template <int D, bool kGaussian>
__device__ __forceinline__ void ordered_chunk(const float* __restrict__ Z, double* __restrict__ part_s,
                                              double* __restrict__ part_c, int n, int chunk,
                                              int exclude_diag) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  extern __shared__ float4 staged[];
  float* cols = reinterpret_cast<float*>(staged);

  const int r0 = blockIdx.x * (R * kThreads);
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(n, c0 + chunk);
  for (int t = threadIdx.x; t < c1 - c0; t += kThreads) {
#pragma unroll
    for (int c = 0; c < D; ++c) cols[t * P + c] = Z[static_cast<size_t>(c0 + t) * D + c];
  }

  int row[R];  // the ragged last row tile: rows >= n are computed and not written
  float zi[R][D];
  RowState<R> st;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = r0 + r * kThreads + threadIdx.x;
#pragma unroll
    for (int c = 0; c < D; ++c) zi[r][c] = row[r] < n ? Z[static_cast<size_t>(row[r]) * D + c] : 0.0f;
    st.s[r] = 0.0f;
    st.S[r] = 0.0;
    st.shift[r] = kNoTerm * kLog2e;
    st.move_below[r] = kNoTerm;
  }
  __syncthreads();

  for (int j0 = c0; j0 < c1; j0 += kTile) {
    const int len = min(kTile, c1 - j0);
    const float* tile = cols + (j0 - c0) * P;
    // only a tile whose columns meet the block's rows can hold a diagonal term
    if (exclude_diag && j0 < r0 + R * kThreads && r0 < j0 + len)
      pair_tile<D, kGaussian, true>(tile, j0, len, zi, row, st);
    else
      pair_tile<D, kGaussian, false>(tile, j0, len, zi, row, st);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row[r] < n) {
      const size_t at = static_cast<size_t>(blockIdx.y) * n + row[r];
      part_s[at] = st.S[r];
      if (kGaussian) part_c[at] = static_cast<double>(st.shift[r]);
    }
  }
}

// The square form's symmetric walk (student, kSym): each unordered pair
// (i, j), i < j, once. The chunk is staged as blocks of 32 columns, each
// twice (own_block's records), and walked as the general form walks the
// shard's own block: the pair's value goes to row i in registers and to
// column j through the lane-rotated running column sums. A block of 32
// columns wholly below the row tile is skipped (its pairs are counted by the
// transposed block), as is the whole chunk where every column lies below
// every row: such a block writes nothing, and the merge reads none of its
// slots. Row sums go to part_s (chunk, row), column sums, added over the
// warps in order, to part_col (row tile, column).
template <int D>
__device__ __forceinline__ void symmetric_chunk(const float* __restrict__ Z,
                                                double* __restrict__ part_s,
                                                double* __restrict__ part_col, int n, int chunk,
                                                int exclude_diag) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  const int r0 = blockIdx.x * (R * kThreads);
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(n, c0 + chunk);
  if (c1 <= r0) return;
  extern __shared__ float4 staged[];
  const int len = c1 - c0;
  const int n_blk = (len + kLanes - 1) / kLanes;
  float* dbl = reinterpret_cast<float*>(staged);  // record e of block b: column 32 b + e mod 32
  float* cs = dbl + n_blk * 2 * kLanes * P;       // [warp][column] sums
  for (int e = threadIdx.x; e < n_blk * 2 * kLanes; e += kThreads) {
    const int col = (e / (2 * kLanes)) * kLanes + (e & (kLanes - 1));
#pragma unroll
    for (int c = 0; c < P; ++c)
      dbl[e * P + c] = (c < D && col < len) ? Z[static_cast<size_t>(c0 + col) * D + c] : 0.0f;
  }

  int row[R];  // the ragged last row tile: rows >= n take no pair and are not written
  float zi[R][D];
  RowState<R> st;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = r0 + r * kThreads + threadIdx.x;
#pragma unroll
    for (int c = 0; c < D; ++c) zi[r][c] = row[r] < n ? Z[static_cast<size_t>(row[r]) * D + c] : 0.0f;
    st.s[r] = 0.0f;
    st.S[r] = 0.0;
  }
  __syncthreads();

  const int lane = threadIdx.x & (kLanes - 1);
  float* mine = cs + (threadIdx.x / kLanes) * (n_blk * kLanes);
  for (int b = 0; b < n_blk; ++b) {
    const int j0 = c0 + b * kLanes;
    const int live = len - b * kLanes;
    const float* zb = dbl + (b * 2 * kLanes + lane) * P;
    float ca = 0.0f;
    if (live >= kLanes && j0 > r0 + R * kThreads - 1)
      ca = own_block<D, false>(zb, j0, live, lane, zi, row, !exclude_diag, st);
    else if (j0 + kLanes - 1 >= r0)
      ca = own_block<D, true>(zb, j0, live, lane, zi, row, !exclude_diag, st);
    mine[b * kLanes + lane] = ca;
    if ((b + 1) % (kTile / kLanes) == 0 || b + 1 == n_blk) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        st.S[r] += static_cast<double>(st.s[r]);
        st.s[r] = 0.0f;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
    if (row[r] < n) part_s[static_cast<size_t>(blockIdx.y) * n + row[r]] = st.S[r];
  __syncthreads();
  for (int e = threadIdx.x; e < len; e += kThreads) {
    double sum = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / kLanes; ++w) sum += static_cast<double>(cs[w * (n_blk * kLanes) + e]);
    part_col[static_cast<size_t>(blockIdx.x) * n + c0 + e] = sum;
  }
}

// The square form's pair loop: both orders of every pair, or (kSym, student
// only) each unordered pair once. part_c holds the gaussian shifts, or with
// kSym the column sums.
template <int D, bool kGaussian, bool kSym>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
rowlse_partial_kernel(const float* __restrict__ Z, double* __restrict__ part_s,
                      double* __restrict__ part_c, int n, int chunk, int exclude_diag) {
  static_assert(!(kSym && kGaussian), "the symmetric walk is the student mode's");
  if constexpr (kSym)
    symmetric_chunk<D>(Z, part_s, part_c, n, chunk, exclude_diag);
  else
    ordered_chunk<D, kGaussian>(Z, part_s, part_c, n, chunk, exclude_diag);
}

// The general form: rows are the m rows of Zq, global ids row_off + i;
// columns the n_cols rows of Zdb, global ids j. The same tiles, staging and
// accumulation as the square kernel above, which stays a kernel of its own:
// a kernel serving both forms (the offset and the row count in registers, or
// even known to the compiler at 0) ran the square gaussian mode slower at
// n = 50,000 (PERF.md section 6).
template <int D, bool kGaussian, bool kShared>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
rowlse_shard_kernel(const float* __restrict__ Zq, const float* __restrict__ Zdb,
                    double* __restrict__ part_s, double* __restrict__ part_c,
                    double* __restrict__ part_col, int m, int n_cols, int row_off, int chunk,
                    int exclude_diag) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  extern __shared__ float4 staged[];
  float* cols = reinterpret_cast<float*>(staged);

  const int r0 = blockIdx.x * (R * kThreads);
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(n_cols, c0 + chunk);
  for (int t = threadIdx.x; t < c1 - c0; t += kThreads) {
#pragma unroll
    for (int c = 0; c < D; ++c) cols[t * P + c] = Zdb[static_cast<size_t>(c0 + t) * D + c];
  }
  // kShared: the chunk's own columns (the shard's rows), each block of 32
  // staged twice, and each warp's column sums
  const int o0 = kShared ? max(c0, min(c1, row_off)) : c1;
  const int o1 = kShared ? max(o0, min(c1, row_off + m)) : c1;
  const int own = o1 - o0;
  const int n_blk = (own + kLanes - 1) / kLanes;
  const int blk_cap = chunk / kLanes;  // blocks of 32 a chunk holds
  float* dbl = cols + chunk * P;
  float* cs = dbl + blk_cap * 2 * kLanes * P;
  if (kShared) {
    for (int e = threadIdx.x; e < n_blk * 2 * kLanes; e += kThreads) {
      const int col = (e / (2 * kLanes)) * kLanes + (e & (kLanes - 1));
#pragma unroll
      for (int c = 0; c < P; ++c)
        dbl[e * P + c] = (c < D && col < own) ? Zdb[static_cast<size_t>(o0 + col) * D + c] : 0.0f;
    }
  }

  // global row ids, which the diagonal test compares with column ids; the
  // ragged last row tile: rows >= m are computed and not written
  int row[R];
  float zi[R][D];
  RowState<R> st;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r0 + r * kThreads + threadIdx.x;
    row[r] = row_off + i;
#pragma unroll
    for (int c = 0; c < D; ++c) zi[r][c] = i < m ? Zq[static_cast<size_t>(i) * D + c] : 0.0f;
    st.s[r] = 0.0f;
    st.S[r] = 0.0;
    st.shift[r] = kNoTerm * kLog2e;
    st.move_below[r] = kNoTerm;
  }
  __syncthreads();

  const int g0 = row_off + r0;  // the block's first global row id
  // the columns outside the shard's own block (all of them without kShared)
  auto outside = [&](int lo, int hi) {
    for (int j0 = lo; j0 < hi; j0 += kTile) {
      const int len = min(kTile, hi - j0);
      const float* tile = cols + (j0 - c0) * P;
      // only a tile whose columns meet the block's global rows can hold a
      // diagonal term
      if (exclude_diag && j0 < g0 + R * kThreads && g0 < j0 + len)
        pair_tile<D, kGaussian, true, kGaussian>(tile, j0, len, zi, row, st, j0 == c0);
      else
        pair_tile<D, kGaussian, false, kGaussian>(tile, j0, len, zi, row, st, j0 == c0);
    }
  };
  outside(c0, o0);
  if (kShared && own > 0) {
    const int lane = threadIdx.x & (kLanes - 1);
    int rl[R];
#pragma unroll
    for (int r = 0; r < R; ++r) rl[r] = row[r] - row_off;
    float* mine = cs + (threadIdx.x / kLanes) * (blk_cap * kLanes);
    for (int b = 0; b < n_blk; ++b) {
      const int jl0 = o0 - row_off + b * kLanes;
      const int live = own - b * kLanes;
      const float* zb = dbl + (b * 2 * kLanes + lane) * P;
      float ca = 0.0f;  // a block wholly below the rows: its pairs are counted transposed
      if (live >= kLanes && jl0 > r0 + R * kThreads - 1)
        ca = own_block<D, false>(zb, jl0, live, lane, zi, rl, !exclude_diag, st);
      else if (live < kLanes || jl0 + kLanes - 1 >= r0)
        ca = own_block<D, true>(zb, jl0, live, lane, zi, rl, !exclude_diag, st);
      mine[b * kLanes + lane] = ca;
      if ((b + 1) % (kTile / kLanes) == 0 || b + 1 == n_blk) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          st.S[r] += static_cast<double>(st.s[r]);
          st.s[r] = 0.0f;
        }
      }
    }
  }
  outside(o1, c1);

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row[r] - row_off;
    if (i < m) {
      const size_t at = static_cast<size_t>(blockIdx.y) * m + i;
      part_s[at] = st.S[r];
      if (kGaussian) part_c[at] = static_cast<double>(st.shift[r]);
    }
  }
  if (kShared) {  // this row tile's column sums of the chunk's own columns, warps in order
    __syncthreads();
    for (int e = threadIdx.x; e < own; e += kThreads) {
      double sum = 0.0;
#pragma unroll
      for (int w = 0; w < kThreads / kLanes; ++w) sum += static_cast<double>(cs[w * (blk_cap * kLanes) + e]);
      part_col[static_cast<size_t>(blockIdx.x) * m + (o0 - row_off) + e] = sum;
    }
  }
}

// out_i = log(sum_k S_ki) (student), or, with each chunk's sum S_ki of
// 2^(c_ki - d^2 log2 e) and c_i = min_k c_ki, (log2(sum_k S_ki 2^(c_i - c_ki))
// - c_i) ln 2 (gaussian); -inf for a row with no term. kSym: the sums of the
// chunks that reach row i's tile (of `rows` rows), then the column sums of
// the row tiles that reach its chunk, in order: the slots the pair loop
// wrote, and no other.
template <bool kGaussian, bool kSym>
__global__ void rowlse_merge_kernel(const double* __restrict__ part_s,
                                    const double* __restrict__ part_c,
                                    float* __restrict__ out, int n, int n_chunks, int chunk,
                                    int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double S = 0.0;
  if (!kGaussian) {
    const int k0 = kSym ? i / rows * rows / chunk : 0;
#pragma unroll 4
    for (int k = k0; k < n_chunks; ++k) S += part_s[static_cast<size_t>(k) * n + i];
    if (kSym) {
      const int tiles = (min(n, (i / chunk + 1) * chunk) - 1) / rows + 1;
#pragma unroll 4
      for (int t = 0; t < tiles; ++t) S += part_c[static_cast<size_t>(t) * n + i];
    }
    out[i] = static_cast<float>(log(S));
    return;
  }
  double shift = INFINITY;
  for (int k = 0; k < n_chunks; ++k) shift = fmin(shift, part_c[static_cast<size_t>(k) * n + i]);
  if (shift > static_cast<double>(kNoTermShift)) {
    out[i] = -INFINITY;
    return;
  }
  for (int k = 0; k < n_chunks; ++k) {
    const size_t at = static_cast<size_t>(k) * n + i;
    S += part_s[at] * exp2(shift - part_c[at]);
  }
  out[i] = static_cast<float>(log(S) - shift * 0.6931471805599453);
}

// The general form's merge: the same function, a warp a row. Lane l takes
// chunks l, l + 32, ...; the least shift is a warp minimum (exact), and the
// lanes' sums are added by a fixed xor tree, so the result repeats bit for
// bit. A shard of few rows has many chunks, where a thread a row would wait
// on its chunks one after another.
template <bool kGaussian>
__global__ void rowlse_shard_merge_kernel(const double* __restrict__ part_s,
                                          const double* __restrict__ part_c,
                                          const double* __restrict__ part_col,
                                          float* __restrict__ out, int m, int n_chunks,
                                          int n_tiles) {
  const int i = blockIdx.x * (kMergeThreads / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x & (kLanes - 1);
  if (i >= m) return;  // the whole warp
  double shift = 0.0;
  if (kGaussian) {
    shift = INFINITY;
    for (int k = lane; k < n_chunks; k += kLanes)
      shift = fmin(shift, part_c[static_cast<size_t>(k) * m + i]);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      shift = fmin(shift, __shfl_xor_sync(kFullMask, shift, off));
    if (shift > static_cast<double>(kNoTermShift)) {
      if (lane == 0) out[i] = -INFINITY;
      return;
    }
  }
  double S = 0.0;
  for (int k = lane; k < n_chunks; k += kLanes) {
    const size_t at = static_cast<size_t>(k) * m + i;
    S += kGaussian ? part_s[at] * exp2(shift - part_c[at]) : part_s[at];
  }
  if (part_col != nullptr) {  // the shard's own pairs counted at their column
    for (int t = lane; t < n_tiles; t += kLanes) S += part_col[static_cast<size_t>(t) * m + i];
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) S += __shfl_xor_sync(kFullMask, S, off);
  if (lane == 0) out[i] = static_cast<float>(log(S) - shift * 0.6931471805599453);
}

template <int D>
int launch(const float* Zq, const float* Zdb, float* out, double* part, int m, int n_cols,
           int row_off, int n_chunks, int chunk, bool gaussian, int exclude_diag, bool shared,
           bool symmetric, cudaStream_t stream) {
  constexpr int P = Shape<D>::kRec;
  if ((shared || symmetric) && (gaussian || chunk % kLanes != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // the chunk staged once, and with `shared` its own blocks twice beside the
  // warps' column sums; with `symmetric` the blocks twice and the sums only
  const size_t staged_bytes =
      static_cast<size_t>(chunk) *
      (symmetric ? 2 * P + kThreads / kLanes : P + (shared ? 2 * P + kThreads / kLanes : 0)) *
      sizeof(float);
  if (staged_bytes > kMaxStaged) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = Shape<D>::kRows * kThreads;
  const int n_tiles = (m + rows - 1) / rows;
  const dim3 grid(n_tiles, n_chunks);
  const int merge_blocks = (m + 255) / 256;
  const int shard_merge_blocks = (m + kMergeThreads / kLanes - 1) / (kMergeThreads / kLanes);
  double* part_c = part + static_cast<size_t>(n_chunks) * m;
  double* part_col = shared ? part_c : nullptr;  // student: no shifts
  const bool square = Zq == Zdb && m == n_cols && row_off == 0 && !shared;
  if (symmetric && !square) return static_cast<int>(cudaErrorInvalidValue);
  if (gaussian) {
    if (square)
      rowlse_partial_kernel<D, true, false><<<grid, kThreads, staged_bytes, stream>>>(
          Zq, part, part_c, m, chunk, exclude_diag);
    else
      rowlse_shard_kernel<D, true, false><<<grid, kThreads, staged_bytes, stream>>>(
          Zq, Zdb, part, part_c, nullptr, m, n_cols, row_off, chunk, exclude_diag);
    if (square)
      rowlse_merge_kernel<true, false><<<merge_blocks, 256, 0, stream>>>(
          part, part_c, out, m, n_chunks, chunk, rows);
    else
      rowlse_shard_merge_kernel<true><<<shard_merge_blocks, kMergeThreads, 0, stream>>>(
          part, part_c, nullptr, out, m, n_chunks, n_tiles);
  } else if (symmetric) {  // part_c: the row tiles' column sums
    rowlse_partial_kernel<D, false, true><<<grid, kThreads, staged_bytes, stream>>>(
        Zq, part, part_c, m, chunk, exclude_diag);
    rowlse_merge_kernel<false, true><<<merge_blocks, 256, 0, stream>>>(
        part, part_c, out, m, n_chunks, chunk, rows);
  } else {
    if (square)
      rowlse_partial_kernel<D, false, false><<<grid, kThreads, staged_bytes, stream>>>(
          Zq, part, part_c, m, chunk, exclude_diag);
    else if (shared)
      rowlse_shard_kernel<D, false, true><<<grid, kThreads, staged_bytes, stream>>>(
          Zq, Zdb, part, nullptr, part_col, m, n_cols, row_off, chunk, exclude_diag);
    else
      rowlse_shard_kernel<D, false, false><<<grid, kThreads, staged_bytes, stream>>>(
          Zq, Zdb, part, part_c, nullptr, m, n_cols, row_off, chunk, exclude_diag);
    if (square)
      rowlse_merge_kernel<false, false><<<merge_blocks, 256, 0, stream>>>(
          part, part_c, out, m, n_chunks, chunk, rows);
    else
      rowlse_shard_merge_kernel<false><<<shard_merge_blocks, kMergeThreads, 0, stream>>>(
          part, part_c, part_col, out, m, n_chunks, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* Zq, const void* Zdb, void* out, void* part, int m, int n_cols,
             int row_off, int d, int n_chunks, int chunk, int gaussian, int exclude_diag,
             int shared, int symmetric, void* stream) {
  if (m <= 0) return 0;
  if (n_cols <= 0 || n_chunks <= 0 || chunk <= 0 ||
      static_cast<long long>(n_chunks) * chunk < n_cols || row_off < 0 ||
      (shared && static_cast<long long>(row_off) + m > n_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* zq = static_cast<const float*>(Zq);
  const auto* zd = static_cast<const float*>(Zdb);
  auto* o = static_cast<float*>(out);
  auto* p = static_cast<double*>(part);
  const bool g = gaussian != 0, sh = shared != 0, sy = symmetric != 0;
  auto st = static_cast<cudaStream_t>(stream);
#define TDR_LAUNCH(D)                                                                       \
  case D:                                                                                   \
    return launch<D>(zq, zd, o, p, m, n_cols, row_off, n_chunks, chunk, g, exclude_diag, sh, sy, \
                     st);
  switch (d) {
    TDR_LAUNCH(1)
    TDR_LAUNCH(2)
    TDR_LAUNCH(3)
    TDR_LAUNCH(4)
    TDR_LAUNCH(5)
    TDR_LAUNCH(6)
    TDR_LAUNCH(7)
    TDR_LAUNCH(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TDR_LAUNCH
}

}  // namespace

// C interface, loaded with ctypes. Z (n, d) and out (n,) are contiguous
// float32 on the device; part is scratch of n_chunks * n doubles (student)
// or twice that (gaussian: the sums, then the shifts). Column chunk k covers
// columns [k * chunk, min(n, (k + 1) * chunk)), and a chunk's staged columns
// must fit kMaxStaged bytes. symmetric (student only, chunk a multiple of
// 32): each unordered pair once, part then (n_chunks + row tiles) * n
// doubles, the chunks' row sums and the row tiles' column sums. Returns the
// first CUDA error (0 on success).
extern "C" int rowlse_fwd(const void* Z, void* out, void* part, int n, int d, int n_chunks,
                          int chunk, int gaussian, int exclude_diag, int symmetric,
                          void* stream) {
  return dispatch(Z, Z, out, part, n, n, 0, d, n_chunks, chunk, gaussian, exclude_diag, 0,
                  symmetric, stream);
}

// The general form: Zq (m, d) holds the rows of global ids row_off + i,
// Zdb's first n_cols rows (n_cols, d) are the columns; out (m,); part as
// above with m in place of n, and chunks over the n_cols columns. Every row
// and column passed is live: the caller leaves out those whose global id
// is at or past n_total.
extern "C" int rowlse_fwd_general(const void* Zq, const void* Zdb, void* out, void* part, int m,
                                  int n_cols, int row_off, int d, int n_chunks, int chunk,
                                  int gaussian, int exclude_diag, int shared, void* stream) {
  return dispatch(Zq, Zdb, out, part, m, n_cols, row_off, d, n_chunks, chunk, gaussian,
                  exclude_diag, shared, 0, stream);
}
