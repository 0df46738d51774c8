// Shared-negative UMAP repulsion gradient (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel torchdr_tpu/ops/pallas/umap_kernel.py
// (fused_shared_repulsion / _repulsion_kernel). For every row i of the
// embedding Z (n, d) and one shared sample of S negatives:
//
//   D_is   = sum_c (z_ic - z_sc)^2                    (direct difference)
//   coef   = -2b / ((D_is + eps) (1 + a D_is^b)),  0 where s == i
//   grad_i = clip(w_i * sum_s coef_is (z_i - z_s), -4, 4)
//
// sum_s coef (z_i - z_s) equals the TPU kernel's (sum_s coef) z_i -
// sum_s coef z_s, without its cancellation: a near-collision gives
// |coef| ~ 2b/eps ~ 1.8e3, and the two large products then cancel in
// float32.
//
// Bound. Per call the kernel reads Z, w and the ids and writes (n, d): about
// 1.2 MB at n = 60,000, d = 2, under a microsecond of memory time. The work
// is n * S pairs (30.7 M on the UMAP path) of 5d + 10 float32 operations,
// 9.2 us at 67 TFLOP/s, so it is bound by operations. D^b needs a logarithm
// and an exponential and the quotient a reciprocal, each a result of the
// special-function unit, which gives 16 per clock per SM: the 2.5 per pair
// of this design are 18 us at 132 SMs and 1.98 GHz, and that, not the
// 9.2 us, is its floor. On an H100 80GB HBM3 at 700 W the kernel takes 28 us
// there (36 us at d = 3) and 0.363 ms at n = 1,000,000, 84 % of the floor
// (chip_smoke.py, PERF.md); the design it replaced (one row per thread,
// logf, expf, an IEEE divide and a float64 add per pair: 81.5 instructions a
// pair) took 0.120 and 1.354 ms.
//
// What the design does about it: it spends one special-function result on
// each function and keeps that unit fed, at 14.6 instructions a pair.
//
// - D^b = ex2(b lg2 D) by lg2.approx.ftz and ex2.approx.ftz, the quotient
//   by rcp.approx.ftz (inline PTX, one instruction each), where logf, expf
//   and the IEEE divide are ten to twenty instructions around the same
//   result (2.1 to 2.4 times the kernel's time). lg2(0) = -inf gives
//   D^b = 0 with no clamp of D. The constant -2b multiplies the finished
//   sum, not each term.
// - One reciprocal for two negatives, (1/x0, 1/x1) = (x1, x0) rcp(x0 x1)
//   with x = (D + eps)(1 + a D^b): 10 % faster. x is at least eps, and the
//   product overflows only beyond |z| ~ 1e4 at d = 8 (3e4 at d = 2), where
//   both terms then count as 0; their true size there is under 1e-13.
// - A row's S negatives are split across `lanes` neighbouring lanes of a warp
//   (a power of two up to 32, chosen by the wrapper from n and S), each of
//   which owns the same kRows rows and walks its share kUnroll negatives at
//   a time; the lanes' partial sums are merged by __shfl_xor_sync at the
//   end: no atomics, no second kernel. A thread has kRows * kUnroll
//   independent chains, and the grid fills the card at any n: with one row
//   per thread and all S in sequence the kernel is 1.2 to 1.4 times slower
//   at S = 512 and 5.7 times at n = 10,000, S = 2048.
// - Float32 sums over a run of kChunk = 16 negatives per lane, then float64:
//   one conversion per run and coordinate, not per pair. The terms
//   coef (z_i - z_s) carry no cancellation, but a negative at D ~ eps from
//   its row gives one term of up to b / sqrt(eps) = 28, and each term added
//   after it in the same float32 run is rounded at ulp(28) = 1.9e-6: runs
//   of 64 were 5 % faster and 2.6 times as far from a float64 evaluation as
//   the plain version is, runs of 16 are 2.0 times (chip_smoke.py holds it
//   to 3).
// - No id test for eps > 0: the negative is read from Z by its id, so at
//   s == i the difference is 0 bit for bit, coef = 1/eps is finite, and
//   the term is 0 without a compare (13 % faster). The instantiation with
//   the test (kMask) is taken only for eps <= 0, where coef at D = 0 is
//   infinite.
// - The negatives are gathered from Z inside the kernel and staged in shared
//   memory once per block, each as one aligned record (8 bytes at d = 2, 16
//   at d = 3 and 4), so that a lane's kUnroll negatives are two to four
//   vector loads that serve kRows rows each.
// - Every product-and-sum is a fused multiply-add written by hand (fmaf):
//   the file is compiled with -fmad=false as the other sources are.
// - kBlocksPerSM = 6 blocks are resident by construction: the launch bounds
//   cap the registers at 80 (no spill) and kMaxStaged the staged bytes (a
//   longer sample is staged in tiles). The grid is one block per row tile,
//   which the card schedules as places free up: a grid of one resident wave
//   whose blocks walk the tiles was up to 9 % slower (n = 1,000,000).
//
// Tensor cores and TMA are not the tools here: the contraction depth is
// d <= 8 and the cost of a pair is its special functions, not the
// distance; the whole staged block is a few KB.
//
// Beyond |z| ~ 1e9, (D + eps)(1 + a D^b) is itself infinite; a paired
// reciprocal then gives NaN where the plain version gives a zero term. The
// gradient is clipped to 4 a step, so no fit reaches it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// Blocks an SM holds at once: the launch bounds keep the registers, and
// kMaxStaged the shared memory (227 KB per SM, 1 KB of it reserved per
// block), within what that many blocks need.
constexpr int kBlocksPerSM = 6;
constexpr size_t kMaxStaged = 227 * 1024 / kBlocksPerSM - 1024;
constexpr int kChunk = 16;  // longest float32 run of one accumulator

template <int D>
struct Shape {
  static constexpr int kRows = D <= 4 ? 2 : 1;    // rows a thread owns
  static constexpr int kUnroll = D <= 2 ? 8 : 4;  // negatives a lane takes per step
  // floats of one staged negative: d, padded to an aligned vector
  static constexpr int kRec = D == 1 ? 1 : D == 2 ? 2 : D <= 4 ? 4 : 8;
};

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One staged negative into registers, by the widest aligned loads.
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

struct Consts {
  float a, b, eps;
};

// diff = z_i - z_s and x = (D + eps)(1 + a D^b) of one pair: coef = -2b / x.
template <int D>
__device__ __forceinline__ float pair_x(const float (&zi)[D], const float* zs, const Consts& k,
                                        float (&diff)[D]) {
  diff[0] = zi[0] - zs[0];
  float dist = diff[0] * diff[0];
#pragma unroll
  for (int c = 1; c < D; ++c) {
    diff[c] = zi[c] - zs[c];
    dist = fmaf(diff[c], diff[c], dist);
  }
  const float tpow = ex2_approx(k.b * lg2_approx(dist));  // D^b; 0 at D = 0
  return (dist + k.eps) * fmaf(k.a, tpow, 1.0f);
}

// G staged negatives, starting at recs (position t of the staged tile),
// against the thread's rows.
template <int D, int G, bool kMask>
__device__ __forceinline__ void pair_group(const float* recs, const int* ids, int t,
                                           const float (&zi)[Shape<D>::kRows][D],
                                           const int (&row)[Shape<D>::kRows], const Consts& k,
                                           float (&acc)[Shape<D>::kRows][D]) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  float zs[G][P];
#pragma unroll
  for (int u = 0; u < G; ++u) load_record<P>(recs + u * P, zs[u]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (!kMask && G % 2 == 0) {
#pragma unroll
      for (int u = 0; u < G; u += 2) {
        float d0[D], d1[D];
        const float x0 = pair_x<D>(zi[r], zs[u], k, d0);
        const float x1 = pair_x<D>(zi[r], zs[u + 1], k, d1);
        // (1/x0, 1/x1) = (x1, x0) / (x0 x1): one reciprocal for two pairs
        const float inv = rcp_approx(x0 * x1);
        const float c0 = inv * x1, c1 = inv * x0;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[r][c] = fmaf(c1, d1[c], fmaf(c0, d0[c], acc[r][c]));
      }
    } else {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float diff[D];
        float coef = rcp_approx(pair_x<D>(zi[r], zs[u], k, diff));
        if (kMask) coef = (ids[t + u] == row[r]) ? 0.0f : coef;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[r][c] = fmaf(coef, diff[c], acc[r][c]);
      }
    }
  }
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
repulsion_kernel(const float* __restrict__ Z, const long long* __restrict__ neg_ids,
                 const float* __restrict__ w, float* __restrict__ out, int row0, int rows, int S,
                 int s_tile, int lanes, float a, float b, float eps) {
  constexpr int R = Shape<D>::kRows;
  constexpr int P = Shape<D>::kRec;
  constexpr int kUnroll = Shape<D>::kUnroll;
  extern __shared__ float4 staged[];
  float* recs = reinterpret_cast<float*>(staged);
  int* ids = reinterpret_cast<int*>(recs + static_cast<size_t>(s_tile) * P);  // kMask only

  const Consts k{a, b, eps};
  const int lane = threadIdx.x & (lanes - 1);  // the thread's share of the negatives
  const int group = threadIdx.x / lanes;       // its rows' place in the block's tile
  const int groups = kThreads / lanes;

  // rows [row0, end) of Z; the ragged last tile: rows >= end are computed and not written
  const int end = row0 + rows;
  int row[R];
  float zi[R][D];
  double sum[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = row0 + blockIdx.x * (R * groups) + r * groups + group;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      zi[r][c] = row[r] < end ? Z[static_cast<size_t>(row[r]) * D + c] : 0.0f;
      sum[r][c] = 0.0;
    }
  }

  for (int s0 = 0; s0 < S; s0 += s_tile) {
    const int len = min(s_tile, S - s0);
    if (s0 > 0) __syncthreads();  // the tile before this one has been read
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const long long id = neg_ids[s0 + t];
      const float* src = Z + static_cast<size_t>(id) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) recs[t * P + c] = src[c];
      if (kMask) ids[t] = static_cast<int>(id);
    }
    __syncthreads();

    // runs of kChunk negatives per lane: float32 sums, added to the doubles
    for (int base = 0; base < len; base += lanes * kChunk) {
      const int stop = min(len, base + lanes * kChunk);
      float acc[R][D];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < D; ++c) acc[r][c] = 0.0f;
      int t = base + lane * kUnroll;
      for (; t + kUnroll <= stop; t += lanes * kUnroll)
        pair_group<D, kUnroll, kMask>(recs + t * P, ids, t, zi, row, k, acc);
      for (; t < stop; ++t)  // the one lane whose last step is ragged
        pair_group<D, 1, kMask>(recs + t * P, ids, t, zi, row, k, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < D; ++c) sum[r][c] += static_cast<double>(acc[r][c]);
    }
  }

  // merge the lanes that share these rows; lane 0 of each writes
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      double v = sum[r][c];
      for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      sum[r][c] = v;
    }
    if (lane == 0 && row[r] < end) {
      const int i = row[r] - row0;  // the row's place in w and out
      const double scale = -2.0 * static_cast<double>(b) * static_cast<double>(w[i]);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float g = static_cast<float>(sum[r][c] * scale);
        out[static_cast<size_t>(i) * D + c] = fminf(fmaxf(g, -4.0f), 4.0f);
      }
    }
  }
}

template <int D>
int launch(const float* Z, const long long* neg_ids, const float* w, float* out, int row0,
           int rows, int S, int s_tile, int lanes, float a, float b, float eps,
           cudaStream_t stream) {
  const bool mask = !(eps > 0.0f);
  const int tile_rows = Shape<D>::kRows * kThreads / lanes;
  const int blocks = (rows + tile_rows - 1) / tile_rows;
  const size_t bytes =
      static_cast<size_t>(s_tile) * (Shape<D>::kRec * sizeof(float) + (mask ? sizeof(int) : 0));
  if (bytes > kMaxStaged) return static_cast<int>(cudaErrorInvalidValue);
  if (mask)
    repulsion_kernel<D, true><<<blocks, kThreads, bytes, stream>>>(
        Z, neg_ids, w, out, row0, rows, S, s_tile, lanes, a, b, eps);
  else
    repulsion_kernel<D, false><<<blocks, kThreads, bytes, stream>>>(
        Z, neg_ids, w, out, row0, rows, S, s_tile, lanes, a, b, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. Z (n, d) is contiguous float32 on the
// device, neg_ids (S,) int64 with every id in [0, n). The kernel computes rows
// [row0, row0 + rows) of Z, each against the whole sample gathered from all
// of Z: w (rows,) and out (rows, d), contiguous float32, hold those rows (a
// shard's rows of a mesh; (0, n) is the whole embedding). A row's sum does
// not depend on the range it is computed in: the same `lanes` give the same
// bits. `lanes` (a power of two up to 32) share a row's negatives, so a block
// takes kRows * kThreads / lanes rows, and the sample is staged s_tile
// negatives at a time (at most kMaxStaged bytes, with the ids that eps <= 0
// adds). Returns the first CUDA error (0 on success).
extern "C" int umap_shared_repulsion(const void* Z, const void* neg_ids, const void* w, void* out,
                                     int row0, int rows, int d, int S, int s_tile, int lanes,
                                     float a, float b, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (row0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || s_tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* z = static_cast<const float*>(Z);
  const auto* ids = static_cast<const long long*>(neg_ids);
  const auto* wp = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(z, ids, wp, o, row0, rows, S, s_tile, lanes, a, b, eps, st);
    case 2: return launch<2>(z, ids, wp, o, row0, rows, S, s_tile, lanes, a, b, eps, st);
    case 3: return launch<3>(z, ids, wp, o, row0, rows, S, s_tile, lanes, a, b, eps, st);
    case 4: return launch<4>(z, ids, wp, o, row0, rows, S, s_tile, lanes, a, b, eps, st);
    case 5: return launch<5>(z, ids, wp, o, row0, rows, S, s_tile, lanes, a, b, eps, st);
    case 6: return launch<6>(z, ids, wp, o, row0, rows, S, s_tile, lanes, a, b, eps, st);
    case 7: return launch<7>(z, ids, wp, o, row0, rows, S, s_tile, lanes, a, b, eps, st);
    case 8: return launch<8>(z, ids, wp, o, row0, rows, S, s_tile, lanes, a, b, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
