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
// weights. The j == m term is zero (z_m - z_m = 0) and is skipped, so the
// diagonal mask of the forward does not enter here.
//
// Grid, staging and accumulation as in rowlse_fwd.cu: (row tiles of
// kThreads) x (column chunks), the chunk's columns (and their u, or g and
// lse) staged in shared memory kTile at a time, each tile summed in float32
// and added to double accumulators, the chunk partials ((n_chunks, n, d)
// doubles, allocated by the wrapper) merged by a second small kernel. The
// terms of a force have both signs and partly cancel, so the error is
// relative to the sum of |terms|, not to the result.
//
// Bound: reads Z, lse and g, writes dZ: 0.24 MB at n = 10,000, d = 2. The
// term (c_mj + c_jm)(z_m - z_j) is antisymmetric, so the least work
// evaluates each of the n(n - 1)/2 unordered pairs once, adds it to row m
// and subtracts it from row j: 6d + 4 float32 operations per pair (student:
// d differences, 2d - 1 for d^2, 3 for q^2, u_m + u_j, the coefficient, d
// products and 2d accumulations; gaussian one fewer, with exp(-d^2) once),
// plus u_i and the factor 2 per row: 8.0e8 operations, 12 us at 67
// TFLOP/s, so it is bound by operations. This kernel evaluates both orders
// of each pair. Built with -fmad=false, as rowlse_fwd.cu.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;

template <int D, bool kGaussian>
__global__ void __launch_bounds__(kThreads)
rowlse_bwd_partial_kernel(const float* __restrict__ Z, const float* __restrict__ lse,
                          const float* __restrict__ g, double* __restrict__ part,
                          int n, int chunk) {
  __shared__ float zs[D][kTile];
  __shared__ float ws[kTile];  // student: u_j; gaussian: g_j
  __shared__ float ls[kTile];  // gaussian: lse_j

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(n, c0 + chunk);
  float zi[D];
  double acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    zi[c] = live ? Z[static_cast<size_t>(i) * D + c] : 0.0f;
    acc[c] = 0.0;
  }
  float ai = 0.0f, bi = 0.0f;
  if (live) {
    ai = kGaussian ? g[i] : -g[i] * expf(-lse[i]);
    bi = lse[i];
  }

  for (int t0 = c0; t0 < c1; t0 += kTile) {
    const int len = min(kTile, c1 - t0);
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const int j = t0 + t;
#pragma unroll
      for (int c = 0; c < D; ++c) zs[c][t] = Z[static_cast<size_t>(j) * D + c];
      ws[t] = kGaussian ? g[j] : -g[j] * expf(-lse[j]);
      ls[t] = lse[j];
    }
    __syncthreads();
    if (live) {
      float a[D];
#pragma unroll
      for (int c = 0; c < D; ++c) a[c] = 0.0f;
      for (int t = 0; t < len; ++t) {
        if (t0 + t == i) continue;
        float diff[D];
        float dist = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          diff[c] = zi[c] - zs[c][t];
          dist = dist + diff[c] * diff[c];
        }
        float coef;
        if (!kGaussian) {
          const float q = 1.0f / (1.0f + dist);
          coef = (ai + ws[t]) * (q * q);
        } else {
          coef = -(ai * expf(-dist - bi) + ws[t] * expf(-dist - ls[t]));
        }
#pragma unroll
        for (int c = 0; c < D; ++c) a[c] = a[c] + coef * diff[c];
      }
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] += static_cast<double>(a[c]);
    }
    __syncthreads();
  }
  if (live) {
    const size_t at = (static_cast<size_t>(blockIdx.y) * n + i) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) part[at + c] = acc[c];
  }
}

// dZ[e] = 2 * sum_c part[c][e] over the n * d entries e.
__global__ void rowlse_bwd_merge_kernel(const double* __restrict__ part,
                                        float* __restrict__ out, int nd,
                                        int n_chunks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nd) return;
  double s = 0.0;
  for (int c = 0; c < n_chunks; ++c) s += part[static_cast<size_t>(c) * nd + e];
  out[e] = static_cast<float>(2.0 * s);
}

template <int D>
void launch(const float* Z, const float* lse, const float* g, float* out,
            double* part, int n, int n_chunks, int chunk, bool gaussian,
            cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, n_chunks);
  if (gaussian) {
    rowlse_bwd_partial_kernel<D, true><<<grid, kThreads, 0, stream>>>(Z, lse, g, part, n,
                                                                       chunk);
  } else {
    rowlse_bwd_partial_kernel<D, false><<<grid, kThreads, 0, stream>>>(Z, lse, g, part, n,
                                                                        chunk);
  }
  const int nd = n * D;
  rowlse_bwd_merge_kernel<<<(nd + 255) / 256, 256, 0, stream>>>(part, out, nd, n_chunks);
}

}  // namespace

// C interface, loaded with ctypes. Z (n, d), lse (n,), g (n,) and out (n, d)
// are contiguous float32 on the device; part (n_chunks, n, d) float64 is
// scratch. Column chunk c covers columns [c * chunk, min(n, (c + 1) *
// chunk)). Returns cudaGetLastError() after the launches (0 on success).
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
    case 1: launch<1>(z, l, gp, o, p, n, n_chunks, chunk, gs, st); break;
    case 2: launch<2>(z, l, gp, o, p, n, n_chunks, chunk, gs, st); break;
    case 3: launch<3>(z, l, gp, o, p, n, n_chunks, chunk, gs, st); break;
    case 4: launch<4>(z, l, gp, o, p, n, n_chunks, chunk, gs, st); break;
    case 5: launch<5>(z, l, gp, o, p, n, n_chunks, chunk, gs, st); break;
    case 6: launch<6>(z, l, gp, o, p, n, n_chunks, chunk, gs, st); break;
    case 7: launch<7>(z, l, gp, o, p, n, n_chunks, chunk, gs, st); break;
    case 8: launch<8>(z, l, gp, o, p, n, n_chunks, chunk, gs, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
