// Row log-sum of the pairwise embedding kernel (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel torchdr_tpu/ops/pallas/reduce_kernel.py
// (rowlse_fwd_pallas_general / _fwd_kernel), through its square wrapper
// rowlse_fwd_pallas: for the embedding Z (n, d),
//
//   out_i = log sum_{j < n, j != i} k(||z_i - z_j||^2)
//
// with the student kernel k = 1 / (1 + d^2) or the gaussian kernel
// k = exp(-d^2). The diagonal term is dropped when exclude_diag is set.
//
// Student: q lies in (0, 1] and never underflows at the distances of an
// embedding, so the row sum of q is taken directly, with one log per row, as
// the TPU kernel does. Gaussian: exp(-d^2) underflows for a row whose
// nearest point is ~10 away, and the TPU kernel's direct sum then clamps at
// log(1e-30) = -69. Here each partial keeps a running (max, sum) pair, as a
// logsumexp does, so the result is exact for any spread, as the JAX
// package's XLA tier is (ops/reduce.py).
//
// Grid: (row tiles of kThreads rows) x (column chunks). One thread owns one
// row; the block stages the chunk's columns in shared memory, kTile at a
// time, and walks them. At n = 10,000 one row per thread alone gives 79
// blocks for 132 SMs; splitting the columns into chunks gives about one
// full wave of resident blocks, and a second small kernel merges each row's
// chunk partials. The partials are the only scratch (n_chunks x n doubles,
// allocated by the wrapper); no n x n array exists anywhere.
//
// Accumulation: each thread sums one staged tile (at most kTile = 256
// terms) in float32, then adds that tile sum to a double; the chunks are
// merged in double. The float32 run is short, so the relative error of a
// row sum is at most 256 * 2^-24 ~ 1.5e-5 and typically sqrt(256) * 2^-24
// ~ 1e-6, where one float32 sum over all 10k terms would reach 6e-4 and
// 6e-6; one conversion per tile keeps double arithmetic out of the inner
// loop.
//
// Bound: the kernel reads Z (n d floats) and writes n floats: 0.12 MB at
// n = 10,000, d = 2, a few hundredths of a microsecond of memory time. The
// kernel value is symmetric in (i, j), so the least work evaluates each of
// the n(n - 1)/2 unordered pairs once, in 3d + 3 float32 operations (d
// differences, d squares, d - 1 adds, then 1 + d^2 and the divide, or the
// negation and the exp, each counted as one; and the adds into rows i and
// j), plus one log per row: 4.5e8 operations, 6.7 us at 67 TFLOP/s. So it
// is bound by operations, and by the divide's and the exp's instruction
// sequences in practice. This kernel evaluates each ordered pair, as the
// TPU kernel does: twice the pair evaluations of that bound. Built with
// -fmad=false, so that the
// products round as the plain PyTorch version rounds them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;

template <int D, bool kGaussian>
__global__ void __launch_bounds__(kThreads)
rowlse_partial_kernel(const float* __restrict__ Z, double* __restrict__ part_s,
                      float* __restrict__ part_m, int n, int chunk,
                      int exclude_diag) {
  __shared__ float zs[D][kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;  // the ragged last row tile: no padding of n
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(n, c0 + chunk);
  float zi[D];
#pragma unroll
  for (int c = 0; c < D; ++c) zi[c] = live ? Z[static_cast<size_t>(i) * D + c] : 0.0f;

  double S = 0.0;    // sum of k (student) or of exp(-d^2 - M) (gaussian)
  float M = -INFINITY;  // gaussian: running max of -d^2

  for (int t0 = c0; t0 < c1; t0 += kTile) {
    const int len = min(kTile, c1 - t0);
    for (int t = threadIdx.x; t < len; t += kThreads) {
#pragma unroll
      for (int c = 0; c < D; ++c) zs[c][t] = Z[static_cast<size_t>(t0 + t) * D + c];
    }
    __syncthreads();
    if (live) {
      float s = 0.0f;
      for (int t = 0; t < len; ++t) {
        float dist = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float diff = zi[c] - zs[c][t];
          dist = dist + diff * diff;
        }
        const bool skip = exclude_diag && (t0 + t == i);
        if (!kGaussian) {
          const float q = 1.0f / (1.0f + dist);
          s += skip ? 0.0f : q;
        } else if (!skip) {
          const float v = -dist;
          if (v > M) {  // new max: rescale what was summed so far
            const float scale = expf(M - v);
            s = s * scale + 1.0f;
            S *= static_cast<double>(scale);
            M = v;
          } else {
            s += expf(v - M);
          }
        }
      }
      S += static_cast<double>(s);
    }
    __syncthreads();
  }
  if (live) {
    const size_t at = static_cast<size_t>(blockIdx.y) * n + i;
    part_s[at] = S;
    if (kGaussian) part_m[at] = M;
  }
}

// out_i = log(sum_c S_ci) (student), or M_i + log(sum_c S_ci exp(M_ci - M_i))
// with M_i = max_c M_ci (gaussian); -inf for a row with no term.
template <bool kGaussian>
__global__ void rowlse_merge_kernel(const double* __restrict__ part_s,
                                    const float* __restrict__ part_m,
                                    float* __restrict__ out, int n,
                                    int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double S = 0.0;
  if (!kGaussian) {
    for (int c = 0; c < n_chunks; ++c) S += part_s[static_cast<size_t>(c) * n + i];
    out[i] = static_cast<float>(log(S));
    return;
  }
  float M = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) M = fmaxf(M, part_m[static_cast<size_t>(c) * n + i]);
  if (M == -INFINITY) {
    out[i] = -INFINITY;
    return;
  }
  for (int c = 0; c < n_chunks; ++c) {
    const size_t at = static_cast<size_t>(c) * n + i;
    S += part_s[at] * exp(static_cast<double>(part_m[at]) - static_cast<double>(M));
  }
  out[i] = static_cast<float>(static_cast<double>(M) + log(S));
}

template <int D>
void launch(const float* Z, float* out, double* part_s, float* part_m, int n,
            int n_chunks, int chunk, bool gaussian, int exclude_diag,
            cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, n_chunks);
  const int merge_blocks = (n + 255) / 256;
  if (gaussian) {
    rowlse_partial_kernel<D, true><<<grid, kThreads, 0, stream>>>(
        Z, part_s, part_m, n, chunk, exclude_diag);
    rowlse_merge_kernel<true><<<merge_blocks, 256, 0, stream>>>(part_s, part_m, out, n,
                                                               n_chunks);
  } else {
    rowlse_partial_kernel<D, false><<<grid, kThreads, 0, stream>>>(
        Z, part_s, part_m, n, chunk, exclude_diag);
    rowlse_merge_kernel<false><<<merge_blocks, 256, 0, stream>>>(part_s, part_m, out, n,
                                                                n_chunks);
  }
}

}  // namespace

// C interface, loaded with ctypes. Z (n, d) and out (n,) are contiguous
// float32 on the device; part_s (n_chunks, n) float64 and part_m
// (n_chunks, n) float32 are scratch. Column chunk c covers columns
// [c * chunk, min(n, (c + 1) * chunk)). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int rowlse_fwd(const void* Z, void* out, void* part_s, void* part_m,
                          int n, int d, int n_chunks, int chunk, int gaussian,
                          int exclude_diag, void* stream) {
  if (n <= 0) return 0;
  if (n_chunks <= 0 || chunk <= 0 || static_cast<long long>(n_chunks) * chunk < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* z = static_cast<const float*>(Z);
  auto* o = static_cast<float*>(out);
  auto* ps = static_cast<double*>(part_s);
  auto* pm = static_cast<float*>(part_m);
  const bool g = gaussian != 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(z, o, ps, pm, n, n_chunks, chunk, g, exclude_diag, st); break;
    case 2: launch<2>(z, o, ps, pm, n, n_chunks, chunk, g, exclude_diag, st); break;
    case 3: launch<3>(z, o, ps, pm, n, n_chunks, chunk, g, exclude_diag, st); break;
    case 4: launch<4>(z, o, ps, pm, n, n_chunks, chunk, g, exclude_diag, st); break;
    case 5: launch<5>(z, o, ps, pm, n, n_chunks, chunk, g, exclude_diag, st); break;
    case 6: launch<6>(z, o, ps, pm, n, n_chunks, chunk, g, exclude_diag, st); break;
    case 7: launch<7>(z, o, ps, pm, n, n_chunks, chunk, g, exclude_diag, st); break;
    case 8: launch<8>(z, o, ps, pm, n, n_chunks, chunk, g, exclude_diag, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
