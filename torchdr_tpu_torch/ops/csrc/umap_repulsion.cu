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
// float32. The sums are accumulated in double.
//
// Bound: per call the kernel reads Z, w and the (S, d) negative block and
// writes (n, d): about 1.2 MB at n = 60,000, d = 2, under a microsecond of
// memory time. The work is n * S pairs (30.7 M on the UMAP path), each with
// a log, an exp and a divide, so it is bound by operations (the
// special-function units and float32 issue) or, at this size, by launch
// latency. The design keeps every pair in registers: each thread owns one
// row, the block stages the negatives' coordinates and ids in shared memory
// (tiles of kTile), and no (n, S) intermediate exists anywhere. The
// operation bound at n = 60,000, S = 512, d = 2 is 9.2 us (67 TFLOP/s
// float32); on an H100 80GB HBM3 at 700 W the kernel takes 0.124 ms
// (chip_smoke.py, PERF.md): one row per thread leaves the SMs short of
// warps to hide the exp/log latency, the first thing to change.
//
// Built with -fmad=false so every product and sum is rounded as the plain
// PyTorch version rounds it (one operation at a time); the two then agree
// to the last bits of the exp/log.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

template <int D>
__global__ void __launch_bounds__(kThreads)
repulsion_kernel(const float* __restrict__ Z, const float* __restrict__ Zneg,
                 const long long* __restrict__ neg_ids,
                 const float* __restrict__ w, float* __restrict__ out, int n,
                 int S, float a, float b, float eps) {
  __shared__ float zs[D][kTile];
  __shared__ long long ids[kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;  // the ragged last tile: no padding of n
  float zi[D];
  double acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    zi[c] = live ? Z[static_cast<size_t>(i) * D + c] : 0.0f;
    acc[c] = 0.0;
  }
  const float two_b = -2.0f * b;

  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int len = min(kTile, S - s0);
    for (int t = threadIdx.x; t < len; t += kThreads) {
      ids[t] = neg_ids[s0 + t];
#pragma unroll
      for (int c = 0; c < D; ++c) zs[c][t] = Zneg[static_cast<size_t>(s0 + t) * D + c];
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < len; ++t) {
        float diff[D];
        float dist = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          diff[c] = zi[c] - zs[c][t];
          dist = dist + diff[c] * diff[c];
        }
        const float tpow = expf(b * logf(fmaxf(dist, 1e-30f)));  // D^b
        float coef = two_b / ((dist + eps) * (1.0f + a * tpow));
        if (ids[t] == i) coef = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] += static_cast<double>(coef * diff[c]);
      }
    }
    __syncthreads();
  }
  if (live) {
    const float wi = w[i];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float g = static_cast<float>(acc[c]) * wi;
      out[static_cast<size_t>(i) * D + c] = fminf(fmaxf(g, -4.0f), 4.0f);
    }
  }
}

template <int D>
void launch(const float* Z, const float* Zneg, const long long* neg_ids,
            const float* w, float* out, int n, int S, float a, float b,
            float eps, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  repulsion_kernel<D><<<blocks, kThreads, 0, stream>>>(Z, Zneg, neg_ids, w, out,
                                                       n, S, a, b, eps);
}

}  // namespace

// C interface, loaded with ctypes. Z (n, d), Zneg (S, d), w (n,) and out
// (n, d) are contiguous float32 on the device; neg_ids (S,) int64. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int umap_shared_repulsion(const void* Z, const void* Zneg,
                                     const void* neg_ids, const void* w,
                                     void* out, int n, int d, int S, float a,
                                     float b, float eps, void* stream) {
  if (n <= 0 || S <= 0) return 0;
  const auto* z = static_cast<const float*>(Z);
  const auto* zn = static_cast<const float*>(Zneg);
  const auto* ids = static_cast<const long long*>(neg_ids);
  const auto* wp = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(z, zn, ids, wp, o, n, S, a, b, eps, st); break;
    case 2: launch<2>(z, zn, ids, wp, o, n, S, a, b, eps, st); break;
    case 3: launch<3>(z, zn, ids, wp, o, n, S, a, b, eps, st); break;
    case 4: launch<4>(z, zn, ids, wp, o, n, S, a, b, eps, st); break;
    case 5: launch<5>(z, zn, ids, wp, o, n, S, a, b, eps, st); break;
    case 6: launch<6>(z, zn, ids, wp, o, n, S, a, b, eps, st); break;
    case 7: launch<7>(z, zn, ids, wp, o, n, S, a, b, eps, st); break;
    case 8: launch<8>(z, zn, ids, wp, o, n, S, a, b, eps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
