// t-SNE's and SNE's attraction over the kNN edges (A1), for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package, like the port before it, takes
// the attraction's gradient by autograd of a gather Z[NN]: on the card its
// backward is a scatter of n * k rows, which PyTorch runs as a radix sort of
// the n * k ids and a segmented sum, every step. This kernel computes the
// loss and its gradient directly, as gathers only.
//
// For the embedding Z (n, d), the kNN graph NN (n, k) with its weights
// P (n, k) (an id below 0 is a pad: it weighs 0), and the graph's transpose
// (ops/attraction.knn_transpose): each row's in-edges
// in_src[in_ptr[i] .. in_ptr[i + 1]) with their weights in_P, it writes
//
//   loss_i = sum_{j in NN(i)} P_ij phi(d_ij),          d_ij = |z_i - z_j|^2
//   grad_i = 2 sum_{j in NN(i)} P_ij phi'(d_ij) (z_i - z_j)
//          + 2 sum_{e in in(i)} in_P_e phi'(d_e) (z_i - z_src(e))
//
// with phi = log1p (student, t-SNE) or the identity (gaussian, SNE), so that
// grad = d(sum_i loss_i)/dZ: an edge i -> j pulls both of its ends, each end
// reads it once, and no row's sum is written by another.
//
// Bound. Per call it reads the ids and weights of every edge from both ends,
// in_ptr, and Z, and writes the gradient and the loss: 16 n k bytes and a
// little more, 102.8 MB at n = 70,000, k = 90, d = 2, 31 us at 3.35 TB/s.
// The arithmetic is 2 n k edges of ~5d + 4 float32 operations and a divide
// (and a log1p on the out-edges), a few microseconds. It is bound by bytes.
// Each edge also gathers its other end, z_j, from anywhere in Z: Z is 560 KB
// at 70,000 x 2 and stays in L2, but each gather of 8 bytes moves a 32-byte
// sector from L2, up to 403 MB at that shape, and these gathers set the
// pace.
//
// What the design does about it:
// - One warp a row. The lanes stride over the row's k out-edges, then over
//   its in-edges, so the ids and weights are read in whole sectors, once,
//   as streams (evict-first: they leave the L1 to Z's rows).
//   Each lane keeps kUnroll edges in flight: it loads their ids and weights,
//   then their z_j (a float2 at d = 2, through the read-only path), then
//   adds their terms, so the gathers' latency overlaps. The gathers are
//   unconditional, so that the compiler starts them together: a pad, or a
//   slot past the list's end, reads row 0 and weighs 0, which adds an exact
//   0 to the sums (Z is finite).
// - A lane adds its edges in index order and the warp sums its lanes by a
//   fixed butterfly of shuffles: two launches give the same bits. No
//   atomics and no second pass: a hub row with thousands of in-edges is a
//   longer loop for one warp among n.
// - Templated on d from 1 to 8, the widths K1, K2 and K3 take.
// - Everything is float32, as the configurations state; the exact divide
//   and log1pf, no approximate intrinsics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // a block: 8 warps, one row each
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kUnroll = 4;                 // edges a lane has in flight

template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ Z, long long j, float (&y)[D]) {
  if constexpr (D == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(Z) + j);
    y[0] = v.x;
    y[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) y[c] = __ldg(Z + j * D + c);
  }
}

// Adds the terms of the edges [begin, end) of (ids, w) that fall to this
// lane: begin + lane, then every 32nd, in that order. With kOut they are the
// row's out-edges, and each adds its share of the loss too.
template <int D, bool kGaussian, bool kOut>
__device__ __forceinline__ void add_edges(const float* __restrict__ Z, const int* __restrict__ ids,
                                          const float* __restrict__ w, long long begin,
                                          long long end, int lane, const float (&zi)[D],
                                          float (&g)[D], float& loss) {
  for (long long e0 = begin + lane; e0 < end; e0 += 32 * kUnroll) {
    int j[kUnroll];
    float p[kUnroll];
    float y[kUnroll][D];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = e0 + 32LL * u;
      const bool live = e < end;
      const int id = live ? __ldcs(ids + e) : -1;
      const float weight = live ? __ldcs(w + e) : 0.0f;
      j[u] = max(id, 0);
      p[u] = id >= 0 ? weight : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_row<D>(Z, j[u], y[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float diff[D];
      float dist = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        diff[c] = zi[c] - y[u][c];
        dist += diff[c] * diff[c];
      }
      float coef;
      if constexpr (kGaussian) {
        coef = p[u];
        if constexpr (kOut) loss += p[u] * dist;
      } else {
        coef = p[u] / (1.0f + dist);
        if constexpr (kOut) loss += p[u] * log1pf(dist);
      }
#pragma unroll
      for (int c = 0; c < D; ++c) g[c] += coef * diff[c];
    }
  }
}

template <int D, bool kGaussian>
__global__ void __launch_bounds__(kThreads) tsne_attraction_kernel(
    const float* __restrict__ Z, const int* __restrict__ nn, const float* __restrict__ P,
    const long long* __restrict__ in_ptr, const int* __restrict__ in_src,
    const float* __restrict__ in_P, float* __restrict__ grad, float* __restrict__ loss, int n,
    int k) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // the whole warp: the shuffles below see full warps
  float zi[D];
  float g[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    zi[c] = __ldg(Z + static_cast<long long>(row) * D + c);
    g[c] = 0.0f;
  }
  float l = 0.0f;
  const long long out0 = static_cast<long long>(row) * k;
  const long long in0 = __ldg(in_ptr + row), in1 = __ldg(in_ptr + row + 1);  // loaded early
  add_edges<D, kGaussian, true>(Z, nn, P, out0, out0 + k, lane, zi, g, l);
  add_edges<D, kGaussian, false>(Z, in_src, in_P, in0, in1, lane, zi, g, l);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < D; ++c) g[c] += __shfl_xor_sync(0xffffffffu, g[c], off);
    l += __shfl_xor_sync(0xffffffffu, l, off);
  }
  if (lane == 0) {
    if (grad != nullptr) {
#pragma unroll
      for (int c = 0; c < D; ++c) grad[static_cast<long long>(row) * D + c] = 2.0f * g[c];
    }
    loss[row] = l;
  }
}

template <int D>
cudaError_t launch_d(const float* Z, const int* nn, const float* P, const long long* in_ptr,
                     const int* in_src, const float* in_P, float* grad, float* loss, int n, int k,
                     bool gaussian, cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (gaussian)
    tsne_attraction_kernel<D, true><<<blocks, kThreads, 0, stream>>>(
        Z, nn, P, in_ptr, in_src, in_P, grad, loss, n, k);
  else
    tsne_attraction_kernel<D, false><<<blocks, kThreads, 0, stream>>>(
        Z, nn, P, in_ptr, in_src, in_P, grad, loss, n, k);
  return cudaGetLastError();
}

}  // namespace

// Z: (n, d) float32, contiguous, 8-byte aligned, 1 <= d <= 8; nn: (n, k)
// int32; P: (n, k) float32; in_ptr: (n + 1) int64; in_src: int32 and in_P:
// float32, in_ptr[n] each; grad: (n, d) float32 or null (not written);
// loss: (n,) float32.
extern "C" int tsne_attraction(const void* Z, const void* nn, const void* P, const void* in_ptr,
                               const void* in_src, const void* in_P, void* grad, void* loss,
                               int n, int k, int d, int gaussian, void* stream) {
  if (n <= 0) return 0;
  if (k < 0 || (reinterpret_cast<uintptr_t>(Z) & 7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* z = static_cast<const float*>(Z);
  const auto* ids = static_cast<const int*>(nn);
  const auto* w = static_cast<const float*>(P);
  const auto* ptr = static_cast<const long long*>(in_ptr);
  const auto* src = static_cast<const int*>(in_src);
  const auto* w_in = static_cast<const float*>(in_P);
  auto* g = static_cast<float*>(grad);
  auto* l = static_cast<float*>(loss);
  const bool gs = gaussian != 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return static_cast<int>(launch_d<1>(z, ids, w, ptr, src, w_in, g, l, n, k, gs, st));
    case 2: return static_cast<int>(launch_d<2>(z, ids, w, ptr, src, w_in, g, l, n, k, gs, st));
    case 3: return static_cast<int>(launch_d<3>(z, ids, w, ptr, src, w_in, g, l, n, k, gs, st));
    case 4: return static_cast<int>(launch_d<4>(z, ids, w, ptr, src, w_in, g, l, n, k, gs, st));
    case 5: return static_cast<int>(launch_d<5>(z, ids, w, ptr, src, w_in, g, l, n, k, gs, st));
    case 6: return static_cast<int>(launch_d<6>(z, ids, w, ptr, src, w_in, g, l, n, k, gs, st));
    case 7: return static_cast<int>(launch_d<7>(z, ids, w, ptr, src, w_in, g, l, n, k, gs, st));
    case 8: return static_cast<int>(launch_d<8>(z, ids, w, ptr, src, w_in, g, l, n, k, gs, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
