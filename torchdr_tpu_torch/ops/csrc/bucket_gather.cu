// Bucketed gathers from a window of rows (G1 take, G2 onehot, G3 2level)
// for Hopper (sm_90a).
//
// Replace the three TPU kernels of benchmarks/_gather_microbench.py, for
// windows Zb (nb, R, D) float32 and window-local ids idx (nb, c) int32 (the
// TPU kernels' (nb, 8, c / 8) tiles, row-major):
//
//   bucket_take   (bench_pl_take,   G1): out[b, k] = Zb[b, idx[b, k]]
//   bucket_onehot (bench_pl_onehot, G2): out[b] = onehot(idx[b]) @ bf16(Zb[b]),
//       bf16 operands, float32 sums, over the R rows of the window
//   bucket_2level (bench_pl_2level, G3): a one-hot bf16 product that brings
//       each row's group of grp window rows down, then a float32 one-hot
//       select of the row within its group
//
// Every output element of G2 and G3 is a sum with one nonzero term, so both
// return the gathered rows rounded to bf16 (__float2bfloat16_rn, round to
// nearest even, as JAX's astype and torch's .to(torch.bfloat16)) exactly,
// and G1 the gathered rows themselves.
//
// Bound. The function reads its ids (4c bytes a window) and the window rows
// they touch (4D each; R (1 - (1 - 1/R)^c) of a window's R rows for uniform
// ids, 86.5 % at R = 512, c = 1,024) and writes its rows (4cD): at the
// microbenchmark's shape (nb = 20,312, R = 512, c = 1,024, D = 8)
// 83.2 + 287.8 + 665.6 MB = 1.037 GB, 0.309 ms at 3.35 TB/s. G1 reads only
// the rows it needs; G2 and G3 stage the whole window (332.8 MB), 45 MB more
// than the function needs. The products of G2 and G3 are 2cRD operations
// a window, 170 GFLOP in all: 0.172 ms on the tensor cores at 989 TFLOP/s
// in bf16, so there the bytes bound them; on the CUDA cores (67 TFLOP/s)
// the operations would, at about 2.5 ms.
//
// What the design does about it:
// - One block per window. It reads each id and each window row it uses once
//   from device memory and writes each output float once, neighbouring threads
//   on neighbouring addresses.
// - G1 reads each row by id straight from its window, through the L1 cache
//   (a window is 16 KB at the shape above), one output float per thread and
//   step.
// - G2 and G3 run their products on the tensor cores, mma.sync m16n8k16
//   with bf16 operands and float32 accumulators, which is exact for a
//   one-hot operand. The block stages its window once in shared memory as
//   bf16, transposed and padded so that the B fragments' loads of a warp
//   meet no bank conflict. The one-hot A fragments are made in registers
//   from the ids (a compare and a shift per pair of columns) and are never
//   stored. A warp holds kTiles tiles of 16 rows, so each B fragment serves
//   kTiles products.
// - G2 contracts over the R rows of the window (padded to 16) into 8
//   columns (D padded to 8). G3 contracts over the R / grp groups (padded to
//   16) into grp * P columns (P: D padded to a power of two), 8 at a time,
//   and after each 8 selects the row's member of its group from the
//   accumulators by float32 one-hot products; the lanes of a quad that hold
//   the same coordinate are then summed by shuffles.
//
// Ids are clamped to [0, R), so a kernel never reads outside its window; an
// id out of that range is outside the contract, as it is for the TPU
// kernels. So is a non-finite value in a window for G2 and G3, whose
// product multiplies it by zero for every other row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps; one block per window
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 4;  // 16-row tiles a warp holds at once (G2, G3)
constexpr int kMaxShared = 227 * 1024;  // dynamic shared memory a block can have
constexpr int kDefaultShared = 48 * 1024;  // above it only after cudaFuncSetAttribute
constexpr uint32_t kOneBf16 = 0x3F80u;  // 1.0 in bf16

__device__ __forceinline__ int clamp_id(int id, int r) { return min(max(id, 0), r - 1); }

// Floats of one staged row of G3: d padded to a power of two.
template <int D>
struct Padded {
  static constexpr int P = D == 1 ? 1 : D == 2 ? 2 : D <= 4 ? 4 : 8;
};

// One register of a one-hot A fragment: the bf16 pair of columns (col,
// col + 1) of a row whose id, less the k-step's first column, is `local`.
// The id -1 (a row past c) matches no column.
__device__ __forceinline__ uint32_t onehot_pair(int local, int col) {
  const unsigned u = static_cast<unsigned>(local - col);
  return u < 2u ? kOneBf16 << (16u * u) : 0u;
}

// The A fragment of a 16 x 16 one-hot tile whose rows g and g + 8 (g = lane
// / 4) have the ids id0 and id1, at the k-step starting at column k0.
__device__ __forceinline__ void onehot_fragment(uint32_t (&a)[4], int id0, int id1, int k0,
                                                int t) {
  a[0] = onehot_pair(id0 - k0, 2 * t);
  a[1] = onehot_pair(id1 - k0, 2 * t);
  a[2] = onehot_pair(id0 - k0, 2 * t + 8);
  a[3] = onehot_pair(id1 - k0, 2 * t + 8);
}

// d += a b on the tensor cores: a 16 x 16 (row-major), b 16 x 8
// (column-major) bf16, d 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The ids of the rows g and g + 8 of a warp's kTiles tiles from row0, each
// clamped to the window; -1 for rows past c.
__device__ __forceinline__ void tile_ids(int (&id)[kTiles][2], const int* ids, int row0, int c,
                                         int r, int g) {
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * i + g + 8 * h;
      id[i][h] = row < c ? clamp_id(__ldg(ids + row), r) : -1;
    }
  }
}

// G1: one output float per thread and step, read by id from the window.
template <int D>
__global__ void __launch_bounds__(kThreads)
bucket_take_kernel(const float* __restrict__ Zb, const int* __restrict__ idx,
                   float* __restrict__ out, int r, int c) {
  const size_t b = blockIdx.x;
  const float* win = Zb + b * r * D;
  const int* ids = idx + b * c;
  float* o = out + b * c * D;
  for (int e = threadIdx.x; e < c * D; e += kThreads) {
    const int k = e / D;
    o[e] = __ldg(win + clamp_id(__ldg(ids + k), r) * D + (e - k * D));
  }
}

// G2. The window, as bf16 and padded to rp = R rounded up to 16 rows and 8
// columns, is staged transposed: column n, row k at sb[n * stride + k], with
// stride = rp + 8 so that the 8 columns of a B fragment fall in 8 different
// sets of 4 banks.
template <int D>
__global__ void __launch_bounds__(kThreads)
bucket_onehot_kernel(const float* __restrict__ Zb, const int* __restrict__ idx,
                     float* __restrict__ out, int r, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(smem);  // two rows of one column
  const int rp = (r + 15) & ~15;
  const int stride = rp + 8;
  const size_t b = blockIdx.x;
  const float* win = Zb + b * r * D;
  for (int e = threadIdx.x; e < rp * 8; e += kThreads) {
    const int k = e >> 3, n = e & 7;
    sb[n * stride + k] = __float2bfloat16_rn(k < r && n < D ? win[k * D + n] : 0.0f);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int* ids = idx + b * c;
  float* o = out + b * c * D;
  for (int row0 = warp * 16 * kTiles; row0 < c; row0 += kWarps * 16 * kTiles) {
    int id[kTiles][2];
    float acc[kTiles][4];
    tile_ids(id, ids, row0, c, r, g);
#pragma unroll
    for (int i = 0; i < kTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    for (int k0 = 0; k0 < rp; k0 += 16) {
      // B fragment: rows k0 + 2t, + 1 (b0) and k0 + 2t + 8, + 9 (b1) of column g
      const uint32_t b0 = sw[(g * stride + k0) / 2 + t];
      const uint32_t b1 = sw[(g * stride + k0 + 8) / 2 + t];
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        uint32_t a[4];
        onehot_fragment(a, id[i][0], id[i][1], k0, t);
        mma_bf16(acc[i], a, b0, b1);
      }
    }
    // accumulators: rows g (acc[0], acc[1]) and g + 8 (acc[2], acc[3]), columns 2t, 2t + 1
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * i + g + 8 * h;
        if (row >= c || 2 * t >= D) continue;
        float* dst = o + static_cast<size_t>(row) * D + 2 * t;
        if (D % 2 == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
        } else {
          dst[0] = acc[i][2 * h];
          if (2 * t + 1 < D) dst[1] = acc[i][2 * h + 1];
        }
      }
    }
  }
}

// G3. Stage 1's B is (R / grp groups) x (grp * P): row k is group k, its
// rows one after the other, each padded to P floats. It is staged as bf16,
// padded to kp = R / grp rounded up to 16 rows and np = grp * P rounded up
// to 8 columns, and transposed: column n, row k at sb[n * stride + k], with
// stride = kp + 8.
template <int D>
__global__ void __launch_bounds__(kThreads)
bucket_2level_kernel(const float* __restrict__ Zb, const int* __restrict__ idx,
                     float* __restrict__ out, int r, int c, int grp) {
  constexpr int P = Padded<D>::P;
  // lanes of a quad that hold the same coordinate differ in the bits from kShare up
  constexpr int kShare = P >= 2 ? P / 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(smem);
  const int ngrp = r / grp;
  const int kp = (ngrp + 15) & ~15;
  const int np = (grp * P + 7) & ~7;
  const int stride = kp + 8;
  const size_t b = blockIdx.x;
  const float* win = Zb + b * r * D;
  for (int e = threadIdx.x; e < kp * np; e += kThreads) {
    const int k = e / np, n = e - k * np;
    const int m = n / P, col = n % P;  // member of the group, coordinate
    const bool real = k < ngrp && m < grp && col < D;
    sb[n * stride + k] = __float2bfloat16_rn(real ? win[(k * grp + m) * D + col] : 0.0f);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int* ids = idx + b * c;
  float* o = out + b * c * D;
  for (int row0 = warp * 16 * kTiles; row0 < c; row0 += kWarps * 16 * kTiles) {
    int hi[kTiles][2], lo[kTiles][2];
    float sel[kTiles][4];  // [2h + e]: row g + 8h, the coordinate of column 2t + e
    tile_ids(hi, ids, row0, c, r, g);
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int id = hi[i][h];
        hi[i][h] = id < 0 ? -1 : id / grp;
        lo[i][h] = id < 0 ? -1 : id - hi[i][h] * grp;
      }
      sel[i][0] = sel[i][1] = sel[i][2] = sel[i][3] = 0.0f;
    }
    for (int n0 = 0; n0 < np; n0 += 8) {
      // stage 1: columns n0 .. n0 + 7 of each row's group
      float acc[kTiles][4];
#pragma unroll
      for (int i = 0; i < kTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
      for (int k0 = 0; k0 < kp; k0 += 16) {
        const uint32_t b0 = sw[((n0 + g) * stride + k0) / 2 + t];
        const uint32_t b1 = sw[((n0 + g) * stride + k0 + 8) / 2 + t];
#pragma unroll
        for (int i = 0; i < kTiles; ++i) {
          uint32_t a[4];
          onehot_fragment(a, hi[i][0], hi[i][1], k0, t);
          mma_bf16(acc[i], a, b0, b1);
        }
      }
      // stage 2: column n0 + 2t + e holds member (n0 + 2t + e) / P of the group
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = (n0 + 2 * t + e) / P;
#pragma unroll
        for (int i = 0; i < kTiles; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float onehot = lo[i][h] == m ? 1.0f : 0.0f;
            sel[i][2 * h + e] += onehot * acc[i][2 * h + e];
          }
        }
      }
    }
    // Column 2t + e holds coordinate (2t + e) % P, the same for every n0
    // (P divides 8). Sum the lanes that hold the same coordinate: one term
    // of theirs is nonzero, the others are zeros.
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (P == 1) {  // both columns of a lane hold coordinate 0
          if (j % 2 == 1) continue;
          sel[i][j] += sel[i][j | 1];
        }
#pragma unroll
        for (int mask = kShare; mask < 4; mask *= 2)
          sel[i][j] += __shfl_xor_sync(0xffffffffu, sel[i][j], mask);
      }
    }
    if (t >= kShare) continue;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * i + g + 8 * h;
        if (row >= c) continue;
        float* dst = o + static_cast<size_t>(row) * D;
        if constexpr (P == 1) {
          dst[0] = sel[i][2 * h];
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (2 * t + e < D) dst[2 * t + e] = sel[i][2 * h + e];
        }
      }
    }
  }
}

template <int D>
int launch_take(const float* Zb, const int* idx, float* out, int nb, int r, int c,
                cudaStream_t stream) {
  bucket_take_kernel<D><<<nb, kThreads, 0, stream>>>(Zb, idx, out, r, c);
  return static_cast<int>(cudaGetLastError());
}

// A kernel's dynamic shared memory, allowed above the default first.
template <typename Kernel>
int allow_shared(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxShared)) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= static_cast<size_t>(kDefaultShared)) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int D>
int launch_onehot(const float* Zb, const int* idx, float* out, int nb, int r, int c,
                  cudaStream_t stream) {
  const size_t bytes = sizeof(__nv_bfloat16) * 8 * (((r + 15) & ~15) + 8);
  if (const int rc = allow_shared(bucket_onehot_kernel<D>, bytes)) return rc;
  bucket_onehot_kernel<D><<<nb, kThreads, bytes, stream>>>(Zb, idx, out, r, c);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_2level(const float* Zb, const int* idx, float* out, int nb, int r, int c, int grp,
                  cudaStream_t stream) {
  const size_t np = (static_cast<size_t>(grp) * Padded<D>::P + 7) & ~size_t{7};
  const size_t bytes = sizeof(__nv_bfloat16) * np * (((r / grp + 15) & ~15) + 8);
  if (const int rc = allow_shared(bucket_2level_kernel<D>, bytes)) return rc;
  bucket_2level_kernel<D><<<nb, kThreads, bytes, stream>>>(Zb, idx, out, r, c, grp);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int nb, int r, int d, int c) {
  return nb < 0 || r <= 0 || c < 0 || d < 1 || d > 8 ||
         static_cast<long long>(c) * d > 0x7fffffffLL ||
         static_cast<long long>(r) * d > 0x7fffffffLL;
}

}  // namespace

#define GATHER_DISPATCH(LAUNCH, ...)                      \
  switch (d) {                                            \
    case 1: return LAUNCH<1>(__VA_ARGS__);                \
    case 2: return LAUNCH<2>(__VA_ARGS__);                \
    case 3: return LAUNCH<3>(__VA_ARGS__);                \
    case 4: return LAUNCH<4>(__VA_ARGS__);                \
    case 5: return LAUNCH<5>(__VA_ARGS__);                \
    case 6: return LAUNCH<6>(__VA_ARGS__);                \
    case 7: return LAUNCH<7>(__VA_ARGS__);                \
    case 8: return LAUNCH<8>(__VA_ARGS__);                \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// C interface, loaded with ctypes. Zb (nb, r, d) float32, idx (nb, c) int32
// and out (nb, c, d) float32 are contiguous on the device; 1 <= d <= 8.
// Each returns the first CUDA error (0 on success); nothing is launched for
// nb = 0 or c = 0.
extern "C" int bucket_take(const void* Zb, const void* idx, void* out, int nb, int r, int d,
                           int c, void* stream) {
  if (bad_shape(nb, r, d, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || c == 0) return 0;
  GATHER_DISPATCH(launch_take, static_cast<const float*>(Zb), static_cast<const int*>(idx),
                  static_cast<float*>(out), nb, r, c, static_cast<cudaStream_t>(stream))
}

extern "C" int bucket_onehot(const void* Zb, const void* idx, void* out, int nb, int r, int d,
                             int c, void* stream) {
  if (bad_shape(nb, r, d, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || c == 0) return 0;
  GATHER_DISPATCH(launch_onehot, static_cast<const float*>(Zb), static_cast<const int*>(idx),
                  static_cast<float*>(out), nb, r, c, static_cast<cudaStream_t>(stream))
}

// grp: rows of a group; r % grp == 0.
extern "C" int bucket_2level(const void* Zb, const void* idx, void* out, int nb, int r, int d,
                             int c, int grp, void* stream) {
  if (bad_shape(nb, r, d, c) || grp <= 0 || r % grp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || c == 0) return 0;
  GATHER_DISPATCH(launch_2level, static_cast<const float*>(Zb), static_cast<const int*>(idx),
                  static_cast<float*>(out), nb, r, c, grp, static_cast<cudaStream_t>(stream))
}
