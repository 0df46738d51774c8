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
//   bf16, row by row (two float4 loads and one 16-byte store a row of 8),
//   padded so that the B fragments' ldmatrix loads meet no bank conflict.
// - What held the first design was issue, not the tensor cores nor the
//   bytes: it rebuilt every one-hot A fragment from the ids at each of
//   the R / 16 k-steps (27 instructions per product), though a row's
//   one-hot is nonzero at one k-step only. Now the A fragment is built once
//   per tile: each row's one-hot at its own k-step. The product at k-step k
//   then holds, for each row whose k-step it is, the row it gathers, and
//   that row keeps it (a compare and a select per row; successive products
//   do not depend on each other). A warp visits only the k-steps its tile's
//   ids hit (about 12.7 of 32 at R = 512 for uniform ids): the OR of the
//   lanes' bits (one __reduce_or_sync per 32 k-steps) is the same in every
//   lane, so the loop over its bits keeps mma.sync warp-uniform. A row's
//   product at its own k-step is its only nonzero term, so every output is
//   the same single bf16 term as before.
// - G2 contracts over the R rows of the window (padded to 16) into 8
//   columns (D padded to 8). G3 contracts over the R / grp groups (padded to
//   16) into grp * P columns (P: D padded to a power of two), 8 at a time:
//   it visits only the column tiles that hold a row's member (one member a
//   tile at P = 8), and a row keeps the accumulators of the column tile of
//   its member. Its A fragment is built once per tile when the groups fit
//   one k-step (R / grp <= 16); above that, at each k-step the groups hit,
//   from per-row constants (a compare and a select per register). The
//   lanes of a quad that hold the same coordinate are then summed by
//   shuffles (one value and zeros).
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
__device__ __forceinline__ uint32_t onehot_pair(int local, int col) {
  const unsigned u = static_cast<unsigned>(local - col);
  return u < 2u ? kOneBf16 << (16u * u) : 0u;
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

// b0, b1 of a B fragment from a row-major bf16 tile in shared memory: two
// 8 x 8 tiles loaded transposed. Lane l gives the address of B row l & 15
// (lanes 16-31 repeat lanes 0-15; ldmatrix .x2 reads the first 16).
__device__ __forceinline__ void ldsm_b(uint32_t& b0, uint32_t& b1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stage one window row of D floats (zeros when !real) as P bf16 at dst,
// which is aligned to 2P bytes; a row of 8 floats is read as two float4
// when the source is aligned to 16 bytes (vec).
template <int D, int P>
__device__ __forceinline__ void stage_row(unsigned char* dst, const float* src, bool real,
                                          bool vec) {
  float v[8];
  if (D == 8 && vec) {
    const float4 x = real ? __ldg(reinterpret_cast<const float4*>(src)) : make_float4(0, 0, 0, 0);
    const float4 y =
        real ? __ldg(reinterpret_cast<const float4*>(src) + 1) : make_float4(0, 0, 0, 0);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = real && i < D ? __ldg(src + i) : 0.0f;
  }
  if constexpr (P == 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else if constexpr (P == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else if constexpr (P == 2) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v[0], v[1]);
  } else {
    *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(v[0]);
  }
}

// The id of row g + 8h of the tile from row0, clamped to the window; -1
// for a row past c.
__device__ __forceinline__ int tile_id(const int* ids, int row0, int h, int c, int r, int g) {
  const int row = row0 + g + 8 * h;
  return row < c ? clamp_id(__ldg(ids + row), r) : -1;
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

// The bit of step s (a k-step or a column tile) in the 32-bit word of steps
// from w0; 0 when s lies outside it or is -1 (a row past c).
__device__ __forceinline__ unsigned step_bit(int s, int w0) {
  const unsigned u = static_cast<unsigned>(s - w0);
  return u < 32u ? 1u << u : 0u;
}

// The warp's set of steps from w0 that its tile's rows hit (the same word in
// every lane, so a loop over its bits is warp-uniform and may hold mma.sync).
__device__ __forceinline__ unsigned warp_steps(const int (&s)[2], int w0) {
  return __reduce_or_sync(0xffffffffu, step_bit(s[0], w0) | step_bit(s[1], w0));
}

// id / grp for 0 <= id < 2^22: a float product by the rounded reciprocal is
// within 1 of the quotient, and one correction makes it exact.
__device__ __forceinline__ int div_small(int id, int grp, float inv) {
  int q = __float2int_rz(__int2float_rn(id) * inv);
  const int rem = id - q * grp;
  q += (rem >= grp) - (rem < 0);
  return q;
}

// A row's part of a one-hot A fragment. A row with window row (or group) id
// is nonzero at k-step id >> 4 only, where its two registers are the bf16
// pairs of columns (2t, 2t + 1) and (2t + 8, 2t + 9) of the one-hot of
// id & 15; at any other k-step they are 0.
struct OnehotRow {
  int step;         // k-step of the row's one; -1 for a row past c
  uint32_t lo, hi;  // its A registers at that k-step
  __device__ __forceinline__ void set(int id, int t) {
    step = id < 0 ? -1 : id >> 4;
    lo = onehot_pair(id & 15, 2 * t);
    hi = onehot_pair(id & 15, 2 * t + 8);
  }
};

// The A fragment at k-step k of a tile whose rows g and g + 8 are r0, r1.
__device__ __forceinline__ void onehot_at(uint32_t (&a)[4], const OnehotRow& r0,
                                          const OnehotRow& r1, int k) {
  a[0] = r0.step == k ? r0.lo : 0u;
  a[1] = r1.step == k ? r1.lo : 0u;
  a[2] = r0.step == k ? r0.hi : 0u;
  a[3] = r1.step == k ? r1.hi : 0u;
}

// G2. The window, as bf16 and padded to rp = R rounded up to 16 rows and 8
// columns, is staged row by row, 16 bytes a row: the 8 rows of an 8 x 8
// tile of a B fragment are 128 contiguous bytes, so its ldmatrix meets no
// bank conflict. A warp takes one tile of 16 rows at a time and visits only
// the k-steps its ids hit, in increasing order (two or four tiles sharing
// the B fragments visit the union of their k-steps, which costs more).
template <int D>
__global__ void __launch_bounds__(kThreads)
bucket_onehot_kernel(const float* __restrict__ Zb, const int* __restrict__ idx,
                     float* __restrict__ out, int r, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rp = (r + 15) & ~15;
  const size_t b = blockIdx.x;
  const float* win = Zb + b * r * D;
  const bool vec = (reinterpret_cast<uintptr_t>(win) & 15) == 0;
  for (int k = threadIdx.x; k < rp; k += kThreads)
    stage_row<D, 8>(smem + 16 * k, win + static_cast<size_t>(k) * D, k < r, vec);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nk = rp >> 4;
  // the lane's row of the B fragment at k-step 0; 256 bytes a k-step
  const uint32_t brow = shared_addr(smem) + 16 * (lane & 15);
  const int* ids = idx + b * c;
  float* o = out + b * c * D;
  for (int row0 = warp * 16; row0 < c; row0 += kWarps * 16) {
    OnehotRow rows[2];
    int step[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rows[h].set(tile_id(ids, row0, h, c, r, g), t);
      step[h] = rows[h].step;
    }
    // each row's one-hot at its own k-step
    const uint32_t a[4] = {rows[0].lo, rows[1].lo, rows[0].hi, rows[1].hi};
    // At k-step k the product of this A holds, for each row whose k-step it
    // is, its gathered row; a row keeps the product of its k-step. Rows g
    // (acc[0], acc[1]) and g + 8 (acc[2], acc[3]), columns 2t, 2t + 1.
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int w0 = 0; w0 < nk; w0 += 32) {
      for (unsigned bits = warp_steps(step, w0); bits != 0u; bits &= bits - 1u) {
        const int k = w0 + __ffs(static_cast<int>(bits)) - 1;
        uint32_t b0, b1;
        ldsm_b(b0, b1, brow + 256 * k);
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(d, a, b0, b1);
        if (step[0] == k) acc[0] = d[0], acc[1] = d[1];
        if (step[1] == k) acc[2] = d[2], acc[3] = d[3];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row >= c || 2 * t >= D) continue;
      float* dst = o + static_cast<size_t>(row) * D + 2 * t;
      if (D % 2 == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[2 * h], acc[2 * h + 1]);
      } else {
        dst[0] = acc[2 * h];
        if (2 * t + 1 < D) dst[1] = acc[2 * h + 1];
      }
    }
  }
}

// G3. Stage 1's B is (R / grp groups) x (grp * P): row k is group k, its
// rows one after the other, each padded to P floats. It is staged as bf16,
// padded to kp = R / grp rounded up to 16 rows and np = grp * P rounded up
// to 8 columns, row by row with rs = np | 8 bf16 a row (an odd number of 16
// bytes, so the 8 rows of an ldmatrix tile meet no bank conflict). Only the
// padding rows of groups (R / grp .. kp - 1) are zeroed: the products
// multiply them by the one-hot's zeros. A padding column is never selected,
// so it may hold anything.
//
// A warp takes one tile of 16 rows at a time. Its rows hold about 12.7 of
// the 32 members of a group at grp = 32 (uniform ids), so it visits only
// the column tiles of 8 columns (one member at P = 8) that hold a row's
// member: a stage-1 product, over the k-steps the rows' groups hit (one
// k-step, with the A fragment built once per tile, when kp = 16), then a
// select of the accumulators of the rows whose member it is.
template <int D, bool kOneStep>
__global__ void __launch_bounds__(kThreads)
bucket_2level_kernel(const float* __restrict__ Zb, const int* __restrict__ idx,
                     float* __restrict__ out, int r, int c, int grp) {
  constexpr int P = Padded<D>::P;
  // lanes of a quad that hold the same coordinate differ in the bits from kShare up
  constexpr int kShare = P >= 2 ? P / 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ngrp = r / grp;
  const int kp = (ngrp + 15) & ~15;
  const int np = (grp * P + 7) & ~7;
  const int rs = np | 8;
  const float inv = 1.0f / static_cast<float>(grp);
  const size_t b = blockIdx.x;
  const float* win = Zb + b * r * D;
  const bool vec = (reinterpret_cast<uintptr_t>(win) & 15) == 0;
  for (int e = threadIdx.x; e < (kp - ngrp) * (rs / 8); e += kThreads)
    reinterpret_cast<uint4*>(smem)[ngrp * (rs / 8) + e] = make_uint4(0, 0, 0, 0);
  for (int row = threadIdx.x; row < r; row += kThreads) {
    const int k = div_small(row, grp, inv);
    stage_row<D, P>(smem + 2 * (k * rs + (row - k * grp) * P), win + static_cast<size_t>(row) * D,
                    true, vec);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nks = kp >> 4, nct = np >> 3;
  // the lane's row of the B fragment at k-step 0, column tile 0; 16 bytes a
  // column tile, 32 rs bytes a k-step
  const uint32_t brow = shared_addr(smem) + 2 * rs * (lane & 15);
  const int* ids = idx + b * c;
  float* o = out + b * c * D;
  for (int row0 = warp * 16; row0 < c; row0 += kWarps * 16) {
    int hi_step[2], tile[2], lo[2];
    OnehotRow hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int id = tile_id(ids, row0, h, c, r, g);
      const int q = id < 0 ? -1 : div_small(id, grp, inv);
      lo[h] = id < 0 ? -1 : id - q * grp;
      hi[h].set(q, t);
      hi_step[h] = hi[h].step;
      tile[h] = id < 0 ? -1 : (lo[h] * P) >> 3;
    }
    uint32_t a[4];
    if constexpr (kOneStep) onehot_at(a, hi[0], hi[1], 0);
    const unsigned steps0 = kOneStep ? 1u : warp_steps(hi_step, 0);
    float sel[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // [2h + e]: row g + 8h, column 2t + e
    for (int w0 = 0; w0 < nct; w0 += 32) {
      for (unsigned tiles = warp_steps(tile, w0); tiles != 0u; tiles &= tiles - 1u) {
        const int ct = w0 + __ffs(static_cast<int>(tiles)) - 1;
        // stage 1: columns 8 ct .. 8 ct + 7 of each row's group
        const uint32_t col = brow + 16 * ct;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        uint32_t b0, b1;
        if constexpr (kOneStep) {
          ldsm_b(b0, b1, col);
          mma_bf16(acc, a, b0, b1);
        } else {
          for (int k0 = 0; k0 < nks; k0 += 32) {
            for (unsigned steps = k0 == 0 ? steps0 : warp_steps(hi_step, k0); steps != 0u;
                 steps &= steps - 1u) {
              const int k = k0 + __ffs(static_cast<int>(steps)) - 1;
              onehot_at(a, hi[0], hi[1], k);
              ldsm_b(b0, b1, col + 32 * k * rs);
              mma_bf16(acc, a, b0, b1);
            }
          }
        }
        // stage 2: column 2t + e holds member m of the group; keep the
        // accumulators of the rows whose member it is
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = ct * (8 / P) + (2 * t + e) / P;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (lo[h] == m) sel[2 * h + e] = acc[2 * h + e];
        }
      }
    }
    // Column 2t + e holds coordinate (2t + e) % P in every column tile (P
    // divides 8). Sum the lanes that hold the same coordinate: one of them
    // selected the row's value, the others hold zeros.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (P == 1) {  // both columns of a lane hold coordinate 0
        if (j % 2 == 1) continue;
        sel[j] += sel[j | 1];
      }
#pragma unroll
      for (int mask = kShare; mask < 4; mask *= 2)
        sel[j] += __shfl_xor_sync(0xffffffffu, sel[j], mask);
    }
    if (t >= kShare) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row >= c) continue;
      float* dst = o + static_cast<size_t>(row) * D;
      if constexpr (P == 1) {
        dst[0] = sel[2 * h];
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (2 * t + e < D) dst[2 * t + e] = sel[2 * h + e];
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
  const size_t kp = (r / grp + 15) & ~15;
  const size_t np = (static_cast<size_t>(grp) * Padded<D>::P + 7) & ~size_t{7};
  const size_t bytes = sizeof(__nv_bfloat16) * kp * (np | 8);
  // the groups fit one k-step: the A fragment is built once per tile
  auto kernel = kp == 16 ? bucket_2level_kernel<D, true> : bucket_2level_kernel<D, false>;
  if (const int rc = allow_shared(kernel, bytes)) return rc;
  kernel<<<nb, kThreads, bytes, stream>>>(Zb, idx, out, r, c, grp);
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
