// Row hashes for the duplicate-row test of a fit's input, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package, like the port before it, tests
// whether a fit's rows are all distinct on the host, before the copy to the
// device: utils/wrappers._row_hashes hashes each row, and numpy's row sort
// runs only where two hashes collide. That host pass took 1.5-2.1 s of a
// 4.1 s UMAP fit at 1,300,000 x 50 on an H100's host (PERF.md), with the
// card idle. The port copies the rows to the card first and hashes them
// there, with this kernel, in one read of the rows the fit needs on the card
// anyway.
//
// For each row i of the contiguous float32 X (n, m), read as 32-bit words:
//
//   h_i = 0xCBF29CE484222325
//   h_i = (h_i ^ word_ij) * 1099511628211   for j = 0 .. m - 1, in uint64
//
// which is _row_hashes' FNV-1a bit for bit, so the decision it feeds is the
// host's.
//
// Bound. It reads X once (4nm bytes) and writes 8n: 265.2 MB at 1,300,000 x
// 50, 79 us at 3.35 TB/s; 219.8 MB at 70,000 x 784, 66 us. The arithmetic,
// a 64-bit multiply by a constant and an xor a word (three to four integer
// instructions), is 65 M and 55 M word steps there, some 15 us of the
// integer units: it is bound by bytes. Each row's steps form one serial
// chain (FNV-1a is not associative), so a row is one thread's work.
//
// What the design does about it:
// - A block takes kRows consecutive rows, one a thread, and walks their
//   columns in chunks of kChunk words. It stages each chunk of its rows in
//   shared memory with cp.async (16-byte copies, neighbouring threads on
//   neighbouring 16-byte groups of a row, then of the next row) and hashes
//   it from there, so every word of X is read from device memory once, in
//   whole sectors, and a thread carries its row's state across the chunks:
//   a row of any width never has to fit in shared memory.
// - Two buffers: the next chunk's copies are in flight while the current
//   one is hashed. With 36.9 KB a block, six blocks fit an SM, so up to
//   ~100 KB a SM is in flight, more than the ~25 KB that keep its share of
//   the memory system busy.
// - A row's chunk starts on a 16-byte boundary only when its word offset is
//   a multiple of 4 (any row at m % 4 == 0; every other row at m = 50). The
//   stage copies the aligned 16-byte groups that cover the chunk (one more
//   group where it is not aligned) and the thread hashes the words from its
//   offset on: a row's stage is kStride = 36 words, 4 mod 32, so the 16-byte
//   shared-memory reads of a quarter warp hit eight distinct bank groups.
//   A group that reaches past the end of X is copied only up to that end
//   (cp.async's source size), so nothing outside X is read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;                  // rows a block, one a thread
constexpr int kChunk = 32;                  // words of a row a stage holds
constexpr int kGroups = kChunk / 4 + 1;     // 16-byte groups a row's stage may span
constexpr int kStride = kGroups * 4;        // words a row takes in a stage: 36, 4 mod 32
constexpr uint64_t kOffset = 0xCBF29CE484222325ull;
constexpr uint64_t kPrime = 1099511628211ull;

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies words [c0, c0 + len) of the block's `rows` rows, from row0 on, into
// `buf`, each row at kStride words from the last, from the 16-byte group
// that holds its first word.
__device__ __forceinline__ void stage(uint32_t* buf, const uint32_t* __restrict__ x,
                                      long long total, int m, long long row0, int rows,
                                      int c0, int len) {
  for (int p = threadIdx.x; p < rows * kGroups; p += kRows) {
    const int r = p / kGroups;
    const int g = p - r * kGroups;
    const long long first = (row0 + r) * m + c0;
    const int skip = static_cast<int>(first & 3);
    if (4 * g >= skip + len) continue;  // past the chunk's last word
    const long long w = (first - skip) + 4 * g;
    const long long left = total - w;   // >= 1: w <= the chunk's last word
    cp_async16(buf + r * kStride + 4 * g, x + w, left >= 4 ? 16 : static_cast<int>(left) * 4);
  }
}

__global__ void __launch_bounds__(kRows) row_hash_kernel(const uint32_t* __restrict__ x,
                                                         unsigned long long* __restrict__ out,
                                                         int n, int m) {
  __shared__ __align__(16) uint32_t smem[2][kRows * kStride];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = min(kRows, static_cast<int>(n - row0));
  const long long total = static_cast<long long>(n) * m;
  const int t = threadIdx.x;
  const int chunks = (m + kChunk - 1) / kChunk;
  const int skip = t < rows ? static_cast<int>(((row0 + t) * m) & 3) : 0;  // of chunk 0
  uint64_t h = kOffset;

  if (chunks > 0) stage(smem[0], x, total, m, row0, rows, 0, min(kChunk, m));
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int c0 = k * kChunk;
    if (k + 1 < chunks) {
      const int c1 = c0 + kChunk;
      stage(smem[(k + 1) & 1], x, total, m, row0, rows, c1, min(kChunk, m - c1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t < rows) {
      // kChunk is a multiple of 4, so every chunk of a row starts at the
      // same offset within its 16-byte group as the row's first word
      const int end = skip + min(kChunk, m - c0);
      const uint32_t* row = smem[k & 1] + t * kStride;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (4 * g >= end) break;
        const uint4 v = *reinterpret_cast<const uint4*>(row + 4 * g);
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * g + j;
          if (i >= skip && i < end) h = (h ^ words[j]) * kPrime;
        }
      }
    }
    __syncthreads();  // the buffer is staged again two chunks on
  }
  if (t < rows) out[row0 + t] = h;
}

}  // namespace

// X: (n, m) float32, contiguous, 16-byte aligned; out: (n,) 64-bit.
extern "C" int row_hash(const void* X, void* out, int n, int m, void* stream) {
  if (n <= 0) return 0;
  if (m < 0 || (reinterpret_cast<uintptr_t>(X) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kRows - 1) / kRows;
  row_hash_kernel<<<blocks, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(X), static_cast<unsigned long long*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}
