// Fixup Bloom-filter batch probe for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bloom_query/bloom_query.py
// (`_kernel` at :56, launched by `bloom_query_call` at :282): for each
// key row it computes the two murmur3-style tuple hashes (seeds 0xA5A5
// and 0x5EED | 1, exactly as `_hash_block` at :41-53 does), forms
// `n_hashes` double-hash positions `(h1 + k*h2) % m_bits`, and ANDs the
// probed bits of the packed 32-bit bitset. Output: one byte (0/1) per
// row, written into a torch.bool tensor.
//
// Design: one thread per key row. The Pallas kernel pinned the whole
// bitset in VMEM and processed blocks of `block_n` rows; here a block of
// rows is no unit of the algorithm, so n_cols, n_hashes and m_bits are
// runtime arguments and the ragged tail is masked by the row guard.
// The bitset (19-77 KB for the airplane index, a few MB at most for
// fixup filters) is read through the read-only path with __ldg and
// stays resident in the 50 MB L2 after the first touches.
//
// What bounds it: the bytes that must move are the (N, n_cols) int32 ids
// in, N bytes out and the bitset once; the random 4-byte bitset reads
// (N * n_hashes of them) hit L2. The integer work is 2 * n_cols mix
// rounds and two fmix finalisers a row, plus n_hashes 32-bit modulos by
// a runtime divisor. At serving shapes (<= 4096 rows) both are far below
// the launch overhead, so the kernel is launch-bound.
//
// Left for later PRs: staging the bitset in shared memory, coalescing
// the row-major id loads (each thread now reads its own n_cols words),
// and replacing the runtime 32-bit modulo with a precomputed
// multiply-shift reciprocal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mix_round(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__global__ void bloom_query_kernel(const int32_t* __restrict__ ids,
                                   const uint32_t* __restrict__ bits,
                                   uint8_t* __restrict__ out,
                                   int n_rows, int n_cols, int n_hashes,
                                   uint32_t m_bits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int32_t* key = ids + static_cast<size_t>(row) * n_cols;
  uint32_t h1 = 0x0000A5A5u;
  uint32_t h2 = 0x00005EEDu;
  for (int i = 0; i < n_cols; ++i) {
    // per-column salt (i + 1) * golden ratio, wrapping at 2**32
    const uint32_t k = static_cast<uint32_t>(__ldg(key + i)) ^
                       (static_cast<uint32_t>(i + 1) * 0x9E3779B9u);
    h1 = mix_round(h1, k);
    h2 = mix_round(h2, k);
  }
  h1 = fmix32(h1 ^ static_cast<uint32_t>(n_cols));
  h2 = fmix32(h2 ^ static_cast<uint32_t>(n_cols)) | 1u;
  uint32_t hit = 1u;
  for (int k = 0; k < n_hashes; ++k) {
    const uint32_t pos = (h1 + static_cast<uint32_t>(k) * h2) % m_bits;
    const uint32_t word = __ldg(bits + (pos >> 5));
    hit &= (word >> (pos & 31u)) & 1u;
  }
  out[row] = static_cast<uint8_t>(hit);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int bloom_query_launch(const void* ids, const void* bits,
                                  void* out, int n_rows, int n_cols,
                                  int n_hashes, unsigned int m_bits,
                                  void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int blocks = (n_rows + threads - 1) / threads;
  bloom_query_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const uint32_t*>(bits),
      static_cast<uint8_t*>(out), n_rows, n_cols, n_hashes, m_bits);
  return static_cast<int>(cudaGetLastError());
}
