// Kernel K3: bloom bitmap build — hash, word mask and bitmap in one pass.
//
// Replaces rocksplicator_tpu/ops/pallas_kernels.py bloom_hash_pallas (the
// pallas_call at :57), which computes only the hash pair, and fuses what the
// JAX package does after it in XLA (ops/bloom_tpu.py bloom_word_mask and
// bloom_build_tpu's sort + segmented OR-scan + scatter-max). The TPU has no
// scatter-OR, so it groups rows by word with a sort; Hopper has atomicOr on
// device memory, so each row ORs its mask straight into its word.
//
// One thread per row: FNV-1a over the 6 little-endian key words and the key
// length, h1 = fmix32(h), h2 = fmix32(h * H2_MUL + 1), mask = OR over
// j < K_BITS of 1 << ((h2 >> 5j) & 31), then atomicOr(bitmap[h1 % words])
// for valid rows only. Invalid rows set nothing (the JAX version sends them
// to a spill word it drops). The bitmap must be zeroed by the caller.
//
// A shard axis: rs_bloom_build_batched takes S shards of C rows and builds
// S bitmaps of num_words in one launch; row r of shard s is valid when r <
// count[s], read on the device (the counts K2 left there), so nothing is
// read back first.
//
// Bound on the card: memory — 6+1 words and one flag byte (or one count)
// read per row, the bitmap written once; the atomics hit L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kH2Mul = 0x9E3779B1u;
constexpr int kKeyWords = 6;
constexpr int kKBits = 6;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Rows are shards of `seg` rows; row i is valid when valid[i] (a byte
// mask) or, with valid null, when i % seg < count[i / seg]. Shard s ORs
// into bitmap[s * num_words ...].
__global__ void bloom_build_kernel(const uint32_t* __restrict__ kw_le,
                                   const uint32_t* __restrict__ key_len,
                                   const uint8_t* __restrict__ valid,
                                   const uint32_t* __restrict__ count,
                                   int64_t n, int64_t seg, uint32_t num_words,
                                   uint32_t* __restrict__ bitmap) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = i / seg;
  if (valid ? !valid[i] : (uint64_t)(i - s * seg) >= __ldg(count + s))
    return;
  uint32_t h = kFnvOffset;
  const uint32_t* w = kw_le + (int64_t)i * kKeyWords;
#pragma unroll
  for (int k = 0; k < kKeyWords; ++k) h = (h ^ w[k]) * kFnvPrime;
  h = (h ^ key_len[i]) * kFnvPrime;
  const uint32_t h1 = fmix32(h);
  const uint32_t h2 = fmix32(h * kH2Mul + 1u);
  uint32_t mask = 0;
#pragma unroll
  for (int j = 0; j < kKBits; ++j) mask |= 1u << ((h2 >> (5 * j)) & 31u);
  atomicOr(bitmap + s * num_words + (h1 % num_words), mask);
}

}  // namespace

extern "C" {

const char* rs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kw_le: (n, 6) u32; key_len: (n,) u32; valid: (n,) bytes 0/1;
// bitmap: (num_words,) u32, zeroed.
int rs_bloom_build(const void* kw_le, const void* key_len, const void* valid,
                   int n, int num_words, void* bitmap, void* stream) {
  if (n < 0 || num_words < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  bloom_build_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(kw_le),
      static_cast<const uint32_t*>(key_len),
      static_cast<const uint8_t*>(valid), nullptr, n, n,
      static_cast<uint32_t>(num_words), static_cast<uint32_t*>(bitmap));
  return static_cast<int>(cudaGetLastError());
}

// S shards of seg rows: kw_le (S * seg, 6) u32, key_len (S * seg,) u32,
// count (S,) u32 on the device; bitmap (S, num_words) u32, zeroed.
int rs_bloom_build_batched(const void* kw_le, const void* key_len,
                           const void* count, int shards, int seg,
                           int num_words, void* bitmap, void* stream) {
  if (shards < 0 || seg < 1 || num_words < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = (int64_t)shards * seg;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  bloom_build_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(kw_le),
      static_cast<const uint32_t*>(key_len), nullptr,
      static_cast<const uint32_t*>(count), n, seg,
      static_cast<uint32_t>(num_words), static_cast<uint32_t*>(bitmap));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
