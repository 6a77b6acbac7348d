// Kernel K3: bloom bitmap build — hash, word mask and bitmap.
//
// Replaces rocksplicator_tpu/ops/pallas_kernels.py bloom_hash_pallas (the
// pallas_call at :57), which computes only the hash pair, and fuses what the
// JAX package does after it in XLA (ops/bloom_tpu.py bloom_word_mask and
// bloom_build_tpu's sort + segmented OR-scan + scatter-max). The TPU has no
// scatter-OR, so it groups rows by word with a sort; Hopper ORs in place.
//
// Per row: FNV-1a over the 6 little-endian key words and the key length,
// h1 = fmix32(h), h2 = fmix32(h * H2_MUL + 1), mask = OR over j < K_BITS of
// 1 << ((h2 >> 5j) & 31), ORed into word h1 % num_words of its shard's
// bitmap with atomicOr (it lands in L2). The key words load as three 8-byte
// vectors. OR does not depend on order, so both routes give the plain
// version's bits exactly.
//
// Two routes; the wrapper's plan (ops/bloom_kernel.py plan_bloom) names
// one by shape and the C entries check it and refuse one that does not
// fit. They never pick a route themselves.
//
// global (S bitmaps): a cooperative persistent grid zeroes the bitmaps,
//   syncs, then takes every shard's live rows as one flat range (a flat
//   index maps to its shard through the counts' prefix sums in shared
//   memory), so no thread is spent on a padded row past its shard's count.
//   One launch.
// rowwise (one bitmap): a memset, then one thread per row; a row with a
//   0 valid byte only exits. With no padded shards to skip, the memset
//   costs less than the grid's sync (PERF.md, K3 route sweep). Two
//   launches.
//
// Bound on the card: memory — 7 words per live row read once, the counts
// or valid bytes, the bitmaps written once.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kH2Mul = 0x9E3779B1u;
constexpr int kKBits = 6;
// the global route keeps the shards' prefix sums in (default) shared memory
constexpr size_t kMaxPrefixBytes = 48 * 1024;

constexpr int kErrShape = -1;
constexpr int kErrPlan = -2;
constexpr int kErrFit = -3;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// (word index, mask) of row i: its 6 key words are 24 bytes at an 8-byte
// aligned offset, read as three 8-byte vectors.
__device__ __forceinline__ uint32_t row_mask(const uint32_t* __restrict__ kw,
                                             const uint32_t* __restrict__ kl,
                                             int64_t i, uint32_t num_words,
                                             uint32_t* word) {
  const uint2* w = reinterpret_cast<const uint2*>(kw + i * 6);
  const uint2 a = __ldg(w), b = __ldg(w + 1), c = __ldg(w + 2);
  uint32_t h = kFnvOffset;
  h = (h ^ a.x) * kFnvPrime;
  h = (h ^ a.y) * kFnvPrime;
  h = (h ^ b.x) * kFnvPrime;
  h = (h ^ b.y) * kFnvPrime;
  h = (h ^ c.x) * kFnvPrime;
  h = (h ^ c.y) * kFnvPrime;
  h = (h ^ __ldg(kl + i)) * kFnvPrime;
  const uint32_t h2 = fmix32(h * kH2Mul + 1u);
  *word = fmix32(h) % num_words;
  uint32_t mask = 0;
#pragma unroll
  for (int j = 0; j < kKBits; ++j) mask |= 1u << ((h2 >> (5 * j)) & 31u);
  return mask;
}

// The live rows of shard s: rows [0, live) of its seg rows.
__device__ __forceinline__ int64_t live_rows(const uint32_t* count, int64_t s,
                                             int64_t seg) {
  if (!count) return seg;
  const int64_t c = __ldg(count + s);
  return c < seg ? c : seg;
}

// A cooperative grid: zero all shards' bitmaps, sync, then OR every live
// row, the shards' live rows taken as ONE flat range (each block maps a
// flat index to its shard through the counts' prefix sums in shared
// memory), two rows a thread an iteration.
__global__ void bloom_global_kernel(const uint32_t* __restrict__ kw,
                                    const uint32_t* __restrict__ kl,
                                    const uint8_t* __restrict__ valid,
                                    const uint32_t* __restrict__ count,
                                    int64_t shards, int64_t seg,
                                    uint32_t num_words,
                                    uint32_t* __restrict__ bitmap) {
  extern __shared__ int64_t first_row[];  // shards + 1 prefix sums
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t total = shards * (int64_t)num_words;
  uint4* v = reinterpret_cast<uint4*>(bitmap);  // 16-byte aligned
  for (int64_t j = tid; j < total / 4; j += stride)
    v[j] = make_uint4(0, 0, 0, 0);
  for (int64_t j = total / 4 * 4 + tid; j < total; j += stride) bitmap[j] = 0;
  for (int64_t t = threadIdx.x; t < shards; t += blockDim.x)
    first_row[t + 1] = live_rows(count, t, seg);
  __syncthreads();
  if (threadIdx.x == 0) {
    first_row[0] = 0;
    for (int64_t t = 1; t <= shards; ++t) first_row[t] += first_row[t - 1];
  }
  grid.sync();  // the bitmaps are zero (and this block's sums are done)
  const int64_t rows = first_row[shards];
  for (int64_t i = tid; i < rows; i += 2 * stride) {
    uint32_t w[2] = {0, 0}, m[2] = {0, 0};
    int64_t sh[2] = {0, 0};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int64_t f = i + k * stride;
      if (f >= rows) break;
      int64_t lo = 0, hi = shards;  // the last shard whose first row <= f
      while (hi - lo > 1) {
        const int64_t mid = (lo + hi) / 2;
        if (first_row[mid] <= f) lo = mid; else hi = mid;
      }
      const int64_t row = lo * seg + (f - first_row[lo]);
      if (valid && !valid[row]) continue;
      sh[k] = lo;
      m[k] = row_mask(kw, kl, row, num_words, &w[k]);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (m[k]) atomicOr(bitmap + sh[k] * (int64_t)num_words + w[k], m[k]);
  }
}

// One thread per row of S * seg: row r of shard s is live when r < its
// count (or its valid byte is 1); the bitmaps are zero already.
__global__ void bloom_rowwise_kernel(const uint32_t* __restrict__ kw,
                                     const uint32_t* __restrict__ kl,
                                     const uint8_t* __restrict__ valid,
                                     const uint32_t* __restrict__ count,
                                     int64_t n, int64_t seg,
                                     uint32_t num_words,
                                     uint32_t* __restrict__ bitmap) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = i / seg;
  if (valid ? !valid[i] : i - s * seg >= live_rows(count, s, seg)) return;
  uint32_t w = 0;
  const uint32_t m = row_mask(kw, kl, i, num_words, &w);
  atomicOr(bitmap + s * (int64_t)num_words + w, m);
}

int launch(const void* kw, const void* kl, const void* valid,
           const void* count, int64_t shards, int64_t seg, int num_words,
           int route, int blocks, int threads, void* bitmap, int* launches,
           void* stream) {
  if (shards < 0 || seg < 1 || num_words < 1) return kErrShape;
  if (threads < 32 || threads > 1024 || threads % 32 || blocks < 1)
    return kErrPlan;
  if (shards == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kw_p = static_cast<const uint32_t*>(kw);
  auto kl_p = static_cast<const uint32_t*>(kl);
  auto valid_p = static_cast<const uint8_t*>(valid);
  auto count_p = static_cast<const uint32_t*>(count);
  auto out = static_cast<uint32_t*>(bitmap);
  uint32_t nw = static_cast<uint32_t>(num_words);
  if (route == 1) {
    // the plan's grid must cover every row, one thread each
    const int64_t n = shards * seg;
    if ((int64_t)blocks * threads < n) return kErrPlan;
    cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(uint32_t) * shards * (int64_t)num_words, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    *launches += 1;
    bloom_rowwise_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        kw_p, kl_p, valid_p, count_p, n, seg, nw, out);
  } else if (route == 0) {
    // the plan's grid must be co-resident: the kernel syncs it
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    const size_t prefix_bytes = sizeof(int64_t) * (shards + 1);
    if (prefix_bytes > kMaxPrefixBytes) return kErrShape;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bloom_global_kernel, threads, prefix_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((int64_t)blocks > (int64_t)sms * per_sm) return kErrFit;
    int64_t shards64 = shards, seg64 = seg;
    void* args[] = {&kw_p, &kl_p, &valid_p, &count_p, &shards64, &seg64,
                    &nw, &out};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(bloom_global_kernel), dim3(blocks),
        dim3(threads), args, prefix_bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    return kErrPlan;
  }
  *launches += 1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rs_error_string(int err) {
  switch (err) {
    case kErrShape: return "shape refused";
    case kErrPlan: return "bloom plan refused";
    case kErrFit: return "the plan's grid does not fit on this card";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

// kw_le: (n, 6) u32; key_len: (n,) u32; valid: (n,) bytes 0/1; bitmap:
// (num_words,) u32, written whole (no fill needed). The plan (route 0
// global / 1 rowwise, blocks, threads) comes from ops/bloom_kernel.py
// plan_bloom. Adds its CUDA launches to *launches.
int rs_bloom_build(const void* kw_le, const void* key_len, const void* valid,
                   int n, int num_words, int route, int blocks, int threads,
                   void* bitmap, int* launches, void* stream) {
  if (n < 1) return kErrShape;
  return launch(kw_le, key_len, valid, nullptr, 1, n, num_words, route,
                blocks, threads, bitmap, launches, stream);
}

// S shards of seg rows: kw_le (S * seg, 6) u32, key_len (S * seg,) u32,
// count (S,) u32 on the device (row r of shard s is live when r <
// count[s]); bitmap (S, num_words) u32, written whole.
int rs_bloom_build_batched(const void* kw_le, const void* key_len,
                           const void* count, int shards, int seg,
                           int num_words, int route, int blocks,
                           int threads, void* bitmap, int* launches,
                           void* stream) {
  return launch(kw_le, key_len, nullptr, count, shards, seg, num_words, route,
                blocks, threads, bitmap, launches, stream);
}

}  // extern "C"
