// Kernel K2: the whole merge-resolve as one op — merge-order sort, key
// boundaries, LSM resolution with the uint64-add fold, stream compaction.
//
// Replaces rocksplicator_tpu/ops/pallas_resolve.py fused_merge_resolve (the
// pallas_call at :277), whose body _fused_kernel keeps every lane in VMEM
// and expresses scans and fills as shift ladders. Here the phases are a
// sequence of kernels on one stream over lanes in device memory:
//   1. build the composite lanes (invalid, key words, [klen], [~seq_hi],
//      ~seq_lo, then vtype, val_len, value words) and the uniform-klen
//      constant (max key length over valid rows);
//   2. sort them with the K1 bitonic network (bitonic_sort.cuh);
//   3. one boundary pass: new_key / last_key, segment-start index, base flag;
//   4. the segmented quantities of resolve_decisions: a max-scan of the
//      start index, a sum-scan of base entries, then sum-scans (mod 2^32,
//      exactly the JAX u32 wraparound) of the four 16-bit limbs and the
//      three flag counts; each segment's totals are end - before-start;
//   5. resolve at each segment's representative row, the keep flag;
//   6. stream compaction as an exclusive prefix sum of keep plus a scatter,
//      stable by construction (the order lax.sort(is_stable=True) gives);
//      rows at or past count stay zero (the caller zeroes the outputs).
// Each scan is a block scan per tile and a second level over tile totals;
// no library sort, scan or GEMM.
//
// Bound on the card: memory. The sort dominates (see bitonic_sort.cuh); the
// resolve passes read and write a few lanes each.

#include "bitonic_sort.cuh"

namespace {

constexpr uint32_t kPut = 1, kDelete = 2, kMerge = 3;
constexpr int kKeyWords = 6;
constexpr int kRowThreads = 256;
constexpr int kScanThreads = 512;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kAccLanes = 7;  // 4 limbs, operand, first-base PUT / DELETE

struct Layout {
  int n, num_lanes, num_keys, key_words, val_words;
  int klen_pos, shi_pos;  // -1 when the lane is dropped
  int slo_pos, vt_pos, vlen_pos, vw_pos;
};

struct SumOp {
  static __device__ __forceinline__ uint32_t identity() { return 0u; }
  static __device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
    return a + b;
  }
};

struct MaxOp {
  static __device__ __forceinline__ uint32_t identity() { return 0u; }
  static __device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
    return a > b ? a : b;
  }
};

// Exclusive block scan of one value per thread; *total gets the block's
// reduction. `warp_sums` is 32 words of shared memory.
template <class Op>
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* warp_sums,
                                         uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = Op::apply(y, incl);
  }
  uint32_t excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = Op::identity();
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < nwarps ? warp_sums[lane] : Op::identity();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = Op::apply(y, w);
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) excl = Op::apply(warp_sums[warp - 1], excl);
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return excl;
}

// Level 1: inclusive scan inside each tile of kScanTile rows, per lane
// (blockIdx.y); the tile's total goes to tiles[lane * ntiles + tile].
template <class Op>
__global__ void scan_tiles(uint32_t* data, uint32_t* tiles, int n,
                           int ntiles) {
  __shared__ uint32_t warp_sums[32];
  uint32_t* p = data + (int64_t)blockIdx.y * n;
  const int64_t base =
      (int64_t)blockIdx.x * kScanTile + (int64_t)threadIdx.x * kScanItems;
  uint32_t x[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    x[k] = base + k < n ? p[base + k] : Op::identity();
#pragma unroll
  for (int k = 1; k < kScanItems; ++k) x[k] = Op::apply(x[k - 1], x[k]);
  uint32_t total;
  const uint32_t excl =
      block_exclusive_scan<Op>(x[kScanItems - 1], warp_sums, &total);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    if (base + k < n) p[base + k] = Op::apply(excl, x[k]);
  if (threadIdx.x == 0) tiles[(int64_t)blockIdx.y * ntiles + blockIdx.x] = total;
}

// Level 2: exclusive scan of the tile totals of each lane (one block each).
template <class Op>
__global__ void scan_totals(uint32_t* tiles, int ntiles) {
  __shared__ uint32_t warp_sums[32];
  uint32_t* p = tiles + (int64_t)blockIdx.x * ntiles;
  uint32_t carry = Op::identity();
  for (int c = 0; c < ntiles; c += blockDim.x) {
    const int t = c + threadIdx.x;
    const uint32_t v = t < ntiles ? p[t] : Op::identity();
    uint32_t total;
    const uint32_t excl = block_exclusive_scan<Op>(v, warp_sums, &total);
    if (t < ntiles) p[t] = Op::apply(carry, excl);
    carry = Op::apply(carry, total);
  }
}

// Level 3: fold each tile's prefix into its rows.
template <class Op>
__global__ void scan_add(uint32_t* data, const uint32_t* tiles, int n,
                         int ntiles) {
  if (blockIdx.x == 0) return;
  uint32_t* p = data + (int64_t)blockIdx.y * n;
  const uint32_t prefix = tiles[(int64_t)blockIdx.y * ntiles + blockIdx.x];
  const int64_t base =
      (int64_t)blockIdx.x * kScanTile + (int64_t)threadIdx.x * kScanItems;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    if (base + k < n) p[base + k] = Op::apply(prefix, p[base + k]);
}

// Inclusive scan of `m` lanes of n rows each, in place.
template <class Op>
cudaError_t scan_lanes(uint32_t* data, int m, int n, uint32_t* tiles,
                       cudaStream_t s) {
  const int ntiles = (n + kScanTile - 1) / kScanTile;
  scan_tiles<Op><<<dim3(ntiles, m), kScanThreads, 0, s>>>(data, tiles, n,
                                                          ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_totals<Op><<<m, kScanThreads, 0, s>>>(tiles, ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_add<Op><<<dim3(ntiles, m), kScanThreads, 0, s>>>(data, tiles, n,
                                                        ntiles);
  return cudaGetLastError();
}

__device__ __forceinline__ uint32_t lane_at(const uint32_t* lanes,
                                            const Layout& L, int pos,
                                            int64_t i) {
  return lanes[(int64_t)pos * L.n + i];
}

__device__ __forceinline__ bool row_valid(const uint32_t* lanes,
                                          const Layout& L, int64_t i) {
  return lane_at(lanes, L, 0, i) == 0;
}

__device__ __forceinline__ bool row_is_base(const uint32_t* lanes,
                                            const Layout& L, int64_t i) {
  const uint32_t vt = lane_at(lanes, L, L.vt_pos, i);
  return row_valid(lanes, L, i) && (vt == kPut || vt == kDelete);
}

// new_key: row 0, an invalid row, or a key (words [, length]) differing
// from the previous row's.
__device__ bool row_new_key(const uint32_t* lanes, const Layout& L,
                            int64_t i) {
  if (i == 0 || !row_valid(lanes, L, i)) return true;
  for (int w = 0; w < L.key_words; ++w)
    if (lane_at(lanes, L, 1 + w, i) != lane_at(lanes, L, 1 + w, i - 1))
      return true;
  return L.klen_pos >= 0 && lane_at(lanes, L, L.klen_pos, i) !=
                                lane_at(lanes, L, L.klen_pos, i - 1);
}

__global__ void build_lanes(const uint32_t* __restrict__ kw_be,
                            const uint32_t* __restrict__ key_len,
                            const uint32_t* __restrict__ seq_hi,
                            const uint32_t* __restrict__ seq_lo,
                            const uint32_t* __restrict__ vtype,
                            const uint32_t* __restrict__ val_words,
                            const uint32_t* __restrict__ val_len,
                            const uint8_t* __restrict__ valid, Layout L,
                            uint32_t* __restrict__ lanes,
                            uint32_t* __restrict__ meta) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t kl = 0;
  if (i < L.n) {
    const bool v = valid[i] != 0;
    uint32_t* out = lanes + i;
    const int64_t n = L.n;
    out[0] = v ? 0u : 1u;
    for (int w = 0; w < L.key_words; ++w)
      out[(1 + w) * n] = kw_be[i * kKeyWords + w];
    if (L.klen_pos >= 0) out[L.klen_pos * n] = key_len[i];
    if (L.shi_pos >= 0) out[L.shi_pos * n] = ~seq_hi[i];
    out[L.slo_pos * n] = ~seq_lo[i];
    out[L.vt_pos * n] = vtype[i];
    out[L.vlen_pos * n] = val_len[i];
    for (int w = 0; w < L.val_words; ++w)
      out[(L.vw_pos + w) * n] = val_words[i * L.val_words + w];
    kl = v ? key_len[i] : 0u;
  }
  kl = __reduce_max_sync(0xffffffffu, kl);
  if ((threadIdx.x & 31) == 0 && kl) atomicMax(meta + 2, kl);
}

__global__ void boundaries(const uint32_t* __restrict__ lanes, Layout L,
                           uint32_t* __restrict__ flags,
                           uint32_t* __restrict__ start,
                           uint32_t* __restrict__ base) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L.n) return;
  const bool nk = row_new_key(lanes, L, i);
  const bool lk = i == L.n - 1 || row_new_key(lanes, L, i + 1);
  flags[i] = (nk ? 1u : 0u) | (lk ? 2u : 0u);
  start[i] = nk ? (uint32_t)i : 0u;
  base[i] = row_is_base(lanes, L, i) ? 1u : 0u;
}

// Per row: operand / first-base flags and the contributing limbs; each
// segment's last row records its index at the segment's start.
__global__ void limbs(const uint32_t* __restrict__ lanes, Layout L,
                      const uint32_t* __restrict__ flags,
                      const uint32_t* __restrict__ start,
                      const uint32_t* __restrict__ base_incl,
                      uint32_t* __restrict__ acc,
                      uint32_t* __restrict__ endof) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L.n) return;
  const int64_t n = L.n;
  const uint32_t s = start[i];
  const bool valid = row_valid(lanes, L, i);
  const uint32_t vt = lane_at(lanes, L, L.vt_pos, i);
  const bool is_base = row_is_base(lanes, L, i);
  const uint32_t base_before = (base_incl[i] - (is_base ? 1u : 0u)) -
                               (base_incl[s] - (row_is_base(lanes, L, s) ? 1u : 0u));
  const bool is_put = valid && vt == kPut;
  const bool is_del = valid && vt == kDelete;
  const bool operand = valid && vt == kMerge && base_before == 0;
  const bool first_base = is_base && base_before == 0;
  const bool contrib = (operand || (first_base && is_put)) &&
                       lane_at(lanes, L, L.vlen_pos, i) == 8u;
  const uint32_t lo = lane_at(lanes, L, L.vw_pos, i);
  const uint32_t hi = L.val_words > 1 ? lane_at(lanes, L, L.vw_pos + 1, i) : 0u;
  acc[0 * n + i] = contrib ? (lo & 0xFFFFu) : 0u;
  acc[1 * n + i] = contrib ? (lo >> 16) : 0u;
  acc[2 * n + i] = contrib ? (hi & 0xFFFFu) : 0u;
  acc[3 * n + i] = contrib ? (hi >> 16) : 0u;
  acc[4 * n + i] = operand ? 1u : 0u;
  acc[5 * n + i] = (first_base && is_put) ? 1u : 0u;
  acc[6 * n + i] = (first_base && is_del) ? 1u : 0u;
  if (flags[i] & 2u) endof[s] = (uint32_t)i;
}

// Resolve each segment at its representative (first, newest) row: the
// resolved vtype / value are written into the sorted lanes in place, and
// keep marks the rows that survive.
__global__ void resolve(uint32_t* __restrict__ lanes, Layout L,
                        const uint32_t* __restrict__ flags,
                        const uint32_t* __restrict__ acc,
                        const uint32_t* __restrict__ endof,
                        uint32_t* __restrict__ keep,
                        uint32_t* __restrict__ meta, int uint64_add,
                        int drop_tombstones) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L.n) return;
  const int64_t n = L.n;
  if (!((flags[i] & 1u) && row_valid(lanes, L, i))) {
    keep[i] = 0u;
    return;
  }
  uint32_t* vt_lane = lanes + (int64_t)L.vt_pos * n;
  const uint32_t vt = vt_lane[i];
  if (!uint64_add) {
    keep[i] = (drop_tombstones && vt == kDelete) ? 0u : 1u;
    return;
  }
  const uint32_t e = endof[i];
  uint32_t tot[kAccLanes];
#pragma unroll
  for (int q = 0; q < kAccLanes; ++q)
    tot[q] = acc[q * n + e] - (i > 0 ? acc[q * n + i - 1] : 0u);
  const bool has_ops = tot[4] > 0, base_put = tot[5] > 0, base_del = tot[6] > 0;
  if (e - (uint32_t)i + 1u >= (1u << 16)) atomicOr(meta + 1, 1u);
  if (has_ops) {
    // four u32 limb sums -> (lo, hi) with carries; beyond 64 bits wraps
    const uint32_t l0 = tot[0] & 0xFFFFu, c0 = tot[0] >> 16;
    const uint32_t s1 = tot[1] + c0, l1 = s1 & 0xFFFFu, c1 = s1 >> 16;
    const uint32_t s2 = tot[2] + c1, l2 = s2 & 0xFFFFu, c2 = s2 >> 16;
    const uint32_t l3 = (tot[3] + c2) & 0xFFFFu;
    lanes[(int64_t)L.vw_pos * n + i] = l0 | (l1 << 16);
    if (L.val_words > 1) lanes[(int64_t)(L.vw_pos + 1) * n + i] = l2 | (l3 << 16);
    lanes[(int64_t)L.vlen_pos * n + i] = 8u;
  }
  const bool pure = has_ops && !base_put && !base_del;
  const bool resolved_put = base_put || (has_ops && base_del);
  vt_lane[i] = (resolved_put || (pure && drop_tombstones)) ? kPut
               : pure                                      ? kMerge
                                                           : vt;
  const bool dropped = base_del && !has_ops;
  keep[i] = (drop_tombstones && dropped) ? 0u : 1u;
}

__device__ __forceinline__ uint32_t bswap32(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);
}

// Scatter each kept row to its rank (inclusive keep count - 1).
__global__ void compact(const uint32_t* __restrict__ lanes, Layout L,
                        const uint32_t* __restrict__ keep_incl,
                        uint32_t* __restrict__ meta,
                        uint32_t* __restrict__ o_kw_be,
                        uint32_t* __restrict__ o_kw_le,
                        uint32_t* __restrict__ o_key_len,
                        uint32_t* __restrict__ o_seq_hi,
                        uint32_t* __restrict__ o_seq_lo,
                        uint32_t* __restrict__ o_vtype,
                        uint32_t* __restrict__ o_val_words,
                        uint32_t* __restrict__ o_val_len) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L.n) return;
  const uint32_t incl = keep_incl[i];
  if (i == L.n - 1) meta[0] = incl;
  if (incl == (i > 0 ? keep_incl[i - 1] : 0u)) return;
  const int64_t p = incl - 1;
  for (int w = 0; w < L.key_words; ++w) {
    const uint32_t v = lane_at(lanes, L, 1 + w, i);
    o_kw_be[p * kKeyWords + w] = v;
    o_kw_le[p * kKeyWords + w] = bswap32(v);
  }
  o_key_len[p] = L.klen_pos >= 0 ? lane_at(lanes, L, L.klen_pos, i) : meta[2];
  o_seq_hi[p] = L.shi_pos >= 0 ? ~lane_at(lanes, L, L.shi_pos, i) : 0u;
  o_seq_lo[p] = ~lane_at(lanes, L, L.slo_pos, i);
  o_vtype[p] = lane_at(lanes, L, L.vt_pos, i);
  o_val_len[p] = lane_at(lanes, L, L.vlen_pos, i);
  for (int w = 0; w < L.val_words; ++w)
    o_val_words[p * L.val_words + w] = lane_at(lanes, L, L.vw_pos + w, i);
}

Layout make_layout(int n, int val_words, int key_words, int uniform_klen,
                   int seq32) {
  Layout L;
  L.n = n;
  L.key_words = key_words;
  L.val_words = val_words;
  int pos = 1 + key_words;
  L.klen_pos = uniform_klen ? -1 : pos++;
  L.shi_pos = seq32 ? -1 : pos++;
  L.slo_pos = pos++;
  L.num_keys = pos;
  L.vt_pos = pos++;
  L.vlen_pos = pos++;
  L.vw_pos = pos;
  L.num_lanes = pos + val_words;
  return L;
}

int64_t scratch_words(const Layout& L) {
  const int64_t ntiles = (L.n + kScanTile - 1) / kScanTile;
  // lanes, flags, start, base, acc, endof, keep, tile totals
  return (int64_t)L.n * (L.num_lanes + 5 + kAccLanes) + kAccLanes * ntiles;
}

}  // namespace

extern "C" {

const char* rs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int rs_fused_scratch_words(int n, int val_words, int key_words,
                           int uniform_klen, int seq32, int64_t* words) {
  *words = scratch_words(make_layout(n, val_words, key_words, uniform_klen,
                                     seq32));
  return 0;
}

// Inputs: kw_be (n, 6), key_len, seq_hi, seq_lo, vtype, val_words
// (n, val_words), val_len as u32; valid as bytes 0/1. Outputs (zeroed by the
// caller): the same lanes, kw_le (n, 6) besides; meta[0] = count,
// meta[1] = overflow flag, meta[2] = uniform key length (zeroed too).
int rs_fused_merge_resolve(
    const void* kw_be, const void* key_len, const void* seq_hi,
    const void* seq_lo, const void* vtype, const void* val_words,
    const void* val_len, const void* valid, int n, int n_val_words,
    int key_words, int uniform_klen, int seq32, int uint64_add,
    int drop_tombstones, void* o_kw_be, void* o_kw_le, void* o_key_len,
    void* o_seq_hi, void* o_seq_lo, void* o_vtype, void* o_val_words,
    void* o_val_len, void* meta, void* scratch, void* stream) {
  const Layout L =
      make_layout(n, n_val_words, key_words, uniform_klen, seq32);
  if (n < 256 || (n & (n - 1)) != 0 || key_words < 1 ||
      key_words > kKeyWords || n_val_words < 1 ||
      L.num_lanes > rs::kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* m = static_cast<uint32_t*>(meta);
  uint32_t* lanes = static_cast<uint32_t*>(scratch);
  uint32_t* flags = lanes + (int64_t)L.num_lanes * n;
  uint32_t* start = flags + n;
  uint32_t* base = start + n;
  uint32_t* acc = base + n;
  uint32_t* endof = acc + (int64_t)kAccLanes * n;
  uint32_t* keep = endof + n;
  uint32_t* tiles = keep + n;
  const int blocks = (n + kRowThreads - 1) / kRowThreads;
  cudaError_t err;

  build_lanes<<<blocks, kRowThreads, 0, s>>>(
      static_cast<const uint32_t*>(kw_be),
      static_cast<const uint32_t*>(key_len),
      static_cast<const uint32_t*>(seq_hi),
      static_cast<const uint32_t*>(seq_lo),
      static_cast<const uint32_t*>(vtype),
      static_cast<const uint32_t*>(val_words),
      static_cast<const uint32_t*>(val_len),
      static_cast<const uint8_t*>(valid), L, lanes, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = rs::bitonic_sort_device(lanes, L.num_lanes, L.num_keys, n,
                                     s)) != cudaSuccess)
    return err;

  boundaries<<<blocks, kRowThreads, 0, s>>>(lanes, L, flags, start, base);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (uint64_add) {
    if ((err = scan_lanes<MaxOp>(start, 1, n, tiles, s)) != cudaSuccess)
      return err;
    if ((err = scan_lanes<SumOp>(base, 1, n, tiles, s)) != cudaSuccess)
      return err;
    limbs<<<blocks, kRowThreads, 0, s>>>(lanes, L, flags, start, base, acc,
                                         endof);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = scan_lanes<SumOp>(acc, kAccLanes, n, tiles, s)) !=
        cudaSuccess)
      return err;
  }
  resolve<<<blocks, kRowThreads, 0, s>>>(lanes, L, flags, acc, endof, keep, m,
                                         uint64_add, drop_tombstones);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = scan_lanes<SumOp>(keep, 1, n, tiles, s)) != cudaSuccess)
    return err;
  compact<<<blocks, kRowThreads, 0, s>>>(
      lanes, L, keep, m, static_cast<uint32_t*>(o_kw_be),
      static_cast<uint32_t*>(o_kw_le), static_cast<uint32_t*>(o_key_len),
      static_cast<uint32_t*>(o_seq_hi), static_cast<uint32_t*>(o_seq_lo),
      static_cast<uint32_t*>(o_vtype), static_cast<uint32_t*>(o_val_words),
      static_cast<uint32_t*>(o_val_len));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return 0;
}

}  // extern "C"
