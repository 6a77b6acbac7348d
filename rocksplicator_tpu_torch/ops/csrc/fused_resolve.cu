// Kernel K2: the whole merge-resolve as one op — merge-order sort, key
// boundaries, LSM resolution with the uint64-add fold, stream compaction.
//
// Replaces rocksplicator_tpu/ops/pallas_resolve.py fused_merge_resolve (the
// pallas_call at :277), whose body _fused_kernel keeps every lane in VMEM
// and expresses scans and fills as shift ladders. Here one call is 4 +
// passes (+ gathers) CUDA launches on one stream:
//   0. one cudaMemsetAsync of the status words (tile counter, per-shard
//      meta, look-back flags);
//   1. build_keys: the composite key lanes (invalid, key words, [klen],
//      [~seq_hi], ~seq_lo) and each shard's uniform-klen constant (max key
//      length over its valid rows);
//   2. the K1 merge sort (merge_sort.cuh) over those keys and a row index;
//      its last launch gathers the payload (vtype, val_len, value words)
//      straight from the inputs into sorted order, 16 lanes of it, and
//      gather_lanes launches move the rest of a wide value 16 lanes at a
//      time, so values of any width W go through;
//   3. resolve_compact, one pass with two single-pass scans with decoupled
//      look-back, a warp reading 32 earlier tiles at a time (tile ids from
//      an atomic counter, so no block waits on one that has not started):
//      - a segmented scan whose state per key segment is (start index,
//        "first PUT/DELETE seen", 4 u32 limb sums, operand / first-base
//        PUT / first-base DELETE counts); rows after a segment's first
//        PUT/DELETE add nothing, which is resolve_decisions' base_before
//        == 0 rule. Each segment resolves at its LAST row, where the
//        inclusive state holds its totals; the limb sums wrap mod 2^32
//        exactly as the JAX u32 arithmetic does;
//      - a sum scan of keep over those last rows: rank of each kept row,
//        in sorted order (the stable compaction of lax.sort(is_stable));
//      - the kept row (the segment's first, newest row, resolved) is
//        written at its rank; each tile zeroes its share of the rows at or
//        past count, so the outputs need no fill.
// A shard axis (the counterpart of jax.vmap over merge_resolve_kernel): S
// shards of capacity C come as S * C rows with segment = C. The sort's
// passes stop at runs of C rows, so each shard sorts in place; a resolve
// tile is at most C rows (256 threads x 8, or C / 8 threads), so no tile
// spans two shards; a key segment starts at every shard start; both
// look-backs stop at the shard's first tile, so the keep ranks restart per
// shard; count, overflow flag and key length are per shard. One call
// compacts the whole group. Unbatched, segment = n and S = 1.
// No library sort, scan or GEMM.
//
// Bound on the card: memory and launches. The sort dominates (see
// merge_sort.cuh); resolve_compact reads each sorted lane about once and
// writes each output once.

#include <vector>

#include "merge_sort.cuh"

namespace {

constexpr uint32_t kPut = 1, kDelete = 2, kMerge = 3;
constexpr int kKeyWords = 6;
constexpr int kRowThreads = 256;
constexpr int kResolveThreads = 256;
constexpr int kResolveRows = kResolveThreads * rs::kItems;
constexpr int kAccLanes = 7;  // 4 limbs, operand, first-base PUT / DELETE
constexpr int kSegWords = 2 + kAccLanes;
constexpr int kStatusHead = 4;  // the tile counter, then padding
constexpr int kMetaWords = 4;   // per shard: count, overflow, klen, unused

struct Layout {
  int n, num_lanes, num_keys, key_words, val_words;
  int klen_pos, shi_pos;  // -1 when the lane is dropped
  int slo_pos, vt_pos, vlen_pos, vw_pos;
  int seg;                // rows of one shard (n when unbatched)
  int tile_rows;          // rows of one resolve tile: min(seg, 2048)
};

struct Outputs {
  uint32_t *kw_be, *kw_le, *key_len, *seq_hi, *seq_lo, *vtype, *val_words,
      *val_len;
};

// Summary of a run of rows for the segment open at its end. flags bit 0: a
// segment starts in the run; bit 1: that segment's first PUT/DELETE was
// seen (later rows add nothing). An all-zero Seg is the identity.
struct Seg {
  uint32_t flags, start;
  uint32_t s[kAccLanes];
};

__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  Seg r;
  r.start = a.start > b.start ? a.start : b.start;
  r.flags = (a.flags | b.flags) & 1u;
  if (b.flags & 1u) {
    r.flags |= b.flags & 2u;
#pragma unroll
    for (int q = 0; q < kAccLanes; ++q) r.s[q] = b.s[q];
  } else if (a.flags & 2u) {
    r.flags |= 2u;
#pragma unroll
    for (int q = 0; q < kAccLanes; ++q) r.s[q] = a.s[q];
  } else {
    r.flags |= b.flags & 2u;
#pragma unroll
    for (int q = 0; q < kAccLanes; ++q) r.s[q] = a.s[q] + b.s[q];
  }
  return r;
}

__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  return a + b;
}

__device__ __forceinline__ Seg shfl_up(const Seg& v, int o) {
  Seg r;
  r.flags = __shfl_up_sync(0xffffffffu, v.flags, o);
  r.start = __shfl_up_sync(0xffffffffu, v.start, o);
#pragma unroll
  for (int q = 0; q < kAccLanes; ++q)
    r.s[q] = __shfl_up_sync(0xffffffffu, v.s[q], o);
  return r;
}

__device__ __forceinline__ uint32_t shfl_up(uint32_t v, int o) {
  return __shfl_up_sync(0xffffffffu, v, o);
}

__device__ __forceinline__ Seg shfl_idx(const Seg& v, int src) {
  Seg r;
  r.flags = __shfl_sync(0xffffffffu, v.flags, src);
  r.start = __shfl_sync(0xffffffffu, v.start, src);
#pragma unroll
  for (int q = 0; q < kAccLanes; ++q)
    r.s[q] = __shfl_sync(0xffffffffu, v.s[q], src);
  return r;
}

__device__ __forceinline__ uint32_t shfl_idx(uint32_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

// Look-back values bypass L1, which is not coherent across SMs.
__device__ __forceinline__ Seg load_cg(const Seg* p) {
  Seg r;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  r.flags = __ldcg(w);
  r.start = __ldcg(w + 1);
#pragma unroll
  for (int q = 0; q < kAccLanes; ++q) r.s[q] = __ldcg(w + 2 + q);
  return r;
}

__device__ __forceinline__ uint32_t load_cg(const uint32_t* p) {
  return __ldcg(p);
}

__device__ __forceinline__ void store_cg(Seg* p, const Seg& v) {
  uint32_t* w = reinterpret_cast<uint32_t*>(p);
  __stcg(w, v.flags);
  __stcg(w + 1, v.start);
#pragma unroll
  for (int q = 0; q < kAccLanes; ++q) __stcg(w + 2 + q, v.s[q]);
}

__device__ __forceinline__ void store_cg(uint32_t* p, uint32_t v) {
  __stcg(p, v);
}

// Exclusive scan of one value per thread over the block; *total gets the
// block's reduction. `tot` is 33 entries of shared memory.
template <class T>
__device__ T block_exclusive_scan(T v, T* tot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = shfl_up(incl, o);
    if (lane >= o) incl = combine(y, incl);
  }
  T excl = shfl_up(incl, 1);
  if (lane == 0) excl = T{};
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    T run{};
    for (int w = 0; w < nwarps; ++w) {
      const T x = tot[w];
      tot[w] = run;
      run = combine(run, x);
    }
    tot[32] = run;
  }
  __syncthreads();
  excl = combine(tot[warp], excl);
  *total = tot[32];
  __syncthreads();
  return excl;
}

// Decoupled look-back, by the block's first warp: publishes the tile's
// aggregate, then reads the flags of the 32 tiles before a window's end at
// once, folds the window back to its nearest tile that has an inclusive
// prefix (or moves the window 32 tiles back), publishes its own inclusive
// prefix and returns the prefix of the tiles before it, back to `first`,
// the first tile of its shard. flags[t]: 0 nothing yet, 1 aggregate, 2
// inclusive prefix. Every lane returns it.
template <class T>
__device__ T look_back(int tile, int first, const T& agg,
                       volatile uint32_t* flags, T* aggs, T* incls) {
  const int lane = threadIdx.x & 31;
  if (tile > first && lane == 0) {
    store_cg(aggs + tile, agg);
    __threadfence();
    flags[tile] = 1u;
  }
  T prefix{};
  for (int end = tile; end > first; end -= 32) {
    const int t = end - 32 + lane;  // lane 31 is the nearest tile
    uint32_t f = 2u;                // tiles before first: the identity
    if (t >= first) {
      do {
        f = flags[t];
      } while (f == 0u);
    }
    __threadfence();
    T v{};
    if (t >= first) v = f == 2u ? load_cg(incls + t) : load_cg(aggs + t);
    const unsigned done = __ballot_sync(0xffffffffu, f == 2u);
    if (done && lane < 31 - __clz(done)) v = T{};
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = shfl_up(v, o);
      if (lane >= o) v = combine(y, v);
    }
    prefix = combine(shfl_idx(v, 31), prefix);
    if (done) break;
  }
  if (lane == 0) {
    store_cg(incls + tile, combine(prefix, agg));
    __threadfence();
    flags[tile] = 2u;
  }
  return prefix;
}

__device__ __forceinline__ uint32_t lane_at(const uint32_t* lanes,
                                            const Layout& L, int pos,
                                            int64_t i) {
  return lanes[(int64_t)pos * L.n + i];
}

// A thread's kItems consecutive rows, read once with 16-byte loads.
struct Rows {
  uint32_t starts;   // bit k: row k starts a key; bit kItems: the next row
  uint32_t invalid;  // bit k: row k is padding
  uint32_t vt[rs::kItems], vlen[rs::kItems], lo[rs::kItems], hi[rs::kItems];
};

__device__ __forceinline__ void load_rows(const uint32_t* p,
                                          uint32_t (&v)[rs::kItems]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Rows row0 .. row0 + kItems - 1 (row0 < n, a multiple of kItems). A row
// starts a key when it starts a shard, is padding, or its key (words [,
// length]) differs from the row before; the row at a shard's end counts as
// a start.
__device__ Rows read_rows(const uint32_t* lanes, const Layout& L,
                          int64_t row0, bool uint64_add) {
  static_assert(rs::kItems == 8, "read_rows loads two uint4 per lane");
  Rows R;
  const int64_t n = L.n;
  const bool has_next = row0 + rs::kItems < n;
  uint32_t v[rs::kItems];
  load_rows(lanes + row0, v);
  R.invalid = 0u;
#pragma unroll
  for (int k = 0; k < rs::kItems; ++k) R.invalid |= (uint32_t)(v[k] != 0u) << k;
  uint32_t starts = R.invalid | (row0 % L.seg == 0 ? 1u : 0u);
  if (!has_next || (row0 + rs::kItems) % L.seg == 0 ||
      lanes[row0 + rs::kItems] != 0u)
    starts |= 1u << rs::kItems;
  // key word lanes, then the length lane when it is kept: lanes 1 ..
  const int key_lanes = L.key_words + (L.klen_pos >= 0 ? 1 : 0);
  for (int w = 0; w < key_lanes; ++w) {
    const uint32_t* p = lanes + (int64_t)(1 + w) * n;
    load_rows(p + row0, v);
    const uint32_t prev = row0 > 0 ? p[row0 - 1] : v[0];
    uint32_t diff = (uint32_t)(v[0] != prev);
#pragma unroll
    for (int k = 1; k < rs::kItems; ++k)
      diff |= (uint32_t)(v[k] != v[k - 1]) << k;
    if (has_next)
      diff |= (uint32_t)(p[row0 + rs::kItems] != v[rs::kItems - 1])
              << rs::kItems;
    starts |= diff;
  }
  R.starts = starts;
  if (uint64_add) {
    load_rows(lanes + (int64_t)L.vt_pos * n + row0, R.vt);
    load_rows(lanes + (int64_t)L.vlen_pos * n + row0, R.vlen);
    load_rows(lanes + (int64_t)L.vw_pos * n + row0, R.lo);
    if (L.val_words > 1) {
      load_rows(lanes + (int64_t)(L.vw_pos + 1) * n + row0, R.hi);
    } else {
#pragma unroll
      for (int k = 0; k < rs::kItems; ++k) R.hi[k] = 0u;
    }
  }
  return R;
}

// The scan element of row row0 + k.
__device__ __forceinline__ Seg row_elem(const Rows& R, int k, int64_t row0,
                                        bool uint64_add) {
  Seg e{};
  const bool new_key = (R.starts >> k) & 1u;
  e.flags = new_key ? 1u : 0u;
  e.start = new_key ? (uint32_t)(row0 + k) : 0u;
  if ((R.invalid >> k) & 1u) {
    e.flags |= 2u;
    return e;
  }
  if (!uint64_add) return e;
  const uint32_t vt = R.vt[k];
  bool limbs = false;
  if (vt == kMerge) {
    e.s[4] = 1u;
    limbs = true;
  } else if (vt == kPut) {
    e.flags |= 2u;
    e.s[5] = 1u;
    limbs = true;
  } else if (vt == kDelete) {
    e.flags |= 2u;
    e.s[6] = 1u;
  }
  // values whose length is not exactly 8 parse as 0
  if (limbs && R.vlen[k] == 8u) {
    e.s[0] = R.lo[k] & 0xFFFFu;
    e.s[1] = R.lo[k] >> 16;
    e.s[2] = R.hi[k] & 0xFFFFu;
    e.s[3] = R.hi[k] >> 16;
  }
  return e;
}

struct Decision {
  bool keep, folded;
  uint32_t vt, lo, hi;
};

// Resolve the segment [st.start, e] of valid rows from its totals.
__device__ Decision decide(const uint32_t* lanes, const Layout& L,
                           const Seg& st, bool uint64_add,
                           bool drop_tombstones) {
  Decision d;
  const uint32_t vt = lane_at(lanes, L, L.vt_pos, st.start);
  d.vt = vt;
  d.folded = false;
  d.lo = d.hi = 0u;
  if (!uint64_add) {
    d.keep = !(drop_tombstones && vt == kDelete);
    return d;
  }
  const bool has_ops = st.s[4] > 0, base_put = st.s[5] > 0,
             base_del = st.s[6] > 0;
  if (has_ops) {
    // four u32 limb sums -> (lo, hi) with carries; beyond 64 bits wraps
    const uint32_t l0 = st.s[0] & 0xFFFFu, c0 = st.s[0] >> 16;
    const uint32_t s1 = st.s[1] + c0, l1 = s1 & 0xFFFFu, c1 = s1 >> 16;
    const uint32_t s2 = st.s[2] + c1, l2 = s2 & 0xFFFFu, c2 = s2 >> 16;
    const uint32_t l3 = (st.s[3] + c2) & 0xFFFFu;
    d.folded = true;
    d.lo = l0 | (l1 << 16);
    d.hi = l2 | (l3 << 16);
  }
  const bool pure = has_ops && !base_put && !base_del;
  const bool resolved_put = base_put || (has_ops && base_del);
  d.vt = (resolved_put || (pure && drop_tombstones)) ? kPut
         : pure                                      ? kMerge
                                                     : vt;
  const bool dropped = base_del && !has_ops;
  d.keep = !(drop_tombstones && dropped);
  return d;
}

__device__ __forceinline__ uint32_t bswap32(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);
}

// Output row p: the segment's representative row s, resolved; `meta` is
// its shard's. Every key word and the first 16 value words of row s are
// loaded before the first store; wider values go on 16 words at a time.
__device__ void write_row(const uint32_t* lanes, const Layout& L,
                          const Outputs& o, const uint32_t* meta, int64_t p,
                          uint32_t s, const Decision& d) {
  uint32_t kw[kKeyWords], vw[rs::kGroup];
#pragma unroll
  for (int w = 0; w < kKeyWords; ++w)
    kw[w] = w < L.key_words ? __ldg(lanes + (int64_t)(1 + w) * L.n + s) : 0u;
#pragma unroll
  for (int w = 0; w < rs::kGroup; ++w)
    if (w < L.val_words)
      vw[w] = __ldg(lanes + (int64_t)(L.vw_pos + w) * L.n + s);
  const uint32_t klen =
      L.klen_pos >= 0 ? __ldg(lanes + (int64_t)L.klen_pos * L.n + s)
                      : meta[2];
  const uint32_t shi =
      L.shi_pos >= 0 ? ~__ldg(lanes + (int64_t)L.shi_pos * L.n + s) : 0u;
  const uint32_t slo = ~__ldg(lanes + (int64_t)L.slo_pos * L.n + s);
  const uint32_t vlen =
      d.folded ? 8u : __ldg(lanes + (int64_t)L.vlen_pos * L.n + s);
  if (d.folded) {
    vw[0] = d.lo;
    if (L.val_words > 1) vw[1] = d.hi;
  }
#pragma unroll
  for (int w = 0; w < kKeyWords; ++w) {
    o.kw_be[p * kKeyWords + w] = kw[w];
    o.kw_le[p * kKeyWords + w] = bswap32(kw[w]);
  }
  o.key_len[p] = klen;
  o.seq_hi[p] = shi;
  o.seq_lo[p] = slo;
  o.vtype[p] = d.vt;
  o.val_len[p] = vlen;
#pragma unroll
  for (int w = 0; w < rs::kGroup; ++w)
    if (w < L.val_words) o.val_words[p * L.val_words + w] = vw[w];
  for (int w0 = rs::kGroup; w0 < L.val_words; w0 += rs::kGroup) {
#pragma unroll
    for (int w = 0; w < rs::kGroup; ++w)
      if (w0 + w < L.val_words)
        vw[w] = __ldg(lanes + (int64_t)(L.vw_pos + w0 + w) * L.n + s);
#pragma unroll
    for (int w = 0; w < rs::kGroup; ++w)
      if (w0 + w < L.val_words) o.val_words[p * L.val_words + w0 + w] = vw[w];
  }
}

// Zeroes rows [lo, hi) of every output, each array as one flat range of
// words, so that neighbouring threads store to neighbouring words.
__device__ void zero_rows(const Layout& L, const Outputs& o, int64_t lo,
                          int64_t hi) {
  uint32_t* const arrays[8] = {o.kw_be, o.kw_le, o.key_len, o.seq_hi,
                               o.seq_lo, o.vtype, o.val_words, o.val_len};
  const int widths[8] = {kKeyWords, kKeyWords, 1, 1, 1, 1, L.val_words, 1};
  for (int a = 0; a < 8; ++a)
    for (int64_t i = lo * widths[a] + threadIdx.x; i < hi * widths[a];
         i += blockDim.x)
      arrays[a][i] = 0u;
}

__global__ void build_keys(const uint32_t* __restrict__ kw_be,
                           const uint32_t* __restrict__ key_len,
                           const uint32_t* __restrict__ seq_hi,
                           const uint32_t* __restrict__ seq_lo,
                           const uint8_t* __restrict__ valid, Layout L,
                           uint32_t* __restrict__ keys,
                           uint32_t* __restrict__ status) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t kl = 0;
  if (i < L.n) {
    const bool v = valid[i] != 0;
    uint32_t* out = keys + i;
    const int64_t n = L.n;
    out[0] = v ? 0u : 1u;
    for (int w = 0; w < L.key_words; ++w)
      out[(1 + w) * n] = kw_be[i * kKeyWords + w];
    if (L.klen_pos >= 0) out[L.klen_pos * n] = key_len[i];
    if (L.shi_pos >= 0) out[L.shi_pos * n] = ~seq_hi[i];
    out[L.slo_pos * n] = ~seq_lo[i];
    kl = v ? key_len[i] : 0u;
  }
  // a warp's 32 rows lie in one shard (seg >= 256)
  kl = __reduce_max_sync(0xffffffffu, kl);
  if ((threadIdx.x & 31) == 0 && kl)
    atomicMax(status + kStatusHead + (i / L.seg) * kMetaWords + 2, kl);
}

// Status words at the head of the scratch: the tile counter and padding
// (kStatusHead words), each shard's meta (kMetaWords: count, overflow flag,
// uniform key length, unused), then the two look-back flag arrays. The
// memset zeroes exactly these. Launched with tile_rows / kItems threads.
__global__ void __launch_bounds__(kResolveThreads)
    resolve_compact(const uint32_t* __restrict__ lanes, Layout L,
                    uint32_t* status, int ntiles, Seg* seg_aggs,
                    Seg* seg_incls, uint32_t* keep_aggs,
                    uint32_t* keep_incls, int uint64_add,
                    int drop_tombstones, Outputs o) {
  __shared__ Seg seg_tot[33];
  __shared__ uint32_t keep_tot[33];
  __shared__ Seg seg_prefix;
  __shared__ uint32_t keep_prefix;
  __shared__ int tile_s;
  const int shards = L.n / L.seg;
  volatile uint32_t* seg_flags = status + kStatusHead + shards * kMetaWords;
  volatile uint32_t* keep_flags = seg_flags + ntiles;
  const int tid = threadIdx.x;
  if (tid == 0) tile_s = (int)atomicAdd(status, 1u);
  __syncthreads();
  const int tile = tile_s;
  const int tiles_per_shard = L.seg / L.tile_rows;
  const int shard = tile / tiles_per_shard;
  const int first = shard * tiles_per_shard;  // the shard's first tile
  uint32_t* meta = status + kStatusHead + shard * kMetaWords;
  const int64_t shard0 = (int64_t)shard * L.seg;
  const int64_t tile0 = (int64_t)tile * L.tile_rows;
  const int64_t row0 = tile0 + (int64_t)tid * rs::kItems;
  const bool add = uint64_add != 0, drop = drop_tombstones != 0;

  const bool active = row0 < L.n;
  Rows R;
  Seg agg{};
  if (active) {
    R = read_rows(lanes, L, row0, add);
#pragma unroll
    for (int k = 0; k < rs::kItems; ++k)
      agg = combine(agg, row_elem(R, k, row0, add));
  }
  Seg seg_total;
  const Seg seg_excl = block_exclusive_scan(agg, seg_tot, &seg_total);
  if (tid < 32) {
    const Seg p =
        look_back(tile, first, seg_total, seg_flags, seg_aggs, seg_incls);
    if (tid == 0) seg_prefix = p;
  }
  __syncthreads();
  const Seg run0 = combine(seg_prefix, seg_excl);

  // keep, at each segment's last row
  uint32_t keep_mask = 0;
  if (active) {
    Seg run = run0;
#pragma unroll
    for (int k = 0; k < rs::kItems; ++k) {
      run = combine(run, row_elem(R, k, row0, add));
      if (!((R.starts >> (k + 1)) & 1u) || ((R.invalid >> k) & 1u))
        continue;
      if (add && row0 + k - run.start + 1 >= (1 << 16))
        atomicOr(meta + 1, 1u);
      if (decide(lanes, L, run, add, drop).keep) keep_mask |= 1u << k;
    }
  }
  uint32_t tile_kept;
  const uint32_t keep_excl =
      block_exclusive_scan((uint32_t)__popc(keep_mask), keep_tot, &tile_kept);
  if (tid < 32) {
    const uint32_t p = look_back(tile, first, tile_kept, keep_flags,
                                 keep_aggs, keep_incls);
    if (tid == 0) keep_prefix = p;
  }
  __syncthreads();

  if (keep_mask) {
    int64_t rank = shard0 + keep_prefix + keep_excl;
    Seg run = run0;
#pragma unroll
    for (int k = 0; k < rs::kItems; ++k) {
      run = combine(run, row_elem(R, k, row0, add));
      if ((keep_mask >> k) & 1u)
        write_row(lanes, L, o, meta, rank++, run.start,
                  decide(lanes, L, run, add, drop));
    }
  }

  // Rows at or past the shard's count: tile t zeroes as many as it has
  // unkept rows, counted down from the shard's end after the earlier
  // tiles' share.
  const int64_t hi = shard0 + L.seg - (tile0 - shard0 - keep_prefix);
  zero_rows(L, o, hi - (L.tile_rows - tile_kept), hi);
  if (tile == first + tiles_per_shard - 1 && tid == 0)
    meta[0] = keep_prefix + tile_kept;
}

Layout make_layout(int n, int val_words, int key_words, int uniform_klen,
                   int seq32, int seg) {
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
  L.seg = seg;
  L.tile_rows = seg < kResolveRows ? seg : kResolveRows;
  return L;
}

int64_t round4(int64_t w) { return (w + 3) / 4 * 4; }

}  // namespace

extern "C" {

const char* rs_error_string(int err) {
  return rs::error_string(err);
}

// Inputs: kw_be (n, 6), key_len, seq_hi, seq_lo, vtype, val_words
// (n, val_words), val_len as u32; valid as bytes 0/1. The n rows are
// n / segment shards of `segment` rows (segment = n: one shard), each
// merged and resolved on its own. Outputs: the same lanes, kw_le (n, 6)
// besides, every row written, shard s's rows at [s * segment, + count_s).
// The sort plan and the scratch size come from the wrapper
// (ops/fused_resolve.py plan_fused); the scratch layout is: status words
// (the tile counter, then per shard: count, overflow flag, uniform key
// length, unused; then the look-back flags), look-back values, the sorted
// lanes, two sort buffers, and the index lane when the value words span
// more than one gather group. Adds the CUDA launches it makes (the memset
// included) to *launches.
int rs_fused_merge_resolve(
    const void* kw_be, const void* key_len, const void* seq_hi,
    const void* seq_lo, const void* vtype, const void* val_words,
    const void* val_len, const void* valid, int n, int n_val_words,
    int key_words, int uniform_klen, int seq32, int uint64_add,
    int drop_tombstones, int segment, int tile, int chunk, int passes,
    int smem, int64_t scratch_words, void* o_kw_be, void* o_kw_le,
    void* o_key_len, void* o_seq_hi, void* o_seq_lo, void* o_vtype,
    void* o_val_words, void* o_val_len, void* scratch, int* launches,
    void* stream) {
  const Layout L = make_layout(n, n_val_words, key_words, uniform_klen,
                               seq32, segment);
  if (n < rs::kMinTile || (n & (n - 1)) != 0 || key_words < 1 ||
      key_words > kKeyWords || n_val_words < 1 ||
      L.num_keys > rs::kMaxLanes || segment < rs::kMinTile ||
      (segment & (segment - 1)) != 0 || segment > n)
    return rs::kErrShape;
  const int shards = n / segment;
  const int ntiles = n / L.tile_rows;
  const int num_payload = L.num_lanes - L.num_keys;
  const int64_t status_words =
      round4(kStatusHead + (int64_t)kMetaWords * shards + 2 * (int64_t)ntiles);
  const int64_t look_words = round4((int64_t)ntiles * 2 * (kSegWords + 1));
  const int64_t buf_words = 2 * (int64_t)(L.num_keys + 1) * n;
  const int64_t index_words = rs::gather_launches(num_payload) ? n : 0;
  if (scratch_words != status_words + look_words +
                           (int64_t)L.num_lanes * n + buf_words + index_words)
    return rs::kErrScratch;
  const rs::SortPlan plan{n,     L.num_keys, num_payload, tile,
                          chunk, passes,     segment,     smem,
                          buf_words + index_words};
  if (!rs::plan_ok(plan)) return rs::kErrPlan;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* status = static_cast<uint32_t*>(scratch);
  Seg* seg_aggs = reinterpret_cast<Seg*>(status + status_words);
  Seg* seg_incls = seg_aggs + ntiles;
  uint32_t* keep_aggs = reinterpret_cast<uint32_t*>(seg_incls + ntiles);
  uint32_t* keep_incls = keep_aggs + ntiles;
  uint32_t* lanes = status + status_words + look_words;
  uint32_t* sort_buf = lanes + (int64_t)L.num_lanes * n;
  uint32_t* keys = sort_buf + (int64_t)(L.num_keys + 1) * n;  // buffer 1
  uint32_t* index = sort_buf + buf_words;
  cudaError_t err;

  if ((err = cudaMemsetAsync(status, 0, status_words * sizeof(uint32_t),
                             s)) != cudaSuccess)
    return err;
  ++*launches;

  build_keys<<<(n + kRowThreads - 1) / kRowThreads, kRowThreads, 0, s>>>(
      static_cast<const uint32_t*>(kw_be),
      static_cast<const uint32_t*>(key_len),
      static_cast<const uint32_t*>(seq_hi),
      static_cast<const uint32_t*>(seq_lo),
      static_cast<const uint8_t*>(valid), L, keys, status);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++*launches;

  rs::LaneIn kin{};
  rs::LaneOut out{};
  for (int l = 0; l < L.num_keys; ++l) {
    kin.p[l] = keys + (int64_t)l * n;
    kin.stride[l] = 1;
    out.p[l] = lanes + (int64_t)l * n;
  }
  std::vector<rs::PayLane> pay(num_payload);
  for (int q = 0; q < num_payload; ++q)
    pay[q].out = lanes + (int64_t)(L.num_keys + q) * n;
  pay[0].p = static_cast<const uint32_t*>(vtype);
  pay[1].p = static_cast<const uint32_t*>(val_len);
  pay[0].stride = pay[1].stride = 1;
  for (int w = 0; w < n_val_words; ++w) {
    pay[2 + w].p = static_cast<const uint32_t*>(val_words) + w;
    pay[2 + w].stride = n_val_words;
  }
  if ((err = rs::merge_sort_device(kin, out, pay.data(), plan, sort_buf,
                                   index, s, launches)) != cudaSuccess)
    return err;

  const Outputs o{static_cast<uint32_t*>(o_kw_be),
                  static_cast<uint32_t*>(o_kw_le),
                  static_cast<uint32_t*>(o_key_len),
                  static_cast<uint32_t*>(o_seq_hi),
                  static_cast<uint32_t*>(o_seq_lo),
                  static_cast<uint32_t*>(o_vtype),
                  static_cast<uint32_t*>(o_val_words),
                  static_cast<uint32_t*>(o_val_len)};
  resolve_compact<<<ntiles, L.tile_rows / rs::kItems, 0, s>>>(
      lanes, L, status, ntiles, seg_aggs, seg_incls, keep_aggs, keep_incls,
      uint64_add, drop_tombstones, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++*launches;
  return 0;
}

}  // extern "C"
