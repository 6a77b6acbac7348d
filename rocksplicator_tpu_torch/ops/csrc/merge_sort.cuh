// Stable merge sort of struct-of-arrays u32 lanes over key lanes and a row
// index — device code shared by the standalone sort (bitonic_sort.cu,
// kernel K1) and the fused merge-resolve (fused_resolve.cu, kernel K2).
//
// Replaces the Pallas network of rocksplicator_tpu/ops/pallas_sort.py
// (bitonic_sort_lanes, the pallas_call at :190). The TPU kernel holds the
// whole batch in VMEM across all 153 stages of a bitonic network; one SM
// holds 227 KB, so here the sort is a merge sort that moves only what
// decides the order:
//   * only the num_keys key lanes and one u32 row-index lane are sorted;
//     the payload lanes move once, gathered through the index by the last
//     launch (the "final" sink), kGroup lanes of them; a wider payload
//     (values of any width) goes on in gather_lanes launches of kGroup
//     lanes each, through the index the last launch writes out;
//   * tile_sort: each block copies `tile` rows of the key lanes into shared
//     memory (cp.async, 16 bytes a thread), sorts kItems rows per thread in registers (odd-even
//     transposition over row numbers), then merges runs of 8, 16, ... rows
//     in shared memory by merge path, one __syncthreads per round; the
//     index lane is implicit (base + row) and never loaded;
//   * merge_pass, log2(n / tile) launches: runs of R rows merge pairwise
//     into runs of 2R, ping-ponging between two buffers. Each block owns
//     `chunk` output rows, so every pass fills the card however long the
//     runs are. The block finds its two input ranges by a search along
//     its diagonal (merge path; one warp probes 32 positions per round),
//     stages them in shared memory with cp.async (every copy in flight at
//     once), merges, and writes coalesced.
// Rows compare lexicographically over the key lanes AS UNSIGNED; on equal
// keys the left run wins, so the sort is stable: it equals the stable LSD
// sort_lanes_plain for every input, ties included.
//
// Segments (a shard axis): with segment < n the passes stop at runs of
// `segment` rows, so each aligned segment of the rows is sorted on its
// own and no row leaves its segment — S shards of capacity C sort in one
// call as S * C rows with segment C. The tile is at most the segment.
//
// The plan (tile, chunk, passes, segment, shared-memory bytes, scratch) is
// computed by the Python wrapper (ops/bitonic_sort.py plan_sort) and
// checked here.
//
// Bound on the card: memory and launches, never arithmetic. Each merge pass
// reads and writes each of the num_keys + 1 sorted lanes once; the final
// launch adds one read and one write of every payload lane. At n = 2^22
// with 10 keys that is 12 passes of 11 lanes (about 0.11 ms of HBM traffic
// each); at 2^17 the lanes sit in the 50 MB L2 and launches dominate.

#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace rs {

constexpr int kMaxLanes = 16;             // key lanes of one sort
constexpr int kGroup = kMaxLanes;         // payload lanes one launch gathers
constexpr int kItems = 8;                 // rows per thread
constexpr int kMinTile = 256;
constexpr int kMaxTile = 2048;
constexpr int kSmemLimit = 232448;        // shared memory a block may use
constexpr int kDynSmemMax = kSmemLimit - 1024;  // room for static arrays

// Codes the C entry points return, besides a cudaError_t, for an argument
// they refuse before launching anything.
constexpr int kErrShape = -1;    // n, lane or word counts out of range
constexpr int kErrPlan = -2;     // the plan is not one the kernels take
constexpr int kErrScratch = -3;  // the scratch is not the plan's size

inline const char* error_string(int err) {
  switch (err) {
    case kErrShape: return "shape refused";
    case kErrPlan: return "sort plan refused";
    case kErrScratch: return "scratch size differs from the plan's";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

struct LaneIn {                           // lane l: p[l][row * stride[l]]
  const uint32_t* p[kMaxLanes];
  int stride[kMaxLanes];
};

struct LaneOut {
  uint32_t* p[kMaxLanes];
};

struct SortPlan {
  int n, num_keys, num_payload, tile, chunk, passes, segment, smem;
  int64_t scratch_words;
};

// A payload lane: row r of the source at p[r * stride], its sorted lane
// at out.
struct PayLane {
  const uint32_t* p;
  int64_t stride;
  uint32_t* out;
};

// Where a launch writes. Not final: the num_keys + 1 sorted lanes into
// `buf` (lane l at buf + l * n, the index lane last). Final: the key lanes
// into out.p[0..num_keys), payload lane q < num_payload (the first group),
// gathered through the index, into pay_out.p[q], and the index itself into
// `index` when later groups need it (else null).
struct Sink {
  uint32_t* buf;
  LaneOut out;
  LaneIn payload;
  LaneOut pay_out;
  int num_payload;
  uint32_t* index;
  int final_;
};

__device__ __forceinline__ void put_row(const Sink& s, int n, int l,
                                        int64_t dst, uint32_t v) {
  if (s.final_)
    s.out.p[l][dst] = v;
  else
    s.buf[(int64_t)l * n + dst] = v;
}

// Final launch: output rows base + tid + k * nt (k < kItems) of every
// payload lane of the first group, from source rows idx[k], and the index
// when later groups gather through it. All kItems loads of a lane are
// issued before its stores.
__device__ __forceinline__ void put_payload(const Sink& s, int64_t base,
                                            int tid, int nt,
                                            const uint32_t (&idx)[kItems]) {
  for (int q = 0; q < s.num_payload; ++q) {
    const uint32_t* p = s.payload.p[q];
    const int64_t st = s.payload.stride[q];
    uint32_t v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) v[k] = __ldg(p + idx[k] * st);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      s.pay_out.p[q][base + tid + k * nt] = v[k];
  }
  if (s.index) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) s.index[base + tid + k * nt] = idx[k];
  }
}

// A later group of payload lanes: sorted row i of lane q is source row
// index[i] of src lane q. Every load of a row is issued before its stores.
__global__ void __launch_bounds__(256)
    gather_lanes(const uint32_t* __restrict__ index, int n, LaneIn src,
                 LaneOut dst, int lanes) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t r = __ldg(index + i);
  uint32_t v[kGroup];
#pragma unroll
  for (int q = 0; q < kGroup; ++q)
    if (q < lanes) v[q] = __ldg(src.p[q] + r * src.stride[q]);
#pragma unroll
  for (int q = 0; q < kGroup; ++q)
    if (q < lanes) dst.p[q][i] = v[q];
}

// True when row b orders strictly before row a; rows live in shared memory
// as lanes of `stride` words.
__device__ __forceinline__ bool smem_less(const uint32_t* keys, int stride,
                                          int num_keys, int b, int a) {
  for (int l = 0; l < num_keys; ++l) {
    const uint32_t x = keys[l * stride + b], y = keys[l * stride + a];
    if (x != y) return x < y;
  }
  return false;
}

// Merge path: of the first d outputs of the stable merge of A (na rows) and
// B (nb rows), how many come from A. b_before_a(i, j) is B[j] < A[i].
template <class F>
__device__ __forceinline__ int merge_path(int d, int na, int nb,
                                          F b_before_a) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b_before_a(mid, d - 1 - mid))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// merge_path for a whole warp: each step probes 32 diagonal positions at
// once and keeps the gap where the predicate turns true, so a search over
// R rows takes log32(R) rounds of dependent loads instead of log2(R).
// Every lane returns the same value.
template <class F>
__device__ __forceinline__ int warp_merge_path(int d, int na, int nb,
                                               F b_before_a) {
  const int lane = threadIdx.x & 31;
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t span = hi - lo;
    const int p = lo + (int)((span * lane) >> 5);
    const unsigned hits =
        __ballot_sync(0xffffffffu, b_before_a(p, d - 1 - p));
    if (hits == 0u) {
      lo += (int)((span * 31) >> 5) + 1;
    } else {
      const int f = __ffs(hits) - 1;
      hi = lo + (int)((span * f) >> 5);
      if (f > 0) lo += (int)((span * (f - 1)) >> 5) + 1;
    }
  }
  return lo;
}

// Block sort of one tile: see the header note. Shared memory: num_keys
// lanes of `tile` words, then two permutation buffers of `tile` words.
__global__ void __launch_bounds__(kMaxTile / kItems)
    tile_sort(LaneIn keys, int num_keys, int n, int tile, Sink sink) {
  extern __shared__ uint32_t smem[];
  uint32_t* sk = smem;
  uint32_t* perm = smem + (int64_t)num_keys * tile;
  uint32_t* perm2 = perm + tile;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t base = (int64_t)blockIdx.x * tile;

  for (int l = 0; l < num_keys; ++l) {
    const uint32_t* src = keys.p[l];
    uint32_t* dst = sk + l * tile;
    const int st = keys.stride[l];
    if (st == 1 && (reinterpret_cast<uintptr_t>(src + base) & 15) == 0) {
      for (int r = tid; r < tile / 4; r += nt)
        __pipeline_memcpy_async(dst + 4 * r, src + base + 4 * r,
                                4 * sizeof(uint32_t));
    } else {
      for (int r = tid; r < tile; r += nt)
        __pipeline_memcpy_async(dst + r, src + (base + r) * st,
                                sizeof(uint32_t));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // kItems rows per thread in registers: odd-even transposition sort,
  // swapping only strictly out-of-order neighbours (stable).
  int idx[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) idx[k] = tid * kItems + k;
#pragma unroll
  for (int round = 0; round < kItems; ++round) {
#pragma unroll
    for (int k = round & 1; k + 1 < kItems; k += 2) {
      if (smem_less(sk, tile, num_keys, idx[k + 1], idx[k])) {
        const int t = idx[k];
        idx[k] = idx[k + 1];
        idx[k + 1] = t;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) perm[tid * kItems + k] = idx[k];
  __syncthreads();

  // Merge rounds in shared memory over row numbers.
  for (int w = kItems; w < tile; w *= 2) {
    const int out0 = tid * kItems;
    const int ps = out0 / (2 * w) * (2 * w);
    const uint32_t* A = perm + ps;
    const uint32_t* B = A + w;
    const int d = out0 - ps;
    auto b_before_a = [&](int i, int j) {
      return smem_less(sk, tile, num_keys, B[j], A[i]);
    };
    int i = merge_path(d, w, w, b_before_a);
    int j = d - i;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool take_a = j >= w || (i < w && !b_before_a(i, j));
      perm2[out0 + k] = take_a ? A[i++] : B[j++];
    }
    __syncthreads();
    uint32_t* t = perm;
    perm = perm2;
    perm2 = t;
  }

  for (int l = 0; l < num_keys; ++l)
    for (int r = tid; r < tile; r += nt)
      put_row(sink, n, l, base + r, sk[l * tile + perm[r]]);
  if (sink.final_) {
    uint32_t rows[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      rows[k] = (uint32_t)(base + perm[tid + k * nt]);
    put_payload(sink, base, tid, nt, rows);
  } else {
    for (int r = tid; r < tile; r += nt)
      put_row(sink, n, num_keys, base + r,
              (uint32_t)(base + perm[r]));
  }
}

// True when global row b orders strictly before global row a. Every key
// word of both rows is loaded before the first compare, so a compare costs
// one memory latency, not one per equal leading lane.
__device__ __forceinline__ bool global_less(const uint32_t* src, int n,
                                            int num_keys, int64_t b,
                                            int64_t a) {
  uint32_t x[kMaxLanes], y[kMaxLanes];
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    if (l < num_keys) {
      x[l] = __ldg(src + (int64_t)l * n + b);
      y[l] = __ldg(src + (int64_t)l * n + a);
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l)
    if (l < num_keys && x[l] != y[l]) return x[l] < y[l];
  return false;
}

// One merge pass: sorted runs of `run` rows in `src` (num_keys + 1 lanes
// of n) merge pairwise; block b writes output rows [b * chunk, +chunk).
// Shared memory: num_keys + 1 lanes of `chunk` words, then `chunk` words of
// source positions.
__global__ void __launch_bounds__(kMaxTile / kItems)
    merge_pass(const uint32_t* __restrict__ src, int num_keys, int n,
               int run, int chunk, Sink sink) {
  extern __shared__ uint32_t smem[];
  __shared__ int split[2];
  const int lanes = num_keys + 1;
  uint32_t* sidx = smem + (int64_t)lanes * chunk;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t c0 = (int64_t)blockIdx.x * chunk;
  const int64_t ps = c0 / (2 * (int64_t)run) * (2 * (int64_t)run);
  const int d0 = (int)(c0 - ps);

  // The first warp finds where the chunk starts, the last where it ends.
  auto g_before = [&](int i, int j) {
    return global_less(src, n, num_keys, ps + run + j, ps + i);
  };
  const int warp = tid >> 5, last_warp = (nt - 1) >> 5;
  if (warp == 0) {
    const int a = warp_merge_path(d0, run, run, g_before);
    if (tid == 0) split[0] = a;
  }
  if (warp == last_warp) {
    const int a = warp_merge_path(d0 + chunk, run, run, g_before);
    if (tid == nt - 1) split[1] = a;
  }
  __syncthreads();
  const int a0 = split[0], a1 = split[1];
  const int b0 = d0 - a0, b1 = d0 + chunk - a1;
  const int na = a1 - a0, nb = b1 - b0;
  for (int l = 0; l < lanes; ++l) {
    const uint32_t* s = src + (int64_t)l * n + ps;
    uint32_t* dst = smem + l * chunk;
    for (int r = tid; r < chunk; r += nt)
      __pipeline_memcpy_async(dst + r,
                              r < na ? s + a0 + r : s + run + b0 + (r - na),
                              sizeof(uint32_t));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  {
    const int out0 = tid * kItems;
    auto b_before_a = [&](int i, int j) {
      return smem_less(smem, chunk, num_keys, na + j, i);
    };
    int i = merge_path(out0, na, nb, b_before_a);
    int j = out0 - i;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool take_a = j >= nb || (i < na && !b_before_a(i, j));
      sidx[out0 + k] = take_a ? i++ : na + j++;
    }
  }
  __syncthreads();

  const int key_lanes = sink.final_ ? num_keys : lanes;
  for (int l = 0; l < key_lanes; ++l)
#pragma unroll 4
    for (int r = tid; r < chunk; r += nt)
      put_row(sink, n, l, c0 + r, smem[l * chunk + sidx[r]]);
  if (sink.final_) {
    uint32_t rows[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      rows[k] = smem[num_keys * chunk + sidx[tid + k * nt]];
    put_payload(sink, c0, tid, nt, rows);
  }
}

inline int log2_exact(int64_t n) {
  int r = 0;
  while ((int64_t(1) << r) < n) ++r;
  return r;
}

inline bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

inline int sort_smem_bytes(int num_keys, int rows) {
  return (num_keys + 2) * rows * (int)sizeof(uint32_t);
}

// gather_lanes launches after the last sort launch: one per kGroup
// payload lanes beyond the first group.
inline int gather_launches(int num_payload) {
  return num_payload > kGroup ? (num_payload - 1) / kGroup : 0;
}

// Words of ping-pong buffer the plan needs: none when the tile sort is the
// last launch, one buffer for a single merge pass, two beyond.
inline int64_t sort_buffer_words(const SortPlan& p) {
  const int bufs = p.passes < 2 ? p.passes : 2;
  return (int64_t)bufs * (p.num_keys + 1) * p.n;
}

// Words of the index lane later payload groups gather through.
inline int64_t sort_index_words(const SortPlan& p) {
  return gather_launches(p.num_payload) ? p.n : 0;
}

// The plan must be one the kernels take; the wrapper computes it.
inline bool plan_ok(const SortPlan& p) {
  return p.n >= kMinTile && pow2(p.n) && p.num_keys >= 1 &&
         p.num_keys <= kMaxLanes && p.num_payload >= 0 &&
         pow2(p.segment) && p.segment >= kMinTile && p.segment <= p.n &&
         pow2(p.tile) && p.tile >= kMinTile && p.tile <= kMaxTile &&
         p.tile <= p.segment && pow2(p.chunk) && p.chunk >= kMinTile &&
         p.chunk <= p.tile && p.passes == log2_exact(p.segment / p.tile) &&
         p.smem >= sort_smem_bytes(p.num_keys, p.tile) &&
         p.smem <= kDynSmemMax &&
         p.scratch_words >= sort_buffer_words(p) + sort_index_words(p);
}

// The opt-in for dynamic shared memory above 48 KB, once per library. Not
// `inline`: the static of an inline function is one object across every
// library loaded into the process (a GNU unique symbol), so the second
// library to include this header would skip setting its own kernels'.
static cudaError_t sort_attributes_once() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        tile_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmemMax);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        merge_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDynSmemMax);
  }();
  return err;
}

// Sort on `stream`: keys (num_keys lanes) into out, and the num_payload
// lanes of `pay` (a host array) into their own outputs, through `scratch`
// (the plan's buffer words) and `index` (n words; used only when the
// payload has more than one group). Adds one to *launches per kernel
// launched. Returns the first error.
inline cudaError_t merge_sort_device(const LaneIn& keys, const LaneOut& out,
                                     const PayLane* pay,
                                     const SortPlan& p, uint32_t* scratch,
                                     uint32_t* index, cudaStream_t stream,
                                     int* launches) {
  if (!plan_ok(p)) return cudaErrorInvalidValue;
  cudaError_t err = sort_attributes_once();
  if (err != cudaSuccess) return err;
  const int64_t buf_words = (int64_t)(p.num_keys + 1) * p.n;
  uint32_t* bufs[2] = {scratch, scratch + buf_words};
  const int gathers = gather_launches(p.num_payload);
  Sink sink;
  sink.out = out;
  sink.num_payload = p.num_payload < kGroup ? p.num_payload : kGroup;
  for (int q = 0; q < sink.num_payload; ++q) {
    sink.payload.p[q] = pay[q].p;
    sink.payload.stride[q] = (int)pay[q].stride;
    sink.pay_out.p[q] = pay[q].out;
  }
  sink.index = gathers ? index : nullptr;
  sink.final_ = p.passes == 0;
  sink.buf = bufs[0];
  tile_sort<<<p.n / p.tile, p.tile / kItems,
              sort_smem_bytes(p.num_keys, p.tile), stream>>>(
      keys, p.num_keys, p.n, p.tile, sink);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++*launches;
  for (int pass = 0; pass < p.passes; ++pass) {
    sink.final_ = pass == p.passes - 1;
    sink.buf = bufs[(pass + 1) & 1];
    merge_pass<<<p.n / p.chunk, p.chunk / kItems,
                 sort_smem_bytes(p.num_keys, p.chunk), stream>>>(
        bufs[pass & 1], p.num_keys, p.n, p.tile << pass, p.chunk, sink);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launches;
  }
  for (int g = 1; g <= gathers; ++g) {
    LaneIn src{};
    LaneOut dst{};
    const int q0 = g * kGroup;
    const int lanes =
        p.num_payload - q0 < kGroup ? p.num_payload - q0 : kGroup;
    for (int q = 0; q < lanes; ++q) {
      src.p[q] = pay[q0 + q].p;
      src.stride[q] = (int)pay[q0 + q].stride;
      dst.p[q] = pay[q0 + q].out;
    }
    gather_lanes<<<(p.n + 255) / 256, 256, 0, stream>>>(index, p.n, src,
                                                        dst, lanes);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

}  // namespace rs
