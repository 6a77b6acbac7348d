// Kernel K1: stable lexicographic sort of u32 lanes, payload riding along.
// Replaces rocksplicator_tpu/ops/pallas_sort.py bitonic_sort_lanes (the
// pallas_call at :190). The device code, a merge sort over the key lanes
// and a row index, is in merge_sort.cuh; this file is its plain C entry
// point for ctypes. The name stays K1's so that the JAX counterpart and
// the measurements keep one name.

#include <vector>

#include "merge_sort.cuh"

extern "C" {

const char* rs_error_string(int err) {
  return rs::error_string(err);
}

// ins / outs: host arrays of num_lanes device pointers to (n,) u32 lanes;
// the first num_keys (at most 16) are the keys, the payload lanes may be
// any number. With segment < n each aligned run of `segment` rows sorts on
// its own. The plan comes from the wrapper (ops/bitonic_sort.py
// plan_sort); scratch holds its scratch_words: the sort buffers, then the
// index lane when the payload spans more than one gather group. Adds the
// CUDA launches it makes to *launches.
int rs_bitonic_sort(void* const* ins, int num_lanes, int num_keys, int n,
                    int tile, int chunk, int passes, int segment, int smem,
                    int64_t scratch_words, void* scratch, void* const* outs,
                    int* launches, void* stream) {
  if (num_lanes < 1 || num_keys < 1 || num_keys > rs::kMaxLanes ||
      num_keys > num_lanes)
    return rs::kErrShape;
  const rs::SortPlan plan{n,      num_keys, num_lanes - num_keys, tile,
                          chunk,  passes,   segment,              smem,
                          scratch_words};
  if (!rs::plan_ok(plan)) return rs::kErrPlan;
  rs::LaneIn keys{};
  rs::LaneOut out{};
  std::vector<rs::PayLane> pay(num_lanes - num_keys);
  for (int l = 0; l < num_lanes; ++l) {
    const uint32_t* p = static_cast<const uint32_t*>(ins[l]);
    uint32_t* o = static_cast<uint32_t*>(outs[l]);
    if (l < num_keys) {
      keys.p[l] = p;
      keys.stride[l] = 1;
      out.p[l] = o;
    } else {
      pay[l - num_keys] = rs::PayLane{p, 1, o};
    }
  }
  uint32_t* buf = static_cast<uint32_t*>(scratch);
  return static_cast<int>(rs::merge_sort_device(
      keys, out, pay.data(), plan, buf, buf + rs::sort_buffer_words(plan),
      static_cast<cudaStream_t>(stream), launches));
}

}  // extern "C"
