// Kernel K1: lexicographic bitonic sort of u32 lanes, payload riding along.
// Replaces rocksplicator_tpu/ops/pallas_sort.py bitonic_sort_lanes (the
// pallas_call at :190). The device code is in bitonic_sort.cuh; this file
// is its plain C entry point for ctypes.

#include "bitonic_sort.cuh"

extern "C" {

const char* rs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lanes: (num_lanes, n) u32, contiguous, sorted in place on `stream`.
int rs_bitonic_sort(void* lanes, int num_lanes, int num_keys, int n,
                    void* stream) {
  return static_cast<int>(rs::bitonic_sort_device(
      static_cast<uint32_t*>(lanes), num_lanes, num_keys, n,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
