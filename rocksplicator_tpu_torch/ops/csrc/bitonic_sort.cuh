// Bitonic sort of struct-of-arrays u32 lanes — device code shared by the
// standalone sort (bitonic_sort.cu, kernel K1) and the fused merge-resolve
// (fused_resolve.cu, kernel K2).
//
// Replaces the Pallas network of rocksplicator_tpu/ops/pallas_sort.py
// (bitonic_sort_lanes / _sort_kernel / bitonic_network). The TPU version
// holds the whole batch in VMEM across all stages; one SM cannot, so here
// the lanes live in device memory as an (L, N) array and:
//   * every stage whose partner distance is below the tile (j < log2 TILE)
//     runs inside one launch on a shared-memory tile of TILE rows, all L
//     lanes resident, with __syncthreads between stages;
//   * every stage with a larger distance is one launch, one thread per
//     compare-exchange pair.
// Rows compare lexicographically over the first num_keys lanes AS
// UNSIGNED; the remaining lanes ride along. N is a power of two >= 256.
//
// Bound on the card: memory. Each global stage reads and writes all L
// lanes once (2·L·4·N bytes); the tile launches add one round trip per k.
// At N = 2^17 that is 28 global stages + 8 tile launches.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rs {

constexpr int kMaxLanes = 16;
constexpr int kSortTile = 1024;  // rows per shared-memory tile
constexpr int kStageThreads = 256;

__device__ __forceinline__ bool swap_needed(bool asc, bool a_less,
                                            bool b_less) {
  return asc ? b_less : a_less;
}

// One compare-exchange stage (k, j) over the whole array: partner distance
// 2^j inside direction blocks of 2^(k+1).
__global__ void bitonic_global_stage(uint32_t* __restrict__ lanes,
                                     int num_lanes, int num_keys, int n,
                                     int k, int j) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const int64_t d = int64_t(1) << j;
  const int64_t lo = ((t >> j) << (j + 1)) | (t & (d - 1));
  const int64_t hi = lo + d;
  const bool asc = ((lo >> (k + 1)) & 1) == 0;
  bool a_less = false, b_less = false;
  for (int l = 0; l < num_keys; ++l) {
    const uint32_t a = lanes[(int64_t)l * n + lo];
    const uint32_t b = lanes[(int64_t)l * n + hi];
    if (a != b) {
      a_less = a < b;
      b_less = b < a;
      break;
    }
  }
  if (!swap_needed(asc, a_less, b_less)) return;
  for (int l = 0; l < num_lanes; ++l) {
    uint32_t* p = lanes + (int64_t)l * n;
    const uint32_t a = p[lo];
    p[lo] = p[hi];
    p[hi] = a;
  }
}

// All stages k in [k_lo, k_hi], j from min(k, log_tile - 1) down to 0, on
// one tile of `tile` rows held in shared memory (num_lanes · tile words).
__global__ void bitonic_tile(uint32_t* __restrict__ lanes, int num_lanes,
                             int num_keys, int n, int tile, int log_tile,
                             int k_lo, int k_hi) {
  extern __shared__ uint32_t smem[];
  const int64_t base = (int64_t)blockIdx.x * tile;
  for (int l = 0; l < num_lanes; ++l)
    for (int r = threadIdx.x; r < tile; r += blockDim.x)
      smem[l * tile + r] = lanes[(int64_t)l * n + base + r];
  __syncthreads();
  for (int k = k_lo; k <= k_hi; ++k) {
    const int j_top = k < log_tile - 1 ? k : log_tile - 1;
    for (int j = j_top; j >= 0; --j) {
      const int d = 1 << j;
      for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
        const int lo = ((t >> j) << (j + 1)) | (t & (d - 1));
        const int hi = lo + d;
        const bool asc = (((base + lo) >> (k + 1)) & 1) == 0;
        bool a_less = false, b_less = false;
        for (int l = 0; l < num_keys; ++l) {
          const uint32_t a = smem[l * tile + lo];
          const uint32_t b = smem[l * tile + hi];
          if (a != b) {
            a_less = a < b;
            b_less = b < a;
            break;
          }
        }
        if (swap_needed(asc, a_less, b_less)) {
          for (int l = 0; l < num_lanes; ++l) {
            const uint32_t a = smem[l * tile + lo];
            smem[l * tile + lo] = smem[l * tile + hi];
            smem[l * tile + hi] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int l = 0; l < num_lanes; ++l)
    for (int r = threadIdx.x; r < tile; r += blockDim.x)
      lanes[(int64_t)l * n + base + r] = smem[l * tile + r];
}

inline int log2_exact(int n) {
  int r = 0;
  while ((1 << r) < n) ++r;
  return r;
}

// Sort the (num_lanes, n) lanes in place on `stream`. Returns the first
// launch error.
inline cudaError_t bitonic_sort_device(uint32_t* lanes, int num_lanes,
                                       int num_keys, int n,
                                       cudaStream_t stream) {
  if (num_lanes < 1 || num_lanes > kMaxLanes || num_keys < 1 ||
      num_keys > num_lanes || n < 256 || (n & (n - 1)) != 0)
    return cudaErrorInvalidValue;
  const int tile = n < kSortTile ? n : kSortTile;
  const int log_tile = log2_exact(tile);
  const int log_n = log2_exact(n);
  const size_t smem = (size_t)num_lanes * tile * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tile_threads = tile / 2;
  bitonic_tile<<<n / tile, tile_threads, smem, stream>>>(
      lanes, num_lanes, num_keys, n, tile, log_tile, 0, log_tile - 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int stage_blocks = (n / 2 + kStageThreads - 1) / kStageThreads;
  for (int k = log_tile; k < log_n; ++k) {
    for (int j = k; j >= log_tile; --j) {
      bitonic_global_stage<<<stage_blocks, kStageThreads, 0, stream>>>(
          lanes, num_lanes, num_keys, n, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    bitonic_tile<<<n / tile, tile_threads, smem, stream>>>(
        lanes, num_lanes, num_keys, n, tile, log_tile, k, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace rs
