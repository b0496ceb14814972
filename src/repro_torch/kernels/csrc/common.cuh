// Shared device helpers for the kernels (sm_90a).
//
// The fabric and KVS kernels are int32 scatter/gather/arbitration code.
// The helpers give the two things the port needs beyond plain CUDA C:
// floor modulo (JAX and PyTorch `%` floor; CUDA `%` truncates) and
// in-order block-wide arbitration (exclusive prefix counts, and the
// per-key rank a serial arbiter would hand out).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DG_FULL_MASK 0xffffffffu
#define DG_BLOCK 1024

namespace dg {

// Floor modulo: the result has the sign of m, as `%` in JAX and PyTorch.
__device__ __forceinline__ int fmod_i(int a, int m) {
  int r = a % m;
  return (r != 0 && ((r ^ m) < 0)) ? r + m : r;
}

// Exclusive prefix sum of x over the block, in thread order.  *total
// (may be null) receives the block sum.  Every thread of the block must
// call it; blockDim.x is a multiple of 32.
__device__ __forceinline__ int block_excl_scan(int x, int* total) {
  __shared__ int warp_off[33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(DG_FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? warp_off[lane] : 0;
    int si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(DG_FULL_MASK, si, o);
      if (lane >= o) si += y;
    }
    if (lane < nw) warp_off[lane] = si - s;
    if (lane == 31) warp_off[32] = si;
  }
  __syncthreads();
  int out = warp_off[warp] + incl - x;
  if (total) *total = warp_off[32];
  __syncthreads();
  return out;
}

// Rank of each participating thread among the participating threads
// of the block with the same key, in thread order, offset by the running
// per-key counters cnt[key] (shared memory), which it then advances.
// This is the queue position a serial arbiter hands out when rows are
// taken in order.  Warps take their turn in order; inside a warp,
// __match_any_sync groups the lanes that share a key.  Every thread
// must call it; keys of participating threads index cnt.
__device__ __forceinline__ int ordered_group_rank(bool part, int key,
                                                  int* cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int rank = 0;
  for (int w = 0; w < nw; ++w) {
    if (warp == w) {
      unsigned pm = __ballot_sync(DG_FULL_MASK, part);
      unsigned same = __match_any_sync(DG_FULL_MASK, key) & pm;
      if (part) rank = cnt[key] + __popc(same & lt);
      __syncwarp();
      if (part && (same & lt) == 0u) cnt[key] += __popc(same);
    }
    __syncthreads();
  }
  return rank;
}

// The table row a slot reference names, or -1 for none (a zero row):
// a reference in [-R, 0) counts from the end, as JAX's filled gather
// does; any other outside [0, R) (the free-slot sentinel R) names none.
// ring_gather and the gathered ring push both resolve references here.
__device__ __forceinline__ int gather_row(int ref, int R) {
  if (ref < 0) ref += R;
  return (ref >= 0 && ref < R) ? ref : -1;
}

// Byte-serial FNV-1a over the little-endian bytes of n_words words.
__device__ __forceinline__ uint32_t fnv1a(const int* words, int n_words) {
  uint32_t h = 0x811C9DC5u;
  for (int k = 0; k < n_words; ++k) {
    uint32_t wk = (uint32_t)words[k];
#pragma unroll
    for (int s = 0; s < 32; s += 8) {
      h = (h ^ ((wk >> s) & 0xFFu)) * 0x01000193u;
    }
  }
  return h;
}

}  // namespace dg
