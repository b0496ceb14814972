// ring_gather: gather [F, B] slot references out of the request table
// (the CCI-P transmit engine).  Replaces the Pallas kernel
// repro/kernels/ring_copy.py (ring_gather).  One block per flow, its
// threads over B x W; a reference out of [0, R) (the free-slot sentinel
// R) yields a zero row (indices in [-R, 0) count from the end first, as
// JAX's filled gather does).
#include "common.cuh"

static __global__ void ring_gather_kernel(const int* __restrict__ table,
                                          const int* __restrict__ refs,
                                          int* __restrict__ out, int R, int W,
                                          int B) {
  const int f = blockIdx.x;
  for (int k = threadIdx.x; k < B * W; k += blockDim.x) {
    int b = k / W;
    int w = k % W;
    int ref = refs[(long long)f * B + b];
    if (ref < 0) ref += R;  // negative indices count from the end
    int v = (ref >= 0 && ref < R) ? table[(long long)ref * W + w] : 0;
    out[((long long)f * B + b) * W + w] = v;
  }
}

extern "C" int dg_ring_gather(const int* table, const int* refs, int* out,
                              int R, int W, int F, int B, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (F > 0 && B > 0) {
    int threads = B * W < 1024 ? ((B * W + 31) / 32) * 32 : 1024;
    ring_gather_kernel<<<F, threads, 0, s>>>(table, refs, out, R, W, B);
  }
  return (int)cudaGetLastError();
}
