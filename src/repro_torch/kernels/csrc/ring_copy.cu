// ring_gather: gather [F, B] slot references out of the request table
// (the CCI-P transmit engine).  Replaces the Pallas kernel
// repro/kernels/ring_copy.py (ring_gather).  One block per flow, its
// threads over B x W; a reference resolves to a table row by
// dg::gather_row (common.cuh), the rule the gathered ring push
// (ring_push.cu) also reads its rows by, and one that names no row (the
// free-slot sentinel R) yields a zero row.  On the main paths the staged
// emit's gather runs inside that push; this kernel has no launch there.
#include "common.cuh"

static __global__ void ring_gather_kernel(const int* __restrict__ table,
                                          const int* __restrict__ refs,
                                          int* __restrict__ out, int R, int W,
                                          int B) {
  const int f = blockIdx.x;
  for (int k = threadIdx.x; k < B * W; k += blockDim.x) {
    int b = k / W;
    int w = k % W;
    int row = dg::gather_row(refs[(long long)f * B + b], R);
    out[((long long)f * B + b) * W + w] =
        row >= 0 ? table[(long long)row * W + w] : 0;
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
