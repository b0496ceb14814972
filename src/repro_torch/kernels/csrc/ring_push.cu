// ring_push: scatter N slot rows into per-queue rings (the CCI-P receive
// engine).  Replaces the Pallas kernel repro/kernels/ring_push.py
// (ring_push).  Out of place: the output ring starts as a copy of the
// input, then one thread per (row, word) writes row i's word w to
// out[q[i], pos[i], w].  Rows whose queue id is out of [0, Q) (the drop
// sentinel Q) or whose position is out of [0, E) write nothing
// (indices in [-n, 0) count from the end first, as JAX's scatter does).
// Targets of kept rows are unique by construction (per-queue rank
// arbitration), so no atomics are needed.
#include "common.cuh"

static __global__ void ring_push_scatter(const int* __restrict__ qid,
                                         const int* __restrict__ pos,
                                         const int* __restrict__ slots,
                                         int* __restrict__ out, int Q, int E,
                                         int W, int N) {
  long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= (long long)N * W) return;
  int i = (int)(k / W);
  int w = (int)(k % W);
  int q = qid[i];
  int p = pos[i];
  if (q < 0) q += Q;  // negative indices count from the end, as in JAX
  if (p < 0) p += E;
  if (q < 0 || q >= Q || p < 0 || p >= E) return;
  out[((long long)q * E + p) * W + w] = slots[(long long)i * W + w];
}

extern "C" int dg_ring_push(const int* buf, const int* qid, const int* pos,
                            const int* slots, int* out, int Q, int E, int W,
                            int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = dg_copy(buf, out, (long long)Q * E * W, s);
  if (err != cudaSuccess) return (int)err;
  long long work = (long long)N * W;
  if (work > 0) {
    unsigned blocks = (unsigned)((work + 255) / 256);
    ring_push_scatter<<<blocks, 256, 0, s>>>(qid, pos, slots, out, Q, E, W,
                                             N);
  }
  return (int)cudaGetLastError();
}
