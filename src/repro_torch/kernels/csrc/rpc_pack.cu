// rpc_pack: pack header field arrays and a payload into wire slots (the
// RPC unit's serdes stage).  Replaces the Pallas kernel
// repro/kernels/rpc_pack.py (rpc_pack).  One thread per output word of
// out[N, SW], assembled by dg::pack_word (serdes.cuh), the function the
// TX enqueue's packed push (ring_push.cu) writes its kept rows with.
#include "common.cuh"
#include "serdes.cuh"

static __global__ void rpc_pack_kernel(dg::PackSrc src,
                                       uint32_t* __restrict__ out, int N,
                                       int SW) {
  long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= (long long)N * SW) return;
  out[k] = dg::pack_word(src, (int)(k / SW), (int)(k % SW));
}

extern "C" int dg_rpc_pack(const int* conn, const int* rpc, const int* fn,
                           const int* flags, const int* plen,
                           const int* frag, const int* ts,
                           const int* payload, int* out, int N, int PW,
                           int SW, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long work = (long long)N * SW;
  if (work > 0) {
    dg::PackSrc src{conn, rpc, fn, flags, plen, frag, ts, payload, PW};
    unsigned blocks = (unsigned)((work + 255) / 256);
    rpc_pack_kernel<<<blocks, 256, 0, s>>>(src, (uint32_t*)out, N, SW);
  }
  return (int)cudaGetLastError();
}
