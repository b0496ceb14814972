// rpc_pack: pack header field arrays and a payload into wire slots (the
// RPC unit's serdes stage).  Replaces the Pallas kernel
// repro/kernels/rpc_pack.py (rpc_pack).  One thread per output word of
// out[N, SW]: words 0-4 are the header (conn_id, rpc_id, fn_id | flags
// << 16, payload_len | frag_idx << 16, timestamp), words 5.. the payload
// [N, PW] cut or zero-padded to SW - 5 words.  The header halves are
// assembled in uint32_t: flags or frag_idx of 0x8000 and above shift
// into the sign bit, which JAX and PyTorch wrap but a signed C++ shift
// leaves undefined.
#include "common.cuh"

#define DG_HEADER_WORDS 5

static __global__ void rpc_pack_kernel(
    const int* __restrict__ conn, const int* __restrict__ rpc,
    const int* __restrict__ fn, const int* __restrict__ flags,
    const int* __restrict__ plen, const int* __restrict__ frag,
    const int* __restrict__ ts, const int* __restrict__ payload,
    uint32_t* __restrict__ out, int N, int PW, int SW) {
  long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= (long long)N * SW) return;
  int i = (int)(k / SW);
  int w = (int)(k % SW);
  uint32_t v;
  switch (w) {
    case 0: v = (uint32_t)conn[i]; break;
    case 1: v = (uint32_t)rpc[i]; break;
    case 2: v = ((uint32_t)fn[i] & 0xFFFFu) | ((uint32_t)flags[i] << 16);
      break;
    case 3: v = ((uint32_t)plen[i] & 0xFFFFu)
                | (((uint32_t)frag[i] & 0xFFFFu) << 16);
      break;
    case 4: v = (uint32_t)ts[i]; break;
    default: {
      int p = w - DG_HEADER_WORDS;
      v = p < PW ? (uint32_t)payload[(long long)i * PW + p] : 0u;
    }
  }
  out[k] = v;
}

extern "C" int dg_rpc_pack(const int* conn, const int* rpc, const int* fn,
                           const int* flags, const int* plen,
                           const int* frag, const int* ts,
                           const int* payload, int* out, int N, int PW,
                           int SW, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long work = (long long)N * SW;
  if (work > 0) {
    unsigned blocks = (unsigned)((work + 255) / 256);
    rpc_pack_kernel<<<blocks, 256, 0, s>>>(conn, rpc, fn, flags, plen, frag,
                                           ts, payload, (uint32_t*)out, N, PW,
                                           SW);
  }
  return (int)cudaGetLastError();
}
