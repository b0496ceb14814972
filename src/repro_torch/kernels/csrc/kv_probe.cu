// kv_probe: set-associative bucket probe of the KVS store (the MICA GET,
// paper §5.6).  Replaces the Pallas kernel repro/kernels/kv_probe.py
// (kv_probe).  For query i: bucket b = q_bucket[i] (indices in [-NB, 0)
// count from the end, then b is clamped into [0, NB - 1], as JAX's
// gather does), the first way j with tags[b, j] == q_tag[i] (uint32
// bits; a query tag of 0 matches an empty way, as in the oracle), then
// val[i] = values[b, j] or zeros, hit[i] = (a way matched).
//
// Bound on the card: bytes at random addresses.  A query needs its
// bucket's tag sector and, on a hit, its value row's sector; what it
// waits on is the chain query -> tags -> value, three dependent trips to
// device memory, so the card needs many queries in flight.  Two paths,
// chosen by the host from shapes and alignment:
//
//   * vector (WAYS == 4, VW a multiple of 4, 16-byte aligned tables):
//     one thread a query, its four tags one uint4 load through the
//     read-only path, its value row VW / 4 int4 loads issued two at a
//     time (one 32-byte row at VW 8), its output row int4 stores.  The
//     loads in flight come from the many resident warps: on the card,
//     two, four and eight queries a thread with all their loads issued
//     together ran slower than one, as they cost registers and so
//     resident warps (``kv_probe_sweep.py`` builds and times them).
//   * scalar (any shape): one thread per (query, value word), the
//     threads of a query reading the bucket's tags together and copying
//     one word each of the matched row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    kv_probe_vec(const uint4* __restrict__ tags,
                 const int4* __restrict__ values,
                 const int* __restrict__ q_bucket,
                 const uint32_t* __restrict__ q_tag,
                 int4* __restrict__ out_val,
                 unsigned char* __restrict__ out_hit, int NB, int VQ, int N) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= N) return;
  int b = __ldg(q_bucket + i);
  const uint32_t t = __ldg(q_tag + i);
  if (b < 0) b += NB;
  b = min(max(b, 0), NB - 1);
  const uint4 g = __ldg(tags + b);
  const int way = g.x == t ? 0 : g.y == t ? 1 : g.z == t ? 2
                : g.w == t ? 3 : -1;
  out_hit[i] = way >= 0 ? 1 : 0;
  const int4* row = values + ((long long)b * 4 + (way < 0 ? 0 : way)) * VQ;
  int4* dst = out_val + i * VQ;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int c = 0; c < VQ; c += 2) {
    const int4 v0 = way >= 0 ? __ldg(row + c) : zero;
    const int4 v1 = way >= 0 && c + 1 < VQ ? __ldg(row + c + 1) : zero;
    dst[c] = v0;
    if (c + 1 < VQ) dst[c + 1] = v1;
  }
}

__global__ void kv_probe_scalar(const uint32_t* __restrict__ tags,
                                const int* __restrict__ values,
                                const int* __restrict__ q_bucket,
                                const uint32_t* __restrict__ q_tag,
                                int* __restrict__ out_val,
                                unsigned char* __restrict__ out_hit, int NB,
                                int WAYS, int VW, int N) {
  const int T = VW > 0 ? VW : 1;
  long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= (long long)N * T) return;
  int i = (int)(k / T);
  int w = (int)(k % T);
  int b = q_bucket[i];
  if (b < 0) b += NB;
  b = min(max(b, 0), NB - 1);
  const uint32_t t = q_tag[i];
  const uint32_t* bt = tags + (long long)b * WAYS;
  int way = -1;
  for (int j = 0; j < WAYS; ++j) {
    if (bt[j] == t) {
      way = j;
      break;
    }
  }
  if (w < VW) {
    out_val[(long long)i * VW + w] =
        way >= 0 ? values[((long long)b * WAYS + way) * VW + w] : 0;
  }
  if (w == 0) out_hit[i] = way >= 0 ? 1 : 0;
}

}  // namespace

extern "C" int dg_kv_probe(const int* tags, const int* values,
                           const int* q_bucket, const int* q_tag,
                           int* out_val, void* out_hit, int NB, int WAYS,
                           int VW, int N, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 0 || NB <= 0) return (int)cudaGetLastError();
  if (vec) {
    const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
    kv_probe_vec<<<blocks, kThreads, 0, s>>>(
        (const uint4*)tags, (const int4*)values, q_bucket,
        (const uint32_t*)q_tag, (int4*)out_val, (unsigned char*)out_hit, NB,
        VW / 4, N);
  } else {
    const long long work = (long long)N * (VW > 0 ? VW : 1);
    const unsigned blocks = (unsigned)((work + kThreads - 1) / kThreads);
    kv_probe_scalar<<<blocks, kThreads, 0, s>>>(
        (const uint32_t*)tags, values, q_bucket, (const uint32_t*)q_tag,
        out_val, (unsigned char*)out_hit, NB, WAYS, VW, N);
  }
  return (int)cudaGetLastError();
}
