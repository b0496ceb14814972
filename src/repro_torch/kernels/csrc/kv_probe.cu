// kv_probe: set-associative bucket probe of the KVS store (the MICA GET,
// paper §5.6).  Replaces the Pallas kernel repro/kernels/kv_probe.py
// (kv_probe).  For query i: bucket b = q_bucket[i] (indices in [-NB, 0)
// count from the end, then b is clamped into [0, NB - 1], as JAX's
// gather does), the first way j with tags[b, j] == q_tag[i] (uint32
// bits; a query tag of 0 matches an empty way, as in the oracle), then
// val[i] = values[b, j] or zeros, hit[i] = (a way matched).
//
// One thread per (query, value word): the VW threads of a query read
// the same WAYS tags (one 32-byte sector, broadcast) and each copies one
// word of the matched row (the VW words of a row are one sector).  A
// random query costs one tag sector and, on a hit, one value sector.
#include "common.cuh"

static __global__ void kv_probe_kernel(const uint32_t* __restrict__ tags,
                                       const int* __restrict__ values,
                                       const int* __restrict__ q_bucket,
                                       const uint32_t* __restrict__ q_tag,
                                       int* __restrict__ out_val,
                                       unsigned char* __restrict__ out_hit,
                                       int NB, int WAYS, int VW, int N) {
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

extern "C" int dg_kv_probe(const int* tags, const int* values,
                           const int* q_bucket, const int* q_tag,
                           int* out_val, void* out_hit, int NB, int WAYS,
                           int VW, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long work = (long long)N * (VW > 0 ? VW : 1);
  if (work > 0 && NB > 0) {
    unsigned blocks = (unsigned)((work + 255) / 256);
    kv_probe_kernel<<<blocks, 256, 0, s>>>(
        (const uint32_t*)tags, values, q_bucket, (const uint32_t*)q_tag,
        out_val, (unsigned char*)out_hit, NB, WAYS, VW, N);
  }
  return (int)cudaGetLastError();
}
