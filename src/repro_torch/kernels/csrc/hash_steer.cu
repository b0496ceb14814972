// hash_steer: FNV-1a object-level steering (MICA's key -> partition
// hash, the DeviceKVS bucket hash).  Replaces the Pallas kernels
// repro/kernels/hash_steer.py (hash_steer_static, hash_steer).  One
// thread per row of payload[N, W]: byte-serial FNV-1a over the first KW
// words (dg::fnv1a), all in uint32_t.  The modulus is the static
// n_flows, or, when flows_dev is not null, the int32 device scalar it
// points to read as uint32 (hash_steer's runtime active-flow count: no
// host sync).  A static n_flows of 0 returns the raw hash (bits stored
// as int32); a runtime modulus of 0 counts as 1, as jnp.remainder does.
//
// hash_bucket_tag: the KVS's whole key -> (bucket, tag, victim way) step
// in one launch (DeviceKVS._bucket_tag and set's victim way,
// repro/runtime/kvs.py), in place of the raw hash plus the PyTorch
// arithmetic around it.  One thread per key row, sharing dg::fnv1a with
// hash_steer_kernel: h = FNV-1a of the row's first KW words, bucket =
// h % nb, tag = h | 1, way = (h >> 16) % ways, all in uint32_t, written
// as the int32 bits.  The rows lie `stride` words apart, so the key
// columns of a request payload are read where they are, uncopied.
// Bound: bytes, the key words read once and three words written a row.
#include "common.cuh"

static __global__ void hash_steer_kernel(const int* __restrict__ payload,
                                         int* __restrict__ out, int N, int W,
                                         int KW, unsigned n_flows,
                                         const int* __restrict__ flows_dev) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t h = dg::fnv1a(payload + (long long)i * W, KW);
  if (flows_dev != nullptr) {
    uint32_t m = (uint32_t)*flows_dev;
    h = h % (m == 0u ? 1u : m);
  } else if (n_flows != 0u) {
    h = h % n_flows;
  }
  ((uint32_t*)out)[i] = h;
}

extern "C" int dg_hash_steer(const int* payload, int* out, int N, int W,
                             int KW, int n_flows, const int* flows_dev,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 0) {
    unsigned blocks = (unsigned)((N + 255) / 256);
    hash_steer_kernel<<<blocks, 256, 0, s>>>(payload, out, N, W, KW,
                                             (unsigned)n_flows, flows_dev);
  }
  return (int)cudaGetLastError();
}

static __global__ void hash_bucket_tag_kernel(const int* __restrict__ keys,
                                              uint32_t* __restrict__ out,
                                              int N, int stride, int KW,
                                              unsigned nb, unsigned ways) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t h = dg::fnv1a(keys + (long long)i * stride, KW);
  out[i] = h % nb;                       // bucket
  out[(long long)N + i] = h | 1u;        // tag: nonzero
  out[2LL * N + i] = (h >> 16) % ways;   // victim way
}

// out [3, N]: bucket, tag, way.
extern "C" int dg_hash_bucket_tag(const int* keys, int* out, int N,
                                  int stride, int KW, int nb, int ways,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 0) {
    unsigned blocks = (unsigned)((N + 255) / 256);
    hash_bucket_tag_kernel<<<blocks, 256, 0, s>>>(
        keys, (uint32_t*)out, N, stride, KW, (unsigned)nb, (unsigned)ways);
  }
  return (int)cudaGetLastError();
}
