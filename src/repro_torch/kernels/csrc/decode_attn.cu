// decode_attention: GQA flash-decoding, one new query token per slot
// against that slot's KV cache.  Replaces the Pallas kernel
// repro/kernels/decode_attn.py (decode_attention).
//
// q [B, NQ, HD], K/V [B, S, NKV, HD] (float or bf16), lengths [B] int32
// -> out [B, NQ, HD] float: for slot b and query head h*G + i (G = NQ/NKV
// query heads share kv head h), softmax over positions t of
// (q . k_t) * HD^-0.5, with positions t >= lengths[b] scored -1e30 (a
// finite sentinel, as in the reference: a length of 0 masks every row
// and gives mean(v) over all S), then the weighted sum of v_t.
//
// The TPU kernel walks S as the innermost, in-order grid axis and keeps
// the online-softmax state (m, l, acc) in VMEM across it.  CUDA blocks
// run in no order, so the state is carried explicitly:
//   1. decode_attn_split: one block of 4 warps per (KV split of SPLIT
//      positions, slot, kv head).  Each warp takes every 4th position
//      of the split: its lanes hold HD/32 columns of the G query rows
//      and of the accumulators, read the position's K row (lane-strided,
//      coalesced), reduce the G dot products with shuffles and update
//      (m, l, acc) online.  The four warps' states are merged in warp
//      order through shared memory into one partial per split.
//   2. decode_attn_combine: one block per (slot, kv head) merges the
//      partials of the non-empty splits in split order and writes
//      acc / max(l, 1e-30).
// A split past the slot's valid prefix is skipped, so only the prefix is
// read (for length >= 1 a masked row has weight exp(-1e30 - m) = 0, so
// skipping it changes nothing); a length of 0 visits all S rows.
//
// Bound on the card: bytes — the valid K/V prefix of every (slot, kv
// head) read once; about 4G flops per K/V element pair, far below the
// compute peak.  This first version is plain CUDA-core code (no TMA, no
// tensor cores).
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Partial of one (slot, kv head, split): m[G], l[G], acc[G][HD].
__device__ __forceinline__ size_t part_floats(int G, int HD) {
  return (size_t)G * (HD + 2);
}

template <typename T, int KV>
__global__ void decode_attn_split(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const int* __restrict__ lengths,
                                  float* __restrict__ work, int S, int NKV,
                                  int G, int HD, int SPLIT, int NSPLIT,
                                  float scale) {
  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / NKV;
  const int h = bh % NKV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = lengths[b];
  const int eff = len > 0 ? min(len, S) : S;
  const int lo = split * SPLIT;
  const int hi = min(lo + SPLIT, eff);
  if (lo >= hi) return;  // past the prefix: the combine never reads it

  float qr[kMaxG][KV], acc[kMaxG][KV], m[kMaxG], l[kMaxG];
  const T* qb = q + ((size_t)b * NKV + h) * G * HD;
#pragma unroll
  for (int i = 0; i < kMaxG; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < KV; ++c) {
      const int d = lane + 32 * c;
      qr[i][c] = (i < G && d < HD) ? to_f(qb[i * HD + d]) : 0.f;
      acc[i][c] = 0.f;
    }
  }
  const size_t row = (size_t)NKV * HD;  // elements between positions
  const T* kb = k + ((size_t)b * S * NKV + h) * HD;
  const T* vb = v + ((size_t)b * S * NKV + h) * HD;
  for (int t = lo + warp; t < hi; t += kWarps) {
    float kr[KV], vr[KV];
#pragma unroll
    for (int c = 0; c < KV; ++c) {
      const int d = lane + 32 * c;
      kr[c] = d < HD ? to_f(kb[t * row + d]) : 0.f;
      vr[c] = d < HD ? to_f(vb[t * row + d]) : 0.f;
    }
    const bool valid = t < len;
#pragma unroll
    for (int i = 0; i < kMaxG; ++i) {
      if (i < G) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < KV; ++c) s += qr[i][c] * kr[c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(DG_FULL_MASK, s, o);
        const float sc = valid ? s * scale : kNegInf;
        const float mn = fmaxf(m[i], sc);
        const float alpha = expf(m[i] - mn);
        const float p = expf(sc - mn);
        l[i] = l[i] * alpha + p;
#pragma unroll
        for (int c = 0; c < KV; ++c) acc[i][c] = acc[i][c] * alpha + p * vr[c];
        m[i] = mn;
      }
    }
  }

  // Merge the warps' states in warp order.  A warp that saw no position
  // holds (-1e30, 0, 0), which adds nothing.
  extern __shared__ float sm[];
  const size_t pf = part_floats(G, HD);
  float* mine = sm + warp * pf;
#pragma unroll
  for (int i = 0; i < kMaxG; ++i) {
    if (i < G) {
      if (lane == 0) {
        mine[i] = m[i];
        mine[G + i] = l[i];
      }
#pragma unroll
      for (int c = 0; c < KV; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) mine[2 * G + i * HD + d] = acc[i][c];
      }
    }
  }
  __syncthreads();
  float* part = work + ((size_t)bh * NSPLIT + split) * pf;
  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x) {
    const int i = idx / HD;
    const int d = idx % HD;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm[w * pf + i]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = sm + w * pf;
      const float e = expf(pw[i] - M);
      L += pw[G + i] * e;
      A += pw[2 * G + i * HD + d] * e;
    }
    part[2 * G + i * HD + d] = A;
    if (d == 0) {
      part[i] = M;
      part[G + i] = L;
    }
  }
}

__global__ void decode_attn_combine(const float* __restrict__ work,
                                    const int* __restrict__ lengths,
                                    float* __restrict__ out, int S, int NKV,
                                    int G, int HD, int SPLIT, int NSPLIT) {
  const int bh = blockIdx.x;
  const int b = bh / NKV;
  const int len = lengths[b];
  const int eff = len > 0 ? min(len, S) : S;
  const int used = (eff + SPLIT - 1) / SPLIT;  // non-empty splits
  const size_t pf = part_floats(G, HD);
  const float* base = work + (size_t)bh * NSPLIT * pf;
  float* ob = out + (size_t)bh * G * HD;  // heads h*G .. h*G+G-1 of slot b
  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x) {
    const int i = idx / HD;
    const int d = idx % HD;
    float M = kNegInf;
    for (int s = 0; s < used; ++s) M = fmaxf(M, base[s * pf + i]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < used; ++s) {
      const float* ps = base + s * pf;
      const float e = expf(ps[i] - M);
      L += ps[G + i] * e;
      A += ps[2 * G + i * HD + d] * e;
    }
    ob[i * HD + d] = A / fmaxf(L, 1e-30f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, float* out, float* work, int B, int S,
                   int NKV, int G, int HD, int SPLIT, cudaStream_t stream) {
  const int nsplit = (S + SPLIT - 1) / SPLIT;
  const dim3 grid(nsplit, B * NKV);
  const size_t smem = (size_t)kWarps * G * (HD + 2) * sizeof(float);
  const float scale = (float)std::pow((double)HD, -0.5);  // hd ** -0.5
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
#define DG_SPLIT(KV)                                                        \
  decode_attn_split<T, KV><<<grid, kWarps * 32, smem, stream>>>(            \
      qt, kt, vt, lengths, work, S, NKV, G, HD, SPLIT, nsplit, scale)
  if (HD <= 32) {
    DG_SPLIT(1);
  } else if (HD <= 64) {
    DG_SPLIT(2);
  } else if (HD <= 128) {
    DG_SPLIT(4);
  } else {
    DG_SPLIT(8);
  }
#undef DG_SPLIT
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<<<B * NKV, 256, 0, stream>>>(work, lengths, out, S, NKV,
                                                   G, HD, SPLIT, nsplit);
  return cudaGetLastError();
}

}  // namespace

// G <= 8 and HD <= 256 (checked by the Python wrapper); work holds
// B * NKV * ceil(S / SPLIT) * G * (HD + 2) floats.
extern "C" int dg_decode_attention(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   float* out, float* work, int B, int S,
                                   int NKV, int G, int HD, int SPLIT,
                                   int is_bf16, void* stream) {
  if (B <= 0 || NKV <= 0 || G <= 0 || HD <= 0 || S <= 0) return 0;
  if (G > kMaxG || HD > 256 || SPLIT <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, lengths, out, work, B, S, NKV,
                                      G, HD, SPLIT, s)
              : launch<float>(q, k, v, lengths, out, work, B, S, NKV, G, HD,
                              SPLIT, s);
  return (int)err;
}
