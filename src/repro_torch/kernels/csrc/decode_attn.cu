// decode_attention: GQA flash-decoding, one new query token per slot
// against that slot's KV cache, in ONE launch.  Replaces the Pallas
// kernel repro/kernels/decode_attn.py (decode_attention).
//
// q [B, NQ, HD], K/V [B, S, NKV, HD] (bf16 or float), lengths [B] int32
// -> out [B, NQ, HD] float: for slot b and query head h*G + i (G = NQ/NKV
// query heads share kv head h), softmax over positions t of
// (q . k_t) * HD^-0.5, with positions t >= lengths[b] scored -1e30 (a
// finite sentinel, as in the reference: a length of 0 masks every row
// and gives mean(v) over all S), then the weighted sum of v_t.
//
// Bound on the card: bytes — the valid K/V prefix of every (slot, kv
// head) read once (about 1 KiB a valid position at Qwen2-1.5B's nkv 2,
// hd 128, bf16); about 4G flops per K/V element pair, far below the
// tensor cores' rate.
//
// The TPU kernel walks S as an in-order grid axis with (m, l, acc) in
// VMEM.  Here each (slot, kv head) is one thread-block cluster of C CTAs
// of 4 warps (C <= 4, from the shapes and the SM count on the host, so
// that the CTAs cover the card once): CTA j takes the j-th of C
// contiguous runs of the valid prefix's 64-row tiles, so only the prefix
// is read (a length of 0 reads all S rows) and a slot's rows stream
// through C SMs at once — one SM alone cannot keep enough loads in
// flight to read at the card's rate.  Two paths:
//
//   * bf16, HD a multiple of 16 (the main path): tensor cores.  64-row K
//     and V tiles are staged in shared memory by 16-byte cp.async into a
//     ring of 2 stages, K and V in separate groups so the scores of a
//     tile start while its V is in flight, rows swizzled by 16-byte chunk
//     against bank conflicts, rows past the prefix zero-filled.  Each
//     warp owns 16 rows of a tile: S^T[16 x 8] = K[16 x HD] Q^T by
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate) with the cache rows as
//     M and the G <= 8 query rows as N (padded to 8 with zero rows of
//     Q), K read by ldmatrix and Q^T held in registers; the online
//     softmax per query column reduces over the 8 lanes of the column;
//     then O^T[HD x 8] += V^T[HD x 16] P^T with V read by ldmatrix.trans
//     and P cast to bf16 (as SDPA does; the row sums are taken of the
//     cast values) and turned into the B fragment through 256 bytes of
//     shared memory a warp.
//   * float32 (and bf16 with HD not a multiple of 16): CUDA cores, a warp
//     a row, each lane HD/32 contiguous columns loaded as one vector (16
//     bytes at HD 128), five shuffles a dot product.  TF32 tensor cores
//     would miss the float32 tolerance (2e-5).
//
// Both paths merge their warps in shared memory, in warp order, into the
// CTA's partial (m, l, acc); after a cluster barrier each CTA merges a
// slice of the outputs over the cluster's partials, in CTA order, read
// from distributed shared memory, and a second barrier keeps every
// partial alive until all are read.  Nothing goes through device memory
// but the inputs and the output.  Exponentials are base 2 on
// log2(e)-scaled scores throughout.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cmath>
#include <utility>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;
constexpr int kTile = 64;    // rows of a staged tile (16 per warp)
constexpr int kStages = 2;   // K/V tile pairs in flight per CTA
constexpr int kMaxCluster = 4;
constexpr float kNegInf = -1e30f;


// Per-warp state in shared memory: m[8], l[8], acc[8][HD] floats; the
// CTA's partial follows the four warps' states in the same layout.
__host__ __device__ __forceinline__ int warp_floats(int HD) {
  return kMaxG * (HD + 2);
}
__host__ __device__ __forceinline__ size_t merge_bytes(int HD) {
  return (size_t)(kWarps + 1) * warp_floats(HD) * sizeof(float);
}

// The rows [lo, hi) of CTA `rank` of `nc`: the rank-th of nc contiguous
// runs of the valid prefix's 64-row tiles (a length of 0 covers all S
// rows); empty for CTAs past the prefix.
struct Rows {
  int len, lo, hi;
};
__device__ __forceinline__ Rows cta_rows(const int* lengths, int b, int S,
                                         int rank, int nc) {
  const int len = lengths[b];
  const int eff = len > 0 ? min(len, S) : S;
  const int ntiles = (eff + kTile - 1) / kTile;
  const int per = (ntiles + nc - 1) / nc;
  const int lo = min(rank * per * kTile, eff);
  return Rows{len, lo, min(lo + per * kTile, eff)};
}

// ---------------------------------------------------------------- epilogue
// Merge the four warps' states (in shared memory at sm) into the CTA's
// partial, then — once every CTA of the cluster has its partial — write
// this CTA's slice of out[bh] from the cluster's partials, in CTA order.
// A CTA or warp without rows holds (-1e30, 0, 0), which adds nothing.
__device__ void merge_and_write(float* sm, float* __restrict__ out, int bh,
                                int G, int HD) {
  cg::cluster_group cluster = cg::this_cluster();
  const int wf = warp_floats(HD);
  float* part = sm + kWarps * wf;
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int i = idx / HD;
    const int d = idx % HD;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm[w * wf + i]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = sm + w * wf;
      const float e = exp2f(pw[i] - M);
      L += pw[kMaxG + i] * e;
      A += pw[2 * kMaxG + i * HD + d] * e;
    }
    part[2 * kMaxG + i * HD + d] = A;
    if (d == 0) {
      part[i] = M;
      part[kMaxG + i] = L;
    }
  }
  cluster.sync();
  const int nc = (int)cluster.num_blocks();
  const int n = G * HD;
  const int per = (n + nc - 1) / nc;
  const int lo = (int)cluster.block_rank() * per;
  const int hi = min(n, lo + per);
  float* ob = out + (size_t)bh * G * HD;  // heads h*G .. h*G+G-1 of slot b
  for (int idx = lo + threadIdx.x; idx < hi; idx += kThreads) {
    const int i = idx / HD;
    const int d = idx % HD;
    float M = kNegInf;
    for (int c = 0; c < nc; ++c)
      M = fmaxf(M, cluster.map_shared_rank(part, c)[i]);
    float L = 0.f, A = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float* pc = cluster.map_shared_rank(part, c);
      const float e = exp2f(pc[i] - M);
      L += pc[kMaxG + i] * e;
      A += pc[2 * kMaxG + i * HD + d] * e;
    }
    ob[idx] = A / fmaxf(L, 1e-30f);
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

// ------------------------------------------------------ tensor-core path
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned& r0, unsigned& r1,
                                          unsigned& r2, unsigned& r3,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

// D = A * B + D, m16n8k16, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of 16-byte chunk c of tile row r (chunks XOR-swizzled
// by the row, so the 8 rows an ldmatrix reads fall in distinct banks).
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CH = HD / 8;
  constexpr int MASK = CH < 8 ? CH - 1 : 7;
  return r * HD + ((c ^ (r & MASK)) << 3);
}

// Fragment layout (lane = 4 g + t): with cache rows as M and the query
// rows as N, S^T[16 x 8] = K[16 x HD] Q^T[HD x 8]; this lane holds
// S^T[g][2t], [g][2t+1], [g+8][2t], [g+8][2t+1] — rows g and g+8 of the
// warp's 16, queries 2t and 2t+1.  O^T[HD x 8] += V^T[HD x 16] P^T[16 x 8]
// leaves O^T[16 mt + g (+8)][2t (+1)] in o[mt].
template <int HD>
__global__ void __launch_bounds__(kThreads)
    decode_attn_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ lengths,
                   float* __restrict__ out, int S, int NKV, int G,
                   float scale2) {
  constexpr int KS = HD / 16;  // k-steps of K Q^T; m-tiles of V^T P^T
  constexpr int CH = HD / 8;   // 16-byte chunks a row
  const int bh = blockIdx.y;  // one cluster (along x) per (slot, kv head)
  const int b = bh / NKV;
  const int h = bh % NKV;
  const Rows rows = cta_rows(lengths, b, S, blockIdx.x, gridDim.x);
  const int len = rows.len;
  const int lo = rows.lo;
  const int hi = rows.hi;
  const int ntiles = (hi - lo + kTile - 1) / kTile;  // 0 past the prefix
  constexpr int nst = kStages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [nst][64][HD]
  bf16* vs = ks + (size_t)nst * kTile * HD;      // [nst][64][HD]
  // P^T of each warp, as P[8 queries][16 rows] (the B fragment's order)
  bf16* pt = vs + (size_t)nst * kTile * HD + warp * kMaxG * 16;

  const size_t row = (size_t)NKV * HD;  // elements between positions
  const bf16* kb = k + ((size_t)b * S * NKV + h) * HD;
  const bf16* vb = v + ((size_t)b * S * NKV + h) * HD;
  auto load = [&](const bf16* src, bf16* dst, int tile) {
    const int r0 = lo + tile * kTile;
    for (int x = threadIdx.x; x < kTile * CH; x += kThreads) {
      const int r = x / CH;
      const int c = x % CH;
      const bool ok = r0 + r < hi;
      cp_async16(dst + swz<HD>(r, c), src + (ok ? (r0 + r) * row : 0) + c * 8,
                 ok);
    }
  };
  // prologue: tiles 0 .. nst-1, K and V in separate groups
  for (int st = 0; st < nst; ++st) {
    if (st < ntiles) load(kb, ks + (size_t)st * kTile * HD, st);
    cp_commit();
    if (st < ntiles) load(vb, vs + (size_t)st * kTile * HD, st);
    cp_commit();
  }

  // Q^T as the B operand: query g (zero for g >= G), columns 16 ks + 2t
  // (+1) and 16 ks + 8 + 2t (+1)
  unsigned qb[KS][2];
  const bf16* qrow = q + (((size_t)b * NKV + h) * G + (g < G ? g : 0)) * HD;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    qb[j][0] = g < G ? *reinterpret_cast<const unsigned*>(
                           qrow + 16 * j + 2 * t4)
                     : 0u;
    qb[j][1] = g < G ? *reinterpret_cast<const unsigned*>(
                           qrow + 16 * j + 8 + 2 * t4)
                     : 0u;
  }
  float o[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % nst;
    const bf16* kt = ks + (size_t)st * kTile * HD;
    const bf16* vt = vs + (size_t)st * kTile * HD;
    cp_wait<2 * nst - 1>();  // K of tile it (later groups may pend)
    __syncthreads();
    // S^T = K Q^T for this warp's 16 rows
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        unsigned a[4];
        ldsm_x4(a[0], a[1], a[2], a[3], kt + swz<HD>(r, 2 * j + (lane >> 4)));
        mma_bf16(s, a, qb[j][0], qb[j][1]);
      }
    }
    // scale and mask: rows past the CTA's run are out (-inf); a length of 0
    // scores every row -1e30
    const int key = lo + it * kTile + warp * 16 + g;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = key + (e >> 1) * 8;
      s[e] = kk < hi ? (len > 0 ? s[e] * scale2 : kNegInf) : -INFINITY;
    }
    // online softmax per query column: max over the warp's 16 rows
    float alpha[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float mx = fmaxf(s[c], s[c + 2]);
      mx = fmaxf(mx, __shfl_xor_sync(DG_FULL_MASK, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(DG_FULL_MASK, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(DG_FULL_MASK, mx, 16));
      const float m_new = fmaxf(m_run[c], mx);
      alpha[c] = exp2f(m_run[c] - m_new);
      m_run[c] = m_new;
    }
    // P in bf16 (the row sums take the cast values), stored transposed
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bf16 pb = __float2bfloat16_rn(exp2f(s[e] - m_run[e & 1]));
      pr[e] = __bfloat162float(pb);
      pt[(2 * t4 + (e & 1)) * 16 + g + (e >> 1) * 8] = pb;
    }
    l_run[0] = l_run[0] * alpha[0] + pr[0] + pr[2];
    l_run[1] = l_run[1] * alpha[1] + pr[1] + pr[3];
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[1];
      o[j][2] *= alpha[0];
      o[j][3] *= alpha[1];
    }
    __syncwarp();
    const unsigned pb0 =
        *reinterpret_cast<const unsigned*>(pt + g * 16 + 2 * t4);
    const unsigned pb1 =
        *reinterpret_cast<const unsigned*>(pt + g * 16 + 8 + 2 * t4);
    cp_wait<2 * nst - 2>();  // V of tile it
    __syncthreads();
    // O^T += V^T P^T: V^T fragments by ldmatrix.trans
    {
      const int r = warp * 16 + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        unsigned a[4];
        ldsm_x4_t(a[0], a[1], a[2], a[3],
                  vt + swz<HD>(r, 2 * j + ((lane >> 3) & 1)));
        mma_bf16(o[j], a, pb0, pb1);
      }
    }
    __syncthreads();  // stage st and pt are free
    if (it + nst < ntiles) load(kb, ks + (size_t)st * kTile * HD, it + nst);
    cp_commit();
    if (it + nst < ntiles) load(vb, vs + (size_t)st * kTile * HD, it + nst);
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();

  // row sums over the 8 lanes of a query column, then the warp's state
  // into shared memory
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    l_run[c] += __shfl_xor_sync(DG_FULL_MASK, l_run[c], 4);
    l_run[c] += __shfl_xor_sync(DG_FULL_MASK, l_run[c], 8);
    l_run[c] += __shfl_xor_sync(DG_FULL_MASK, l_run[c], 16);
  }
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* mine = sm + warp * warp_floats(HD);
  if (g == 0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      mine[2 * t4 + c] = m_run[c];
      mine[kMaxG + 2 * t4 + c] = l_run[c];
    }
  }
#pragma unroll
  for (int j = 0; j < KS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * j + g + (e >> 1) * 8;
      mine[2 * kMaxG + (2 * t4 + (e & 1)) * HD + d] = o[j][e];
    }
  }
  __syncthreads();
  merge_and_write(sm, out, bh, G, HD);
}

// ----------------------------------------------------- CUDA-core path
// CPL contiguous columns per lane, loaded as one vector where they fit.
template <int CPL>
__device__ __forceinline__ void load_cols(const float* p, int d0, int HD,
                                          float* x) {
  if (d0 + CPL <= HD && HD % CPL == 0) {
    if constexpr (CPL % 4 == 0) {
#pragma unroll
      for (int c = 0; c < CPL; c += 4) {
        const float4 f = *reinterpret_cast<const float4*>(p + d0 + c);
        x[c] = f.x;
        x[c + 1] = f.y;
        x[c + 2] = f.z;
        x[c + 3] = f.w;
      }
      return;
    } else if constexpr (CPL == 2) {
      const float2 f = *reinterpret_cast<const float2*>(p + d0);
      x[0] = f.x;
      x[1] = f.y;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) x[c] = d0 + c < HD ? p[d0 + c] : 0.f;
}

template <int CPL>
__device__ __forceinline__ void load_cols(const bf16* p, int d0, int HD,
                                          float* x) {
  if (d0 + CPL <= HD && CPL % 2 == 0 && HD % 2 == 0) {
#pragma unroll
    for (int c = 0; c < CPL; c += 2) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + d0 + c));
      x[c] = f.x;
      x[c + 1] = f.y;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    x[c] = d0 + c < HD ? __bfloat162float(p[d0 + c]) : 0.f;
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
    decode_attn_cc(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   float* __restrict__ out, int S, int NKV, int G, int HD,
                   float scale2) {
  const int bh = blockIdx.y;  // one cluster (along x) per (slot, kv head)
  const int b = bh / NKV;
  const int h = bh % NKV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Rows rows = cta_rows(lengths, b, S, blockIdx.x, gridDim.x);
  const int len = rows.len;
  const int lo = rows.lo;
  const int hi = rows.hi;
  const int d0 = lane * CPL;

  float qr[kMaxG][CPL], acc[kMaxG][CPL], m[kMaxG], l[kMaxG];
  const T* qb = q + ((size_t)b * NKV + h) * G * HD;
#pragma unroll
  for (int i = 0; i < kMaxG; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    if (i < G) {
      load_cols<CPL>(qb + i * HD, d0, HD, qr[i]);
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c) qr[i][c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }
  const size_t row = (size_t)NKV * HD;
  const T* kb = k + ((size_t)b * S * NKV + h) * HD;
  const T* vb = v + ((size_t)b * S * NKV + h) * HD;
  for (int t = lo + warp; t < hi; t += kWarps) {
    float kr[CPL], vr[CPL];
    load_cols<CPL>(kb + t * row, d0, HD, kr);
    load_cols<CPL>(vb + t * row, d0, HD, vr);
    const bool valid = t < len;
#pragma unroll
    for (int i = 0; i < kMaxG; ++i) {
      if (i < G) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) s += qr[i][c] * kr[c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(DG_FULL_MASK, s, o);
        const float sc = valid ? s * scale2 : kNegInf;
        const float mn = fmaxf(m[i], sc);
        const float alpha = exp2f(m[i] - mn);
        const float p = exp2f(sc - mn);
        l[i] = l[i] * alpha + p;
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = acc[i][c] * alpha + p * vr[c];
        m[i] = mn;
      }
    }
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* mine = sm + warp * warp_floats(HD);
#pragma unroll
  for (int i = 0; i < kMaxG; ++i) {
    if (lane == 0) {
      mine[i] = m[i];
      mine[kMaxG + i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (d0 + c < HD) mine[2 * kMaxG + i * HD + d0 + c] = acc[i][c];
    }
  }
  __syncthreads();
  merge_and_write(sm, out, bh, G, HD);
}

// ------------------------------------------------------------- launch
// CTAs per cluster: enough that the B * NKV clusters cover every SM once,
// at most 4 (larger clusters are harder to place on the GPCs) and at most
// one a tile of S.  At phase 6's 64 (slot, head) pairs that is 3.
int cluster_ctas(int BH, int S) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  int nc = (sms + BH - 1) / BH;
  const int tiles = (S + kTile - 1) / kTile;
  nc = nc < tiles ? nc : tiles;
  return nc < 1 ? 1 : (nc > kMaxCluster ? kMaxCluster : nc);
}

// Launch `kernel` on a (C, B * NKV) grid in clusters of C along x, its
// dynamic shared memory limit raised past 48 KB once (`allowed`).
template <typename... P, typename... A>
cudaError_t launch_clusters(void (*kernel)(P...), size_t smem,
                            size_t& allowed, int BH, int S,
                            cudaStream_t stream, A&&... args) {
  if (smem > 48 * 1024 && smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const int nc = cluster_ctas(BH, S);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nc, (unsigned)BH, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* lengths, float* out, int B, int S, int NKV,
                      int G, float scale2, cudaStream_t stream) {
  static size_t allowed = 0;
  const size_t stages =
      ((size_t)kStages * 2 * kTile * HD + kWarps * kMaxG * 16) * sizeof(bf16);
  const size_t smem = stages > merge_bytes(HD) ? stages : merge_bytes(HD);
  return launch_clusters(decode_attn_tc<HD>, smem, allowed, B * NKV, S,
                         stream, (const bf16*)q, (const bf16*)k,
                         (const bf16*)v, lengths, out, S, NKV, G, scale2);
}

template <typename T, int CPL>
cudaError_t launch_cc(const void* q, const void* k, const void* v,
                      const int* lengths, float* out, int B, int S, int NKV,
                      int G, int HD, float scale2, cudaStream_t stream) {
  static size_t allowed = 0;
  return launch_clusters(decode_attn_cc<T, CPL>, merge_bytes(HD), allowed,
                         B * NKV, S, stream, (const T*)q, (const T*)k,
                         (const T*)v, lengths, out, S, NKV, G, HD, scale2);
}

template <typename T>
cudaError_t launch_cc_any(const void* q, const void* k, const void* v,
                          const int* lengths, float* out, int B, int S,
                          int NKV, int G, int HD, float scale2,
                          cudaStream_t stream) {
#define DG_CC(CPL)                                                         \
  return launch_cc<T, CPL>(q, k, v, lengths, out, B, S, NKV, G, HD, scale2, \
                           stream)
  if (HD <= 32) DG_CC(1);
  if (HD <= 64) DG_CC(2);
  if (HD <= 128) DG_CC(4);
  DG_CC(8);
#undef DG_CC
}

}  // namespace

// G <= 8 and HD <= 256 (checked by the Python wrapper).
extern "C" int dg_decode_attention(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   float* out, int B, int S, int NKV, int G,
                                   int HD, int is_bf16, void* stream) {
  if (B <= 0 || NKV <= 0 || G <= 0 || HD <= 0 || S <= 0) return 0;
  if (G > kMaxG || HD > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float scale2 =
      (float)(std::pow((double)HD, -0.5) * 1.4426950408889634);
  if (!is_bf16) {
    return (int)launch_cc_any<float>(q, k, v, lengths, out, B, S, NKV, G, HD,
                                     scale2, s);
  }
  switch (HD) {
    case 16:
      return (int)launch_tc<16>(q, k, v, lengths, out, B, S, NKV, G, scale2,
                                s);
    case 32:
      return (int)launch_tc<32>(q, k, v, lengths, out, B, S, NKV, G, scale2,
                                s);
    case 64:
      return (int)launch_tc<64>(q, k, v, lengths, out, B, S, NKV, G, scale2,
                                s);
    case 128:
      return (int)launch_tc<128>(q, k, v, lengths, out, B, S, NKV, G, scale2,
                                 s);
    case 256:
      return (int)launch_tc<256>(q, k, v, lengths, out, B, S, NKV, G, scale2,
                                 s);
    default:
      return (int)launch_cc_any<bf16>(q, k, v, lengths, out, B, S, NKV, G, HD,
                                      scale2, s);
  }
}
