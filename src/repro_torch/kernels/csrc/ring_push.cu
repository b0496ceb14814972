// ring_push: scatter N rows into per-queue rings (the CCI-P receive
// engine).  Replaces the Pallas kernel repro/kernels/ring_push.py
// (ring_push).  Out of place: out[Q, E, W] is the ring buf with row i
// written at (q[i], pos[i]).  Rows whose queue id is out of [0, Q) (the
// drop sentinel Q) or whose position is out of [0, E) write nothing
// (indices in [-n, 0) count from the end first, as JAX's scatter does).
// Targets of kept rows are unique by construction (per-queue rank
// arbitration); were two kept rows to share one, the later row wins.
//
// Bound: bytes, the ring read and written once.  One launch, a "pull"
// over ring tiles, so each ring element is read once and written once:
// a block owns a tile of about 1,024 elements (16 KiB on the vector
// path), starts loading its old contents, meanwhile reads all N queue
// ids (8 a thread in flight) and, for the rows that land in its queues,
// their positions, into a shared map tile row -> source row (-1: keep
// the old row), and then writes each element of the tile once, from its
// source.  (Loading every position with its queue id, one round trip
// fewer, measured slower: each block then reads 8 bytes a row.)  The vector path moves 16
// bytes a thread (W % 4 == 0 and 16-byte aligned tables); the scalar
// path one word.
//
// Two sources: a slot table [N, W], or (packed mode, the TX enqueue) a
// record batch whose words dg::pack_word (serdes.cuh) assembles as the
// kept rows are written, so the packed slots never exist in memory.
#include <climits>

#include "common.cuh"
#include "serdes.cuh"

#define DG_PUSH_THREADS 256
#define DG_PUSH_PER_THREAD 4   // tile elements a thread holds in flight
#define DG_PUSH_TILE (DG_PUSH_THREADS * DG_PUSH_PER_THREAD)
#define DG_PUSH_QIDS 8         // queue ids a thread has in flight a round

namespace {

// Where a kept row's words come from: a slot table [N, W], or (slots
// null) the record batch `pack`.
struct RowSrc {
  const int* slots;
  dg::PackSrc pack;
};

template <bool VEC> struct Elem;
template <> struct Elem<true> {
  using T = int4;
  static constexpr int WORDS = 4;
};
template <> struct Elem<false> {
  using T = int;
  static constexpr int WORDS = 1;
};

// Element e (of epr a row) of source row i.
template <bool VEC>
__device__ __forceinline__ typename Elem<VEC>::T row_elem(const RowSrc& s,
                                                          int i, int e,
                                                          int epr) {
  using T = typename Elem<VEC>::T;
  if (s.slots) {
    return reinterpret_cast<const T*>(s.slots)[(long long)i * epr + e];
  }
  if constexpr (VEC) {
    const int w = 4 * e;
    return make_int4((int)dg::pack_word(s.pack, i, w),
                     (int)dg::pack_word(s.pack, i, w + 1),
                     (int)dg::pack_word(s.pack, i, w + 2),
                     (int)dg::pack_word(s.pack, i, w + 3));
  } else {
    return (int)dg::pack_word(s.pack, i, e);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(DG_PUSH_THREADS)
ring_push_pull(const int* __restrict__ buf, const int* __restrict__ qid,
               const int* __restrict__ pos, RowSrc src,
               int* __restrict__ out, int Q, int E, int W, int N,
               int tile_rows) {
  using T = typename Elem<VEC>::T;
  __shared__ int smap[DG_PUSH_TILE];   // tile row -> source row, or -1
  const int epr = W / Elem<VEC>::WORDS;
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const int nrows = (int)min((long long)tile_rows, (long long)Q * E - r0);
  const int nelem = nrows * epr;
  const T* old = reinterpret_cast<const T*>(buf) + r0 * epr;
  T* dst = reinterpret_cast<T*>(out) + r0 * epr;

  // the tile's old contents, in flight while the indices are read
  T v[DG_PUSH_PER_THREAD];
#pragma unroll
  for (int k = 0; k < DG_PUSH_PER_THREAD; ++k) {
    const int c = k * DG_PUSH_THREADS + threadIdx.x;
    if (c < nelem) v[k] = __ldg(old + c);
  }
  for (int r = threadIdx.x; r < nrows; r += DG_PUSH_THREADS) smap[r] = -1;
  __syncthreads();

  // the rows that land in this tile's queues [q_lo, q_hi]
  const int q_lo = (int)(r0 / E);
  const int q_hi = (int)((r0 + nrows - 1) / E);
  for (int base = 0; base < N; base += DG_PUSH_THREADS * DG_PUSH_QIDS) {
    int q[DG_PUSH_QIDS];
#pragma unroll
    for (int k = 0; k < DG_PUSH_QIDS; ++k) {
      const int i = base + k * DG_PUSH_THREADS + threadIdx.x;
      q[k] = i < N ? __ldg(qid + i) : INT_MIN;   // INT_MIN + Q < 0: no row
    }
#pragma unroll
    for (int k = 0; k < DG_PUSH_QIDS; ++k) {
      const int i = base + k * DG_PUSH_THREADS + threadIdx.x;
      int qk = q[k];
      if (qk < 0) qk += Q;   // negative indices count from the end
      if (qk < q_lo || qk > q_hi) continue;
      int p = __ldg(pos + i);
      if (p < 0) p += E;
      if (p < 0 || p >= E) continue;
      const long long r = (long long)qk * E + p - r0;
      if (r >= 0 && r < nrows) atomicMax(&smap[r], i);
    }
  }
  __syncthreads();

  // every element of the tile written once, from its source
#pragma unroll
  for (int k = 0; k < DG_PUSH_PER_THREAD; ++k) {
    const int c = k * DG_PUSH_THREADS + threadIdx.x;
    if (c < nelem) {
      const int i = smap[c / epr];
      dst[c] = i >= 0 ? row_elem<VEC>(src, i, c % epr, epr) : v[k];
    }
  }
  // a row wider than the tile (epr > DG_PUSH_TILE): the rest of it
  for (int c = DG_PUSH_TILE + threadIdx.x; c < nelem; c += DG_PUSH_THREADS) {
    const int i = smap[c / epr];
    dst[c] = i >= 0 ? row_elem<VEC>(src, i, c % epr, epr) : __ldg(old + c);
  }
}

template <bool VEC>
cudaError_t launch(const int* buf, const int* qid, const int* pos,
                   RowSrc src, int* out, int Q, int E, int W, int N,
                   cudaStream_t s) {
  const long long rows = (long long)Q * E;
  if (rows <= 0 || W <= 0) return cudaSuccess;
  const int epr = W / Elem<VEC>::WORDS;
  const int tile_rows = epr < DG_PUSH_TILE ? DG_PUSH_TILE / epr : 1;
  const long long blocks = (rows + tile_rows - 1) / tile_rows;
  ring_push_pull<VEC><<<(unsigned)blocks, DG_PUSH_THREADS, 0, s>>>(
      buf, qid, pos, src, out, Q, E, W, N, tile_rows);
  return cudaGetLastError();
}

cudaError_t push(const int* buf, const int* qid, const int* pos, RowSrc src,
                 int* out, int Q, int E, int W, int N, int vec,
                 cudaStream_t s) {
  return vec ? launch<true>(buf, qid, pos, src, out, Q, E, W, N, s)
             : launch<false>(buf, qid, pos, src, out, Q, E, W, N, s);
}

}  // namespace

extern "C" int dg_ring_push(const int* buf, const int* qid, const int* pos,
                            const int* slots, int* out, int Q, int E, int W,
                            int N, int vec, void* stream) {
  RowSrc src{slots, {}};
  return (int)push(buf, qid, pos, src, out, Q, E, W, N, vec,
                   (cudaStream_t)stream);
}

extern "C" int dg_ring_push_packed(
    const int* buf, const int* qid, const int* pos, const int* conn,
    const int* rpc, const int* fn, const int* flags, const int* plen,
    const int* frag, const int* ts, const int* payload, int* out, int Q,
    int E, int W, int N, int PW, int vec, void* stream) {
  RowSrc src{nullptr, {conn, rpc, fn, flags, plen, frag, ts, payload, PW}};
  return (int)push(buf, qid, pos, src, out, Q, E, W, N, vec,
                   (cudaStream_t)stream);
}
