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
// Three sources: a slot table [N, W]; (gathered mode, the staged emit)
// a request table [R, W] and the slot references refs [N] that name its
// rows (dg::gather_row, the rule of ring_gather), so the gathered [N, W]
// payload never exists in memory; or (packed mode, the TX enqueue) a
// record batch whose words dg::pack_word (serdes.cuh) assembles as the
// kept rows are written, so the packed slots never exist either.  In
// gathered mode the map first resolves which row wins each target (the
// last), and only then is that row's reference looked up, once, with a
// thread's references in flight together: the map then holds table rows
// (or a zero-row mark), and the write phase takes one dependent load a
// kept element, as with a slot table.
#include <climits>

#include "common.cuh"
#include "serdes.cuh"

#define DG_PUSH_THREADS 256
#define DG_PUSH_PER_THREAD 4   // tile elements a thread holds in flight
#define DG_PUSH_TILE (DG_PUSH_THREADS * DG_PUSH_PER_THREAD)
#define DG_PUSH_QIDS 8         // queue ids a thread has in flight a round
#define DG_PUSH_ZERO (-2)      // map mark: a zero row (a ref naming none)

namespace {

// Where a kept row's words come from: a table `rows` [*, W] — the slot
// table, indexed by the pushed row i, or (refs not null) the request
// table [R, W], indexed by the row dg::gather_row resolves refs[i] to —
// or (rows null) the record batch `pack`.  A pointer is null here only
// where the launch's tensor is empty, and then no kept row reads it.
struct RowSrc {
  const int* rows;
  const int* refs;
  int R;
  dg::PackSrc pack;
};

template <bool VEC> struct Elem;
template <> struct Elem<true> {
  using T = int4;
  static constexpr int WORDS = 4;
  static __device__ __forceinline__ T zero() { return make_int4(0, 0, 0, 0); }
};
template <> struct Elem<false> {
  using T = int;
  static constexpr int WORDS = 1;
  static __device__ __forceinline__ T zero() { return 0; }
};

// Element e (of epr a row) of source row i (a table row in gathered
// mode, once the map has resolved it).
template <bool VEC>
__device__ __forceinline__ typename Elem<VEC>::T row_elem(const RowSrc& s,
                                                          int i, int e,
                                                          int epr) {
  using T = typename Elem<VEC>::T;
  if (s.rows) {
    return reinterpret_cast<const T*>(s.rows)[(long long)i * epr + e];
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

  // gathered mode: each target's winning row i (never a loser: the
  // lookup follows the atomicMax) becomes the table row refs[i] names,
  // or DG_PUSH_ZERO; a thread's rows (nrows <= DG_PUSH_TILE) have their
  // references in flight together
  if (src.refs) {
    int ref[DG_PUSH_PER_THREAD];
#pragma unroll
    for (int k = 0; k < DG_PUSH_PER_THREAD; ++k) {
      const int r = k * DG_PUSH_THREADS + threadIdx.x;
      const int i = r < nrows ? smap[r] : -1;
      ref[k] = i >= 0 ? __ldg(src.refs + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < DG_PUSH_PER_THREAD; ++k) {
      const int r = k * DG_PUSH_THREADS + threadIdx.x;
      if (r < nrows && smap[r] >= 0) {
        const int row = dg::gather_row(ref[k], src.R);
        smap[r] = row >= 0 ? row : DG_PUSH_ZERO;
      }
    }
    __syncthreads();
  }

  // every element of the tile written once, from its source
#pragma unroll
  for (int k = 0; k < DG_PUSH_PER_THREAD; ++k) {
    const int c = k * DG_PUSH_THREADS + threadIdx.x;
    if (c < nelem) {
      const int i = smap[c / epr];
      dst[c] = i >= 0 ? row_elem<VEC>(src, i, c % epr, epr)
               : i == DG_PUSH_ZERO ? Elem<VEC>::zero() : v[k];
    }
  }
  // a row wider than the tile (epr > DG_PUSH_TILE): the rest of it
  for (int c = DG_PUSH_TILE + threadIdx.x; c < nelem; c += DG_PUSH_THREADS) {
    const int i = smap[c / epr];
    dst[c] = i >= 0 ? row_elem<VEC>(src, i, c % epr, epr)
             : i == DG_PUSH_ZERO ? Elem<VEC>::zero() : __ldg(old + c);
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
  RowSrc src{slots, nullptr, 0, {}};
  return (int)push(buf, qid, pos, src, out, Q, E, W, N, vec,
                   (cudaStream_t)stream);
}

extern "C" int dg_ring_push_gathered(const int* buf, const int* qid,
                                     const int* pos, const int* table,
                                     const int* refs, int* out, int Q, int E,
                                     int W, int N, int R, int vec,
                                     void* stream) {
  RowSrc src{table, refs, R, {}};
  return (int)push(buf, qid, pos, src, out, Q, E, W, N, vec,
                   (cudaStream_t)stream);
}

extern "C" int dg_ring_push_packed(
    const int* buf, const int* qid, const int* pos, const int* conn,
    const int* rpc, const int* fn, const int* flags, const int* plen,
    const int* frag, const int* ts, const int* payload, int* out, int Q,
    int E, int W, int N, int PW, int vec, void* stream) {
  RowSrc src{nullptr, nullptr, 0,
             {conn, rpc, fn, flags, plen, frag, ts, payload, PW}};
  return (int)push(buf, qid, pos, src, out, Q, E, W, N, vec,
                   (cudaStream_t)stream);
}
