// switch_step_fused: one fused fetch -> deliver -> emit -> drain pass over
// a [T]-tier stack (the whole per-device switch step), in place, in ONE
// launch.  Replaces the Pallas kernel repro/kernels/switch_step.py
// (switch_step_fused, with its _kernel, _fnv1a_rows and _rank_at).
//
// Bound on the card: bytes, at a few integer operations a candidate.
// The step must touch well under a megabyte (bytes_touched in
// switch_step.py: the candidate rows, the granted, emitted and drained
// rows, the per-flow cursors, FIFO entries, registers and histogram), a
// bound of a fraction of a microsecond; what the kernel waits on is the
// serial arbitration (each register of the hardware arbiter is a prefix
// count in candidate order) and the barriers between the phases.  The
// design keeps that chain short:
//
//   * one launch, no copies: the rx ring, request table, free FIFO,
//     flow FIFOs, flow cursors, histogram and register row are updated
//     in place (the reference's donated state); tx_head, the candidate
//     list of the fetch route, the drained tile and the monitor row are
//     fresh outputs written in full.
//   * one thread-block cluster per destination tier (T clusters of NC
//     CTAs of 256 threads, NC <= 8 chosen by the host from the work; the
//     small KVS and LM tiers get NC = 1).  Candidate i is thread i of the
//     cluster, so phase B needs no chunk loop up to 8 x 256 candidates.
//     The candidate-order counts (grant rank, RR rank, leak rank) are
//     CTA scans plus the totals of the lower-ranked CTAs, and the ordered
//     per-flow push rank is the CTA's rank plus the lower CTAs' per-flow
//     counts, all read from distributed shared memory; cluster.sync()
//     separates the dependent rounds.  The results are the serial
//     arbiter's, bit for bit (dg::arbitrate_chunk in arbiter.cuh, which
//     nic_deliver.cu shares).
//   * phases C and D split the flows across the cluster's CTAs after one
//     cluster-wide prefix of the emit take over flows.
//   * the histogram add is one atomic per warp and bin (__match_any_sync
//     groups the lanes of a bin); the totals are reduced per warp, per
//     CTA and then by rank 0 over the cluster.
//   * row moves are int4 (four lanes per 64-byte row in phases C and D)
//     when the row width and the pointers allow it.
//
// In-place hazards, each ordered by a barrier:
//   * every grant read of the free FIFO (all candidates, all chunks)
//     precedes every leak write: a full free FIFO (avail == R) maps the
//     first grant and the first leak onto one entry.  Leaks go through a
//     scratch list and are written after the last chunk's cluster.sync();
//     the releases of phase C follow them after another.
//   * phase B reads ff_head / ff_tail of any flow; the owning CTA rewrites
//     them only after the last chunk's cluster.sync().  Phases C and D
//     read a flow's cursors from shared copies taken before the rewrite.
//   * phase C reads request rows and flow-FIFO entries written by any CTA
//     in phase B (after a cluster.sync()); phase D reads the rx ring rows
//     its own CTA wrote in phase C (after __syncthreads()).
//   * the register row is read by every CTA at the start and written by
//     rank 0 at the end, after the last cluster.sync() that follows all
//     reads; only the columns the step changes are written (the fetch of
//     another tier's cluster reads this tier's S_BATCH).
//   * clusters share nothing they write: the fetch reads tx_head and the
//     source tier's registers and tables, none of which is written in
//     place.
#include <cooperative_groups.h>

#include "arbiter.cuh"

namespace cg = cooperative_groups;

namespace {

enum { LB_RR = 0, LB_STATIC = 1, LB_OBJECT = 2 };
enum {
  S_FREE_HEAD = 0, S_FREE_TAIL, S_RR, S_BATCH, S_ACTIVE, S_FLUSH, S_TSTEP,
  S_TNDONE, S_TSUM, SCAL_COLS
};
enum {
  M_INGESTED = 0, M_DELIVERED, M_EMITTED, M_COMPLETED, M_NO_SLOT,
  M_FIFO_FULL, M_BATCHES, MON_COLS
};
// values each CTA publishes in shared memory for the cluster (the first
// dg::ARB_WORDS are the arbiter's)
enum {
  P_TAKE = dg::ARB_WORDS, R_GR, R_DNS, R_DELIV, R_BATCH, R_ING,
  R_COMPL, R_DONE, R_SUM, N_PUB
};
constexpr int HEADER_WORDS = 5;
constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;

struct Dims {
  int T, F, E, E_rx, W, R, D, C, NB, M, bmax, key_words, fetch, vec;
};

struct Args {
  const int* tx_buf;
  const int* tx_head;
  const int* tx_tail;
  int* rx_buf;
  int* rx_head;
  int* rx_tail;
  int* req;
  int* fifo;
  int* ffbuf;
  int* ff_head;
  int* ff_tail;
  const int* tag;
  const int* srcf;
  const int* dest;
  const int* lb;
  int* scal;
  int* hist;
  const int* ext_slots;
  const int* ext_valid;
  const int* ext_dest;
  int* txh_out;
  int* cand_slots;
  int* cand_valid;
  int* cand_dest;
  int* drained;
  int* dvalid;
  int* mon;
  int* lk_sid;  // [T, M] scratch: the slot a leaked candidate returns
  int* lk_pos;  // [T, M] scratch: its free-FIFO index, or -1
  Dims d;
};

__device__ __forceinline__ int clip_batch(int b, int bmax) {
  return b < 1 ? 1 : (b > bmax ? bmax : b);
}

// Copy a whole W-word row (int4 when vec).
__device__ __forceinline__ void copy_row(int* dst, const int* src, int W,
                                         bool vec) {
  if (vec) {
    for (int q = 0; q < W / 4; ++q)
      reinterpret_cast<int4*>(dst)[q] = reinterpret_cast<const int4*>(src)[q];
  } else {
    for (int w = 0; w < W; ++w) dst[w] = src[w];
  }
}

// Copy part q of LQ parts of a W-word row (LQ = W / 4 when vec, else 1).
__device__ __forceinline__ void copy_part(int* dst, const int* src, int q,
                                          int W, bool vec) {
  if (vec) {
    reinterpret_cast<int4*>(dst)[q] = reinterpret_cast<const int4*>(src)[q];
  } else {
    for (int w = 0; w < W; ++w) dst[w] = src[w];
  }
}

// Sum of x over the CTA, added into acc (shared) by one lane per warp.
__device__ __forceinline__ void cta_add(int* acc, int x) {
  x = __reduce_add_sync(DG_FULL_MASK, x);
  if ((threadIdx.x & 31) == 0 && x != 0) atomicAdd(acc, x);
}

__global__ void __launch_bounds__(kThreads) switch_step_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const Dims d = a.d;
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / nc;
  const int tid = threadIdx.x;
  const int F = d.F;
  const int R = d.R;
  const long long tF = (long long)t * F;

  extern __shared__ int sh[];
  int* cnt = sh;        // [F] this CTA's granted rows per flow, this chunk
  int* gcar = sh + F;   // [F] granted rows per flow so far (whole cluster)
  const int fc = (F + nc - 1) / nc;  // flows per CTA in phases C and D
  const int f0 = min(rank * fc, F);
  const int nf = min(F, f0 + fc) - f0;
  int* take_s = sh + 2 * F;  // [fc] per own flow
  int* rel_s = take_s + fc;
  int* fh_s = rel_s + fc;
  int* rh_s = fh_s + fc;
  int* rt_s = rh_s + fc;
  __shared__ int pub[N_PUB];

  const int* sc = a.scal + t * SCAL_COLS;
  const int free_head = sc[S_FREE_HEAD];
  const int free_tail = sc[S_FREE_TAIL];
  const int rr0 = sc[S_RR];
  const int batch = clip_batch(sc[S_BATCH], d.bmax);
  const int active = sc[S_ACTIVE];
  const bool flush = sc[S_FLUSH] != 0;
  const int tstep = sc[S_TSTEP];
  const int tndone = sc[S_TNDONE];
  const int tsum = sc[S_TSUM];
  const int avail = free_tail - free_head;

  for (int f = tid; f < F; f += kThreads) gcar[f] = 0;
  if (tid < N_PUB) pub[tid] = 0;
  int my_gr = 0, my_dns = 0;
  dg::ArbCarry car{0, 0, 0};
  const int chunk = nc * kThreads;

  // ---- phase B: deliver (allocate + steer + flow-FIFO scatter) ----------
  for (int c0 = 0; c0 < d.M; c0 += chunk) {
    const int i = c0 + rank * kThreads + tid;
    const bool in = i < d.M;
    const int* row;
    int cv = 0, cd = -1;
    if (d.fetch) {
      // phase A for candidate i = (ts * F + f) * bmax + j (any source tier
      // ts; this cluster writes the outputs of its own tier's candidates)
      const int ii = in ? i : 0;
      const int j = ii % d.bmax;
      const int tf = ii / d.bmax;
      const int ts = tf / F;
      const int bs = clip_batch(a.scal[ts * SCAL_COLS + S_BATCH], d.bmax);
      const int h = a.tx_head[tf];
      const int occ = a.tx_tail[tf] - h;
      const int take = occ < bs ? occ : bs;
      row = a.tx_buf +
            ((long long)tf * d.E + dg::fmod_i(h + j, d.E)) * d.W;
      const int cid = row[0];
      const int ci = dg::fmod_i(cid, d.C);
      const bool hit = a.tag[(long long)ts * d.C + ci] == cid;
      cv = (j < take && hit) ? 1 : 0;
      cd = a.dest[(long long)ts * d.C + ci];
      if (in && ts == t) {
        copy_row(a.cand_slots + (long long)i * d.W, row, d.W, d.vec);
        a.cand_valid[i] = cv;
        a.cand_dest[i] = cd;
      }
    } else {
      row = a.ext_slots + (long long)(in ? i : 0) * d.W;
      if (in) {
        cv = a.ext_valid[i];
        cd = a.ext_dest[i];
      }
    }
    const bool mine = in && cv != 0 && cd == t;

    // connection lookup on this (destination) tier + steering inputs
    const int cid = row[0];
    const int ci = dg::fmod_i(cid, d.C);
    const bool hit = a.tag[(long long)t * d.C + ci] == cid;
    const int srcf = a.srcf[(long long)t * d.C + ci];
    const int lbv = a.lb[(long long)t * d.C + ci];
    const bool is_resp = ((((unsigned)row[2]) >> 16) & 0x1u) != 0u;
    const bool is_rr = mine && lbv == LB_RR;

    // the arbiter's rounds (arbiter.cuh); space from the pre-push
    // cursors, leaks through the scratch list (written once every grant
    // of every chunk has been read)
    int sid = R;
    bool granted = false;
    dg::arbitrate_chunk(
        cluster, pub, cnt, gcar, F, car, mine, is_rr,
        [&](int vrank, int rrrank, int* key) {
          granted = mine && vrank < avail;
          if (granted)
            sid = a.fifo[(long long)t * R + dg::fmod_i(free_head + vrank, R)];
          const int sw = sid < 0 ? sid + R : sid;
          if (granted && sw >= 0 && sw < R) {
            copy_row(a.req + ((long long)t * R + sw) * d.W, row, d.W, d.vec);
          }
          int flow = 0;
          if (mine) {
            if (lbv == LB_STATIC) {
              flow = dg::fmod_i(srcf, active);
            } else if (lbv == LB_OBJECT) {
              flow = (int)(dg::fnv1a(row + HEADER_WORDS, d.key_words) %
                           (uint32_t)active);
            } else {
              flow = dg::fmod_i(rr0 + rrrank, active);
            }
            if (is_resp && hit) flow = dg::fmod_i(srcf, active);
            // flow < F whenever active <= F (the caller's contract); the
            // clamp only keeps a broken contract inside the arrays
            flow = flow < F ? flow : F - 1;
          }
          *key = flow;
          return granted;
        },
        [&](int flow, int frank) {
          const int ft = a.ff_tail[tF + flow];
          const int space = d.D - (ft - a.ff_head[tF + flow]);
          const bool accepted = frank < space;
          if (accepted) {
            a.ffbuf[(tF + flow) * d.D + dg::fmod_i(ft + frank, d.D)] = sid;
          }
          return accepted;
        },
        [&](bool leaked, int lrank) {
          if (in) {
            const long long li = (long long)t * d.M + i;
            a.lk_sid[li] = sid;
            a.lk_pos[li] = leaked ? dg::fmod_i(free_tail + lrank, R) : -1;
          }
        });
    my_gr += granted ? 1 : 0;
    my_dns += (mine && !granted) ? 1 : 0;
  }

  // leak write-back, after every grant read of the cluster
  for (int c0 = 0; c0 < d.M; c0 += chunk) {
    const int i = c0 + rank * kThreads + tid;
    if (i < d.M) {
      const long long li = (long long)t * d.M + i;
      const int pos = a.lk_pos[li];
      if (pos >= 0) a.fifo[(long long)t * R + pos] = a.lk_sid[li];
    }
  }

  // ---- phase C: emit (flow scheduler + CCI-P transmit + slot release) ---
  // own flows: cursors into shared memory, then rewritten in place (every
  // other reader of them finished phase B before the last cluster.sync)
  int my_deliv = 0, my_batch = 0, my_ing = 0;
  for (int lf = tid; lf < nf; lf += kThreads) {
    const long long g = tF + f0 + lf;
    const int fh = a.ff_head[g];
    const int ft = a.ff_tail[g];
    const int rh = a.rx_head[g];
    const int rt = a.rx_tail[g];
    const int space = d.D - (ft - fh);
    const int gr = gcar[f0 + lf];
    const int acc = space <= 0 ? 0 : (gr < space ? gr : space);
    const int counts = ft + acc - fh;
    const bool ready = counts >= batch || flush;
    int take = ready ? (counts < batch ? counts : batch) : 0;
    const int space_rx = d.E_rx - (rt - rh);
    take = space_rx >= take ? take : 0;
    take_s[lf] = take;
    fh_s[lf] = fh;
    rh_s[lf] = rh;
    rt_s[lf] = rt;
    a.ff_tail[g] = ft + acc;
    a.ff_head[g] = fh + take;
    a.rx_tail[g] = rt + take;
    my_deliv += acc;
    my_batch += take > 0 ? 1 : 0;
    if (d.fetch) {
      const int h = a.tx_head[g];
      const int occ = a.tx_tail[g] - h;
      const int ta = occ < batch ? occ : batch;
      a.txh_out[g] = h + ta;
      my_ing += ta;
    }
  }
  __syncthreads();
  // exclusive prefix of take over the own flows, then over the cluster
  int run = 0;
  for (int c0 = 0; c0 < nf; c0 += kThreads) {
    const int lf = c0 + tid;
    const int x = lf < nf ? take_s[lf] : 0;
    int tot;
    const int ex = dg::block_excl_scan(x, &tot);
    if (lf < nf) rel_s[lf] = run + ex;
    run += tot;
  }
  if (tid == 0) pub[P_TAKE] = run;
  cluster.sync();  // also orders the leak writes before the releases
  int off_take = 0;
  for (int q = 0; q < rank; ++q)
    off_take += cluster.map_shared_rank(pub, q)[P_TAKE];
  const int ft_mid = free_tail + car.lk;
  const int lq = d.vec ? d.W / 4 : 1;  // lanes per row
  const int n_rows = nf * d.bmax;
  for (int u = tid; u < n_rows * lq; u += kThreads) {
    const int k = u / lq;
    const int q = u % lq;
    const int lf = k / d.bmax;
    const int j = k % d.bmax;
    if (j >= take_s[lf]) continue;
    const long long g = tF + f0 + lf;
    const int sid_c = a.ffbuf[g * d.D + dg::fmod_i(fh_s[lf] + j, d.D)];
    // JAX's gather: negative indices count from the end, then clamp
    int sidx = sid_c < 0 ? sid_c + R : sid_c;
    sidx = sidx < 0 ? 0 : (sidx >= R ? R - 1 : sidx);
    const int* src = a.req + ((long long)t * R + sidx) * d.W;
    int* dst = a.rx_buf + (g * d.E_rx + dg::fmod_i(rt_s[lf] + j, d.E_rx)) * d.W;
    copy_part(dst, src, q, d.W, d.vec);
    if (q == 0) {
      a.fifo[(long long)t * R +
             dg::fmod_i(ft_mid + off_take + rel_s[lf] + j, R)] = sid_c;
    }
  }
  __syncthreads();

  // ---- phase D: completion drain + latency telemetry --------------------
  int my_compl = 0, my_done = 0;
  unsigned my_sum = 0u;
  for (int c0 = 0; c0 < n_rows * lq; c0 += kThreads) {
    const int u = c0 + tid;  // every lane of a warp takes each turn
    bool count = false;
    int bin = 0;
    if (u < n_rows * lq) {
      const int k = u / lq;
      const int q = u % lq;
      const int lf = k / d.bmax;
      const int j = k % d.bmax;
      const long long g = tF + f0 + lf;
      const int rh = rh_s[lf];
      const int occ = rt_s[lf] + take_s[lf] - rh;
      const int* src =
          a.rx_buf + (g * d.E_rx + dg::fmod_i(rh + j, d.E_rx)) * d.W;
      copy_part(a.drained + (g * d.bmax + j) * d.W, src, q, d.W, d.vec);
      if (q == 0) {
        const bool dv = j < occ;
        a.dvalid[g * d.bmax + j] = dv ? 1 : 0;
        const bool resp = ((((unsigned)src[2]) >> 16) & 0x1u) != 0u;
        if (dv && resp) {
          int lat = (int)((unsigned)tstep - (unsigned)src[4] + 1u);
          lat = lat < 0 ? 0 : lat;
          bin = lat < d.NB - 1 ? lat : d.NB - 1;
          count = true;
          my_done += 1;
          my_sum += (unsigned)lat;
        }
        if (j == 0) {
          const int n_take = occ < d.bmax ? occ : d.bmax;
          a.rx_head[g] = rh + n_take;
          my_compl += n_take;
        }
      }
    }
    // one atomic per warp and bin
    const unsigned peers = __match_any_sync(DG_FULL_MASK, count ? bin : -1);
    if (count && (__ffs(peers) - 1) == (tid & 31)) {
      atomicAdd(&a.hist[(long long)t * d.NB + bin], __popc(peers));
    }
  }

  // ---- register write-back ----------------------------------------------
  cta_add(&pub[R_GR], my_gr);
  cta_add(&pub[R_DNS], my_dns);
  cta_add(&pub[R_DELIV], my_deliv);
  cta_add(&pub[R_BATCH], my_batch);
  cta_add(&pub[R_ING], my_ing);
  cta_add(&pub[R_COMPL], my_compl);
  cta_add(&pub[R_DONE], my_done);
  cta_add(&pub[R_SUM], (int)my_sum);
  cluster.sync();
  if (rank == 0 && tid == 0) {
    int tot[N_PUB];
#pragma unroll
    for (int k = 0; k < N_PUB; ++k) tot[k] = 0;
    for (int q = 0; q < nc; ++q) {
      const int* p = cluster.map_shared_rank(pub, q);
#pragma unroll
      for (int k = P_TAKE; k < N_PUB; ++k) tot[k] += p[k];
    }
    int* so = a.scal + t * SCAL_COLS;
    so[S_FREE_HEAD] = free_head + tot[R_GR];
    so[S_FREE_TAIL] = ft_mid + tot[P_TAKE];
    so[S_RR] = dg::fmod_i(rr0 + car.rr, active);
    so[S_TSTEP] = tstep + 1;
    so[S_TNDONE] = tndone + tot[R_DONE];
    so[S_TSUM] = (int)((unsigned)tsum + (unsigned)tot[R_SUM]);
    int* mo = a.mon + t * MON_COLS;
    mo[M_INGESTED] = tot[R_ING];
    mo[M_DELIVERED] = tot[R_DELIV];
    mo[M_EMITTED] = tot[P_TAKE];
    mo[M_COMPLETED] = tot[R_COMPL];
    mo[M_NO_SLOT] = tot[R_DNS];
    mo[M_FIFO_FULL] = car.lk;
    mo[M_BATCHES] = tot[R_BATCH];
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
}

}  // namespace

// Cluster size for one tier: enough CTAs that each candidate, and each
// (flow, lane) row of phases C and D, has a thread, at most 8.
static int cluster_ctas(int F, int M, int bmax) {
  const int work = M > F * bmax ? M : F * bmax;
  int nc = (work + kThreads - 1) / kThreads;
  nc = nc < 1 ? 1 : (nc > kMaxCluster ? kMaxCluster : nc);
  return nc;
}

extern "C" int dg_switch_step(
    const int* tx_buf, const int* tx_head, const int* tx_tail, int* rx_buf,
    int* rx_head, int* rx_tail, int* req, int* fifo, int* ffbuf,
    int* ff_head, int* ff_tail, const int* tag, const int* srcf,
    const int* dest, const int* lb, int* scal, int* hist,
    const int* ext_slots, const int* ext_valid, const int* ext_dest,
    int* txh_out, int* cand_slots, int* cand_valid, int* cand_dest,
    int* drained, int* dvalid, int* mon, int* scratch, int T, int F, int E,
    int E_rx, int W, int R, int D, int C, int NB, int M, int bmax,
    int include_fetch, int key_words, int vec, void* stream) {
  if (T <= 0 || F <= 0) return 0;
  const int nc = cluster_ctas(F, M, bmax);
  const int fc = (F + nc - 1) / nc;
  const size_t smem = sizeof(int) * ((size_t)2 * F + (size_t)5 * fc);
  Args a{tx_buf,    tx_head,    tx_tail,   rx_buf,    rx_head,  rx_tail,
         req,       fifo,       ffbuf,     ff_head,   ff_tail,  tag,
         srcf,      dest,       lb,        scal,      hist,     ext_slots,
         ext_valid, ext_dest,   txh_out,   cand_slots, cand_valid,
         cand_dest, drained,    dvalid,    mon,       scratch,
         scratch + (long long)T * (M > 0 ? M : 0),
         Dims{T, F, E, E_rx, W, R, D, C, NB, M, bmax, key_words,
              include_fetch, vec}};
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        switch_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(T * nc), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, switch_step_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
