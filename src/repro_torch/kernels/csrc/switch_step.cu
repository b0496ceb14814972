// switch_step_fused: one fused fetch -> deliver -> emit -> drain pass over
// a [T]-tier stack (the whole per-device switch step).  Replaces the
// Pallas kernel repro/kernels/switch_step.py (switch_step_fused, with its
// _kernel, _fnv1a_rows and _rank_at).
//
// Launches, in order on the caller's stream:
//   copies   the outputs that are scattered into start as their inputs
//            (rx ring, request table, free FIFO, flow FIFOs, histogram);
//   fetch    (include_fetch) one thread per candidate (tier, flow, lane):
//            phase A, the CCI-P batched fetch + read-port-1 dest lookup;
//            without it the ext candidate list is copied through;
//   step     one block per destination tier: phases B-D back to back,
//            separated by __syncthreads().
// Phase B walks the global candidate list in chunks of 1024 rows; each
// serial arbitration register of the hardware (grant rank, RR position,
// flow-FIFO push rank, leak rank) is an exclusive prefix count in the
// candidate order, so the result is the serial arbiter's, bit for bit.
// The histogram add uses atomicAdd on int32, which is order-independent.
#include "common.cuh"

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
constexpr int HEADER_WORDS = 5;

struct Dims {
  int T, F, E, E_rx, W, R, D, C, NB, M, bmax, key_words;
};

__device__ __forceinline__ int clip_batch(int b, int bmax) {
  return b < 1 ? 1 : (b > bmax ? bmax : b);
}

// Phase A: one thread per candidate m = (t * F + f) * bmax + j.
__global__ void fetch_kernel(const int* __restrict__ tx_buf,
                             const int* __restrict__ tx_head,
                             const int* __restrict__ tx_tail,
                             const int* __restrict__ tag,
                             const int* __restrict__ dest,
                             const int* __restrict__ scal,
                             int* __restrict__ txh_out,
                             int* __restrict__ cand_slots,
                             int* __restrict__ cand_valid,
                             int* __restrict__ cand_dest,
                             int* __restrict__ mon_out, Dims d) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= d.M) return;
  const int j = m % d.bmax;
  const int tf = m / d.bmax;
  const int t = tf / d.F;
  const int batch = clip_batch(scal[t * SCAL_COLS + S_BATCH], d.bmax);
  const int h = tx_head[tf];
  const int occ = tx_tail[tf] - h;
  const int take = occ < batch ? occ : batch;
  const int idx = dg::fmod_i(h + j, d.E);
  const int* row = tx_buf + ((long long)tf * d.E + idx) * d.W;
  for (int w = 0; w < d.W; ++w) cand_slots[(long long)m * d.W + w] = row[w];
  const int cid = row[0];
  const int ci = dg::fmod_i(cid, d.C);
  const bool hit = tag[(long long)t * d.C + ci] == cid;
  cand_valid[m] = (j < take && hit) ? 1 : 0;
  cand_dest[m] = dest[(long long)t * d.C + ci];
  if (j == 0) {
    txh_out[tf] = h + take;
    atomicAdd(&mon_out[t * MON_COLS + M_INGESTED], take);
  }
}

// Phases B-D for tier t = blockIdx.x.
__global__ void step_kernel(
    const int* __restrict__ rx_head, const int* __restrict__ rx_tail,
    const int* __restrict__ fifo, const int* __restrict__ ff_head,
    const int* __restrict__ ff_tail, const int* __restrict__ tag,
    const int* __restrict__ srcf_t, const int* __restrict__ lb_t,
    const int* __restrict__ scal, const int* __restrict__ cand_slots,
    const int* __restrict__ cand_valid, const int* __restrict__ cand_dest,
    int* __restrict__ rxbuf_out, int* __restrict__ rxh_out,
    int* __restrict__ rxt_out, int* __restrict__ req_out,
    int* __restrict__ fifo_out, int* __restrict__ ffbuf_out,
    int* __restrict__ ffh_out, int* __restrict__ fft_out,
    int* __restrict__ scal_out, int* __restrict__ hist_out,
    int* __restrict__ drained, int* __restrict__ dvalid,
    int* __restrict__ mon_out, Dims d) {
  extern __shared__ int sh[];
  const int F = d.F;
  int* g_cnt = sh;            // [F] granted rows so far, per flow
  int* a_cnt = sh + F;        // [F] accepted rows, per flow
  int* take_s = sh + 2 * F;   // [F] emit take, per flow
  int* rel_s = sh + 3 * F;    // [F] exclusive prefix of take over flows
  __shared__ int base_v, base_rr, base_lk, n_gr, n_dns, n_rel, n_batch;
  __shared__ int n_done, n_compl;
  __shared__ unsigned s_sum;

  const int t = blockIdx.x;
  const int* sc = scal + t * SCAL_COLS;
  const int free_head = sc[S_FREE_HEAD];
  const int free_tail = sc[S_FREE_TAIL];
  const int rr0 = sc[S_RR];
  const int batch = clip_batch(sc[S_BATCH], d.bmax);
  const int active = sc[S_ACTIVE];
  const bool flush = sc[S_FLUSH] != 0;
  const int tstep = sc[S_TSTEP];
  const int avail = free_tail - free_head;
  const long long tF = (long long)t * F;

  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    g_cnt[f] = 0;
    a_cnt[f] = 0;
  }
  if (threadIdx.x == 0) {
    base_v = base_rr = base_lk = n_gr = n_dns = n_rel = n_batch = 0;
    n_done = n_compl = 0;
    s_sum = 0u;
  }
  __syncthreads();

  // ---- phase B: deliver (allocate + steer + flow-FIFO scatter) ----------
  for (int chunk = 0; chunk < d.M; chunk += blockDim.x) {
    const int i = chunk + threadIdx.x;
    const bool in = i < d.M;
    const int* row = cand_slots + (long long)(in ? i : 0) * d.W;
    const int dr = in ? cand_dest[i] : -1;
    const bool mine = in && cand_valid[i] != 0 && dr == t;

    int tot_v;
    const int vrank = base_v + dg::block_excl_scan(mine ? 1 : 0, &tot_v);
    const bool granted = mine && vrank < avail;
    const int sid =
        granted ? fifo[(long long)t * d.R + dg::fmod_i(free_head + vrank, d.R)]
                : d.R;
    const int sw = sid < 0 ? sid + d.R : sid;
    if (granted && sw >= 0 && sw < d.R) {
      int* dst = req_out + ((long long)t * d.R + sw) * d.W;
      for (int w = 0; w < d.W; ++w) dst[w] = row[w];
    }

    // connection lookup on this (destination) tier + steering
    const int cid = row[0];
    const int ci = dg::fmod_i(cid, d.C);
    const bool hit = tag[(long long)t * d.C + ci] == cid;
    const int srcf = srcf_t[(long long)t * d.C + ci];
    const int lbv = lb_t[(long long)t * d.C + ci];
    const bool is_resp = ((((unsigned)row[2]) >> 16) & 0x1u) != 0u;
    const bool is_rr = mine && lbv == LB_RR;
    int tot_rr;
    const int rrrank = base_rr + dg::block_excl_scan(is_rr ? 1 : 0, &tot_rr);
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
      // flow < F whenever active <= F (the caller's contract); the clamp
      // only keeps a broken contract inside the arrays
      flow = flow < F ? flow : F - 1;
    }

    // flow-FIFO push arbitration (space from the pre-push cursors)
    const int frank = dg::ordered_group_rank(granted, flow, g_cnt);
    bool accepted = false;
    if (granted) {
      const int ft = ff_tail[tF + flow];
      const int space = d.D - (ft - ff_head[tF + flow]);
      accepted = frank < space;
      if (accepted) {
        const int pos = dg::fmod_i(ft + frank, d.D);
        ffbuf_out[(tF + flow) * d.D + pos] = sid;
        atomicAdd(&a_cnt[flow], 1);
      }
    }

    // flow FIFO full: leak the granted slot back to the free FIFO
    const bool leaked = granted && !accepted;
    int tot_lk;
    const int lrank = base_lk + dg::block_excl_scan(leaked ? 1 : 0, &tot_lk);
    if (leaked) {
      fifo_out[(long long)t * d.R + dg::fmod_i(free_tail + lrank, d.R)] = sid;
    }
    if (granted) atomicAdd(&n_gr, 1);
    if (mine && !granted) atomicAdd(&n_dns, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      base_v += tot_v;
      base_rr += tot_rr;
      base_lk += tot_lk;
    }
    __syncthreads();
  }

  // flow-FIFO tails after the pushes; free tail after the leak-backs
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    fft_out[tF + f] = ff_tail[tF + f] + a_cnt[f];
  }
  const int ft_mid = free_tail + base_lk;
  __syncthreads();

  // ---- phase C: emit (flow scheduler + CCI-P transmit + slot release) ---
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const int counts = fft_out[tF + f] - ff_head[tF + f];
    const bool ready = counts >= batch || flush;
    int take = ready ? (counts < batch ? counts : batch) : 0;
    const int space_rx = d.E_rx - (rx_tail[tF + f] - rx_head[tF + f]);
    take = space_rx >= take ? take : 0;
    take_s[f] = take;
  }
  __syncthreads();
  for (int chunk = 0; chunk < F; chunk += blockDim.x) {
    const int f = chunk + threadIdx.x;
    const int x = f < F ? take_s[f] : 0;
    int tot;
    const int ex = dg::block_excl_scan(x, &tot);
    if (f < F) {
      rel_s[f] = n_rel + ex;
      if (x > 0) atomicAdd(&n_batch, 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) n_rel += tot;
    __syncthreads();
  }
  for (int k = threadIdx.x; k < F * d.bmax; k += blockDim.x) {
    const int f = k / d.bmax;
    const int j = k % d.bmax;
    if (j >= take_s[f]) continue;
    const int ff_idx = dg::fmod_i(ff_head[tF + f] + j, d.D);
    const int sid_c = ffbuf_out[(tF + f) * d.D + ff_idx];
    // JAX's gather: negative indices count from the end, then clamp
    int sidx = sid_c < 0 ? sid_c + d.R : sid_c;
    sidx = sidx < 0 ? 0 : (sidx >= d.R ? d.R - 1 : sidx);
    const int* src = req_out + ((long long)t * d.R + sidx) * d.W;
    const int rx_idx = dg::fmod_i(rx_tail[tF + f] + j, d.E_rx);
    int* dst = rxbuf_out + ((tF + f) * d.E_rx + rx_idx) * d.W;
    for (int w = 0; w < d.W; ++w) dst[w] = src[w];
    const int rel_idx = dg::fmod_i(ft_mid + rel_s[f] + j, d.R);
    fifo_out[(long long)t * d.R + rel_idx] = sid_c;
  }
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    rxt_out[tF + f] = rx_tail[tF + f] + take_s[f];
    ffh_out[tF + f] = ff_head[tF + f] + take_s[f];
  }
  __syncthreads();

  // ---- phase D: completion drain + latency telemetry --------------------
  for (int k = threadIdx.x; k < F * d.bmax; k += blockDim.x) {
    const int f = k / d.bmax;
    const int j = k % d.bmax;
    const int rh = rx_head[tF + f];
    const int occ = rxt_out[tF + f] - rh;
    const int idx_d = dg::fmod_i(rh + j, d.E_rx);
    const int* src = rxbuf_out + ((tF + f) * d.E_rx + idx_d) * d.W;
    int* dst = drained + ((tF + f) * d.bmax + j) * d.W;
    for (int w = 0; w < d.W; ++w) dst[w] = src[w];
    const bool dv = j < occ;
    dvalid[(tF + f) * d.bmax + j] = dv ? 1 : 0;
    const bool resp = ((((unsigned)src[2]) >> 16) & 0x1u) != 0u;
    if (dv && resp) {
      int lat = (int)((unsigned)tstep - (unsigned)src[4] + 1u);
      lat = lat < 0 ? 0 : lat;
      const int bin = lat < d.NB - 1 ? lat : d.NB - 1;
      atomicAdd(&hist_out[(long long)t * d.NB + bin], 1);
      atomicAdd(&n_done, 1);
      atomicAdd(&s_sum, (unsigned)lat);
    }
    if (j == 0) {
      const int n_take = occ < d.bmax ? occ : d.bmax;
      rxh_out[tF + f] = rh + n_take;
      atomicAdd(&n_compl, n_take);
    }
  }
  __syncthreads();

  // ---- register write-back ----------------------------------------------
  if (threadIdx.x == 0) {
    int* so = scal_out + t * SCAL_COLS;
    for (int c = 0; c < SCAL_COLS; ++c) so[c] = sc[c];
    so[S_FREE_HEAD] = free_head + n_gr;
    so[S_FREE_TAIL] = ft_mid + n_rel;
    so[S_RR] = dg::fmod_i(rr0 + base_rr, active);
    so[S_TSTEP] = tstep + 1;
    so[S_TNDONE] = sc[S_TNDONE] + n_done;
    so[S_TSUM] = (int)((unsigned)sc[S_TSUM] + s_sum);
    int delivered = 0;
    for (int f = 0; f < F; ++f) delivered += a_cnt[f];
    int* mo = mon_out + t * MON_COLS;
    mo[M_DELIVERED] = delivered;
    mo[M_EMITTED] = n_rel;
    mo[M_COMPLETED] = n_compl;
    mo[M_NO_SLOT] = n_dns;
    mo[M_FIFO_FULL] = base_lk;
    mo[M_BATCHES] = n_batch;
  }
}

}  // namespace

extern "C" int dg_switch_step(
    const int* tx_buf, const int* tx_head, const int* tx_tail,
    const int* rx_buf, const int* rx_head, const int* rx_tail,
    const int* req, const int* fifo, const int* ffbuf, const int* ff_head,
    const int* ff_tail, const int* tag, const int* srcf, const int* dest,
    const int* lb, const int* scal, const int* hist, const int* ext_slots,
    const int* ext_valid, const int* ext_dest, int* txh_out, int* rxbuf_out,
    int* rxh_out, int* rxt_out, int* req_out, int* fifo_out, int* ffbuf_out,
    int* ffh_out, int* fft_out, int* scal_out, int* hist_out,
    int* cand_slots, int* cand_valid, int* cand_dest, int* drained,
    int* dvalid, int* mon_out, int T, int F, int E, int E_rx, int W, int R,
    int D, int C, int NB, int M, int bmax, int include_fetch, int key_words,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Dims d{T, F, E, E_rx, W, R, D, C, NB, M, bmax, key_words};
  cudaError_t err = cudaSuccess;
#define DG_TRY(x) \
  if (err == cudaSuccess) err = (x)
  DG_TRY(dg_copy(rx_buf, rxbuf_out, (long long)T * F * E_rx * W, s));
  DG_TRY(dg_copy(req, req_out, (long long)T * R * W, s));
  DG_TRY(dg_copy(fifo, fifo_out, (long long)T * R, s));
  DG_TRY(dg_copy(ffbuf, ffbuf_out, (long long)T * F * D, s));
  DG_TRY(dg_copy(hist, hist_out, (long long)T * NB, s));
  DG_TRY(cudaMemsetAsync(mon_out, 0, sizeof(int) * (size_t)T * MON_COLS, s));
  if (include_fetch) {
    if (M > 0) {
      fetch_kernel<<<(M + 255) / 256, 256, 0, s>>>(
          tx_buf, tx_head, tx_tail, tag, dest, scal, txh_out, cand_slots,
          cand_valid, cand_dest, mon_out, d);
      DG_TRY(cudaGetLastError());
    }
  } else {
    DG_TRY(dg_copy(tx_head, txh_out, (long long)T * F, s));
    DG_TRY(dg_copy(ext_slots, cand_slots, (long long)M * W, s));
    DG_TRY(dg_copy(ext_valid, cand_valid, (long long)M, s));
    DG_TRY(dg_copy(ext_dest, cand_dest, (long long)M, s));
  }
#undef DG_TRY
  if (err != cudaSuccess) return (int)err;
  size_t shmem = (size_t)4 * F * sizeof(int);
  step_kernel<<<T, DG_BLOCK, shmem, s>>>(
      rx_head, rx_tail, fifo, ff_head, ff_tail, tag, srcf, lb, scal,
      cand_slots, cand_valid, cand_dest, rxbuf_out, rxh_out, rxt_out,
      req_out, fifo_out, ffbuf_out, ffh_out, fft_out, scal_out, hist_out,
      drained, dvalid, mon_out, d);
  return (int)cudaGetLastError();
}
