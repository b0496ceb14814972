// nic_deliver_fused: the fused TX-path delivery stage (paper Fig. 9B).
// Replaces the Pallas kernel repro/kernels/nic_deliver.py
// (nic_deliver_fused), whose body is a serial fori_loop over the request
// tile carrying the arbitration registers.  Here one block walks the
// tile in chunks of 1024 rows and every carried register becomes a
// closed form over the candidate order:
//   grant rank  = exclusive count of valid rows before i,
//   RR position = exclusive count of valid round-robin rows before i,
//   push rank   = exclusive count of granted rows before i on the same
//                 flow (ordered_group_rank),
//   leak rank   = exclusive count of leaked rows before i.
// Reads go to the input (pre-write) tables and writes to the outputs,
// which start as copies of the inputs, as in the 1W3R model.
#include "common.cuh"

namespace {

enum { LB_RR = 0, LB_STATIC = 1, LB_OBJECT = 2 };
enum { SC_FREE_HEAD = 0, SC_FREE_AVAIL, SC_FREE_TAIL, SC_RR0, SC_ACTIVE };
constexpr int HEADER_WORDS = 5;

__global__ void nic_deliver_kernel(
    const int* __restrict__ slots, const int* __restrict__ valid,
    const int* __restrict__ fifo, const int* __restrict__ tag,
    const int* __restrict__ srcf_t, const int* __restrict__ lb_t,
    const int* __restrict__ fftail, const int* __restrict__ ffspace,
    const int* __restrict__ scal, int* __restrict__ req_out,
    int* __restrict__ ffbuf_out, int* __restrict__ fifo_out,
    int* __restrict__ sid_out, int* __restrict__ flow_out,
    int* __restrict__ granted_out, int* __restrict__ accepted_out,
    int* __restrict__ acc_out, int* __restrict__ ctr_out, int N, int W,
    int R, int F, int D, int C, int key_words) {
  extern __shared__ int sh[];
  int* g_cnt = sh;        // [F] granted rows so far, per flow
  int* a_cnt = sh + F;    // [F] accepted rows, per flow
  __shared__ int base_v, base_rr, base_lk, n_granted;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    g_cnt[f] = 0;
    a_cnt[f] = 0;
  }
  if (threadIdx.x == 0) {
    base_v = 0;
    base_rr = 0;
    base_lk = 0;
    n_granted = 0;
  }
  __syncthreads();
  const int free_head = scal[SC_FREE_HEAD];
  const int free_avail = scal[SC_FREE_AVAIL];
  const int free_tail = scal[SC_FREE_TAIL];
  const int rr0 = scal[SC_RR0];
  const int active = scal[SC_ACTIVE];

  for (int chunk = 0; chunk < N; chunk += blockDim.x) {
    const int i = chunk + threadIdx.x;
    const bool in = i < N;
    const int* row = slots + (long long)(in ? i : 0) * W;
    const bool v = in && valid[i] != 0;

    // free-slot FIFO grant, FIFO order
    int tot_v;
    const int vrank = base_v + dg::block_excl_scan(v ? 1 : 0, &tot_v);
    const bool granted = v && vrank < free_avail;
    const int sid = granted ? fifo[dg::fmod_i(free_head + vrank, R)] : R;
    // request-buffer write; a slot id out of range (an inconsistent free
    // FIFO) writes nothing, as JAX's dropping scatter
    const int sw = sid < 0 ? sid + R : sid;
    if (granted && sw >= 0 && sw < R) {
      for (int w = 0; w < W; ++w) req_out[(long long)sw * W + w] = row[w];
    }

    // connection lookup (read port 2) + steering
    const int cid = row[0];
    const int ci = dg::fmod_i(cid, C);
    const bool hit = tag[ci] == cid;
    const int srcf = srcf_t[ci];
    const int lbv = lb_t[ci];
    const bool is_resp = ((((unsigned)row[2]) >> 16) & 0x1u) != 0u;
    const bool is_rr = v && lbv == LB_RR;
    int tot_rr;
    const int rrrank = base_rr + dg::block_excl_scan(is_rr ? 1 : 0, &tot_rr);
    int flow;
    if (lbv == LB_STATIC) {
      flow = dg::fmod_i(srcf, active);
    } else if (lbv == LB_OBJECT) {
      flow = (int)(dg::fnv1a(row + HEADER_WORDS, key_words) %
                   (uint32_t)active);
    } else {
      flow = dg::fmod_i(rr0 + rrrank, active);
    }
    if (is_resp && hit) flow = dg::fmod_i(srcf, active);

    // flow-FIFO push rank among granted rows of the same flow
    // (flow < F holds whenever active <= F, the caller's contract; the
    // clamp only keeps a broken contract inside the arrays)
    const int fl = flow < F ? flow : F - 1;
    const int frank = dg::ordered_group_rank(granted, fl, g_cnt);
    const bool accepted = granted && frank < ffspace[fl];
    if (accepted && flow < F) {
      const int pos = dg::fmod_i(fftail[flow] + frank, D);
      ffbuf_out[(long long)flow * D + pos] = sid;
      atomicAdd(&a_cnt[flow], 1);
    }

    // flow FIFO full: leak the granted slot back to the free FIFO
    const bool leaked = granted && !accepted;
    int tot_lk;
    const int lrank = base_lk + dg::block_excl_scan(leaked ? 1 : 0, &tot_lk);
    if (leaked) fifo_out[dg::fmod_i(free_tail + lrank, R)] = sid;

    int tot_g;
    dg::block_excl_scan(granted ? 1 : 0, &tot_g);
    if (in) {
      sid_out[i] = sid;
      flow_out[i] = flow;
      granted_out[i] = granted ? 1 : 0;
      accepted_out[i] = accepted ? 1 : 0;
    }
    if (threadIdx.x == 0) {
      base_v += tot_v;
      base_rr += tot_rr;
      base_lk += tot_lk;
      n_granted += tot_g;
    }
    __syncthreads();
  }
  for (int f = threadIdx.x; f < F; f += blockDim.x) acc_out[f] = a_cnt[f];
  if (threadIdx.x == 0) {
    ctr_out[0] = n_granted;
    ctr_out[1] = base_lk;
    ctr_out[2] = base_rr;
  }
}

}  // namespace

extern "C" int dg_nic_deliver(const int* slots, const int* valid,
                              const int* fifo, const int* req,
                              const int* ffbuf, const int* tag,
                              const int* srcf, const int* lb,
                              const int* fftail, const int* ffspace,
                              const int* scal, int* req_out, int* ffbuf_out,
                              int* fifo_out, int* sid_out, int* flow_out,
                              int* granted_out, int* accepted_out,
                              int* acc_out, int* ctr_out, int N, int W, int R,
                              int F, int D, int C, int key_words,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = dg_copy(req, req_out, (long long)R * W, s);
  if (err == cudaSuccess) err = dg_copy(ffbuf, ffbuf_out, (long long)F * D, s);
  if (err == cudaSuccess) err = dg_copy(fifo, fifo_out, (long long)R, s);
  if (err != cudaSuccess) return (int)err;
  size_t shmem = (size_t)2 * F * sizeof(int);
  nic_deliver_kernel<<<1, DG_BLOCK, shmem, s>>>(
      slots, valid, fifo, tag, srcf, lb, fftail, ffspace, scal, req_out,
      ffbuf_out, fifo_out, sid_out, flow_out, granted_out, accepted_out,
      acc_out, ctr_out, N, W, R, F, D, C, key_words);
  return (int)cudaGetLastError();
}
