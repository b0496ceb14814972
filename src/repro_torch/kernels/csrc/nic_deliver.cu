// nic_deliver_fused: the fused TX-path delivery stage (paper Fig. 9B).
// Replaces the Pallas kernel repro/kernels/nic_deliver.py
// (nic_deliver_fused), whose body is a serial fori_loop over the request
// tile carrying the arbitration registers.
//
// Bound on the card: bytes.  Out of place, the call reads the request
// table, the free FIFO and the flow FIFOs ([R, W], [R], [F, D]) and
// writes their copies, plus the tile and the per-row decisions; the
// arithmetic is a few integer operations a row.  What it waits on is the
// serial arbitration (each register a prefix count in candidate order)
// and the copy.  The design:
//
//   * two launches.  copy_tables fills the three output tables from the
//     inputs over the whole card (int4 where aligned).  deliver_kernel is
//     one thread-block cluster of NC <= 8 CTAs of 256 threads, candidate i
//     of a chunk being thread i of the cluster (a chunk loop beyond 2,048
//     rows), through the arbiter's rounds that phase B of switch_step.cu
//     runs too (dg::arbitrate_chunk, arbiter.cuh).
//   * the arbitration reads only inputs, so with programmatic dependent
//     launch it runs while the copy is in flight: copy_tables lets it
//     launch at once (griddepcontrol.launch_dependents) and it waits for
//     the copy (griddepcontrol.wait) just before its first write into the
//     output tables.  Its per-row decisions and counters are fresh outputs
//     the copy does not touch.
//   * pure, as the stage API is: reads go to the input tables (the 1W3R
//     model's pre-write state) and writes to the outputs, so a leak is
//     written to fifo_out at once, with no scratch list.
//   * accepted rows per flow are counted per CTA in shared memory and
//     summed over the cluster at the end, each CTA a slice of the flows.
#include <cooperative_groups.h>

#include "arbiter.cuh"

namespace cg = cooperative_groups;

namespace {

enum { LB_RR = 0, LB_STATIC = 1, LB_OBJECT = 2 };
enum { SC_FREE_HEAD = 0, SC_FREE_AVAIL, SC_FREE_TAIL, SC_RR0, SC_ACTIVE };
constexpr int HEADER_WORDS = 5;
constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kCopyThreads = 256;
constexpr int kCopyBlocks = 264;  // two a SM: room beside them for the cluster

struct Seg {
  const int* src;
  int* dst;
  long long n;
};

__device__ __forceinline__ void copy_seg(const Seg& s, long long k,
                                         long long stride) {
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(s.src) |
        reinterpret_cast<uintptr_t>(s.dst)) & 15) == 0) {
    const long long n4 = s.n >> 2;
    const int4* src = reinterpret_cast<const int4*>(s.src);
    int4* dst = reinterpret_cast<int4*>(s.dst);
    for (long long j = k; j < n4; j += stride) dst[j] = __ldg(src + j);
    done = n4 << 2;
  }
  for (long long j = done + k; j < s.n; j += stride) s.dst[j] = s.src[j];
}

// The output tables start as copies of the inputs: one launch for all
// three.
__global__ void __launch_bounds__(kCopyThreads)
    copy_tables(Seg req, Seg ffbuf, Seg fifo) {
  asm volatile("griddepcontrol.launch_dependents;");
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  copy_seg(req, k, stride);
  copy_seg(ffbuf, k, stride);
  copy_seg(fifo, k, stride);
}

// Wait for the copy that fills the output tables (a no-op when this
// kernel was not launched as its programmatic dependent).
__device__ __forceinline__ void wait_for_copy() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

struct Args {
  const int* slots;
  const int* valid;
  const int* fifo;
  const int* tag;
  const int* srcf;
  const int* lb;
  const int* fftail;
  const int* ffspace;
  const int* scal;
  int* req_out;
  int* ffbuf_out;
  int* fifo_out;
  int* sid_out;
  int* flow_out;
  int* granted_out;
  int* accepted_out;
  int* acc_out;
  int* ctr_out;
  int N, W, R, F, D, C, key_words, vec;
};

__global__ void __launch_bounds__(kThreads) deliver_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int F = a.F;
  const int R = a.R;

  extern __shared__ int sh[];
  int* cnt = sh;           // [F] this CTA's granted rows per flow, this chunk
  int* gcar = sh + F;      // [F] granted rows per flow so far (whole cluster)
  int* acc = sh + 2 * F;   // [F] this CTA's accepted rows per flow
  __shared__ int pub[dg::ARB_WORDS];
  for (int f = tid; f < F; f += kThreads) {
    gcar[f] = 0;
    acc[f] = 0;
  }
  const int free_head = a.scal[SC_FREE_HEAD];
  const int free_avail = a.scal[SC_FREE_AVAIL];
  const int free_tail = a.scal[SC_FREE_TAIL];
  const int rr0 = a.scal[SC_RR0];
  const int active = a.scal[SC_ACTIVE];
  dg::ArbCarry car{0, 0, 0};
  const int chunk = nc * kThreads;

  for (int c0 = 0; c0 < a.N; c0 += chunk) {
    const int i = c0 + rank * kThreads + tid;
    const bool in = i < a.N;
    const int* row = a.slots + (long long)(in ? i : 0) * a.W;
    const bool v = in && a.valid[i] != 0;

    // connection lookup (read port 2) + steering inputs
    const int cid = row[0];
    const int ci = dg::fmod_i(cid, a.C);
    const bool hit = a.tag[ci] == cid;
    const int srcf = a.srcf[ci];
    const int lbv = a.lb[ci];
    const bool is_resp = ((((unsigned)row[2]) >> 16) & 0x1u) != 0u;

    int sid = R, flow = 0, ffpos = -1, lkpos = -1;
    bool granted = false, accepted = false;
    dg::arbitrate_chunk(
        cluster, pub, cnt, gcar, F, car, v, v && lbv == LB_RR,
        [&](int vrank, int rrrank, int* key) {
          // free-slot FIFO grant, FIFO order
          granted = v && vrank < free_avail;
          if (granted) sid = a.fifo[dg::fmod_i(free_head + vrank, R)];
          if (lbv == LB_STATIC) {
            flow = dg::fmod_i(srcf, active);
          } else if (lbv == LB_OBJECT) {
            flow = (int)(dg::fnv1a(row + HEADER_WORDS, a.key_words) %
                         (uint32_t)active);
          } else {
            flow = dg::fmod_i(rr0 + rrrank, active);
          }
          if (is_resp && hit) flow = dg::fmod_i(srcf, active);
          // flow_out keeps the flow; the rank takes it clamped (flow < F
          // whenever active <= F, the caller's contract; the clamp only
          // keeps a broken contract inside the arrays)
          *key = flow < F ? flow : F - 1;
          return granted;
        },
        [&](int fl, int frank) {
          accepted = frank < a.ffspace[fl];
          if (accepted && flow < F) ffpos = dg::fmod_i(a.fftail[flow] + frank,
                                                       a.D);
          return accepted;
        },
        [&](bool leaked, int lrank) {
          // flow FIFO full: the granted slot goes back to the free FIFO
          if (leaked) lkpos = dg::fmod_i(free_tail + lrank, R);
        });
    if (in) {
      a.sid_out[i] = sid;
      a.flow_out[i] = flow;
      a.granted_out[i] = granted ? 1 : 0;
      a.accepted_out[i] = accepted ? 1 : 0;
    }

    wait_for_copy();
    // request-buffer write; a slot id out of range (an inconsistent free
    // FIFO) writes nothing, as JAX's dropping scatter
    const int sw = sid < 0 ? sid + R : sid;
    if (granted && sw >= 0 && sw < R) {
      int* dst = a.req_out + (long long)sw * a.W;
      if (a.vec) {
        for (int q = 0; q < a.W / 4; ++q)
          reinterpret_cast<int4*>(dst)[q] =
              reinterpret_cast<const int4*>(row)[q];
      } else {
        for (int w = 0; w < a.W; ++w) dst[w] = row[w];
      }
    }
    if (ffpos >= 0) {
      a.ffbuf_out[(long long)flow * a.D + ffpos] = sid;
      atomicAdd(&acc[flow], 1);
    }
    if (lkpos >= 0) a.fifo_out[lkpos] = sid;
  }

  // this grid completes after the copy, whatever N is
  wait_for_copy();
  cluster.sync();  // every CTA's accepted counts are final
  const int fc = (F + nc - 1) / nc;
  const int f1 = min(F, (rank + 1) * fc);
  for (int f = rank * fc + tid; f < f1; f += kThreads) {
    int s = 0;
    for (int q = 0; q < nc; ++q) s += cluster.map_shared_rank(acc, q)[f];
    a.acc_out[f] = s;
  }
  if (rank == 0 && tid == 0) {
    // granted rows: the valid rows whose grant rank is below free_avail
    a.ctr_out[0] = max(0, min(car.v, free_avail));
    a.ctr_out[1] = car.lk;
    a.ctr_out[2] = car.rr;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
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
                              int F, int D, int C, int key_words, int vec,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Seg segs[3] = {{req, req_out, (long long)R * W},
                       {ffbuf, ffbuf_out, (long long)F * D},
                       {fifo, fifo_out, (long long)R}};
  long long most = 0;
  for (const Seg& g : segs) most = g.n > most ? g.n : most;
  if (most > 0) {
    long long blocks = (most / 4 + kCopyThreads - 1) / kCopyThreads;
    blocks = blocks < 1 ? 1 : (blocks > kCopyBlocks ? kCopyBlocks : blocks);
    copy_tables<<<(unsigned)blocks, kCopyThreads, 0, s>>>(segs[0], segs[1],
                                                          segs[2]);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  int nc = (N + kThreads - 1) / kThreads;
  nc = nc < 1 ? 1 : (nc > kMaxCluster ? kMaxCluster : nc);
  const size_t smem = sizeof(int) * (size_t)3 * F;
  if (smem > 32 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        deliver_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Args a{slots,   valid,       fifo,         tag,     srcf,    lb,
         fftail,  ffspace,     scal,         req_out, ffbuf_out, fifo_out,
         sid_out, flow_out,    granted_out,  accepted_out, acc_out, ctr_out,
         N,       W,           R,            F,       D,       C,
         key_words, vec};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nc, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = most > 0 ? 2 : 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, deliver_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
