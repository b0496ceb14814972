// The TX path's serial arbiter over a thread-block cluster: the closed
// forms that nic_deliver.cu (the delivery stage) and phase B of
// switch_step.cu (the fused step) share.
//
// The hardware arbiter takes the candidate rows of a tile in order and
// carries four registers: the grant counter (valid rows so far: the free
// FIFO's read offset), the round-robin cursor (valid round-robin rows so
// far), a push counter per flow (granted rows so far on that flow: the
// flow FIFO's write offset) and the leak counter (granted rows whose flow
// FIFO was full: the free FIFO's write-back offset).  Here candidate i of
// a chunk is thread i of the cluster (CTA rank-major) and each register
// is a prefix count in candidate order: a CTA scan, plus the totals (for
// the push counter, the per-flow counts) of the lower-ranked CTAs read
// from distributed shared memory, plus what the earlier chunks carried.
// cluster.sync() separates the dependent rounds:
//
//   round 1: grant rank and RR rank, two 16-bit counts in one CTA scan;
//   round 2: the ordered per-flow push rank (dg::ordered_group_rank in
//            the CTA, the lower CTAs' counts of the flow, the carry);
//   round 3: the leak rank.
//
// The results are the serial arbiter's, bit for bit.  What a row does
// with its ranks (which free FIFO it reads, which tables it writes) is
// the caller's, passed in as three functions.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace dg {

namespace cg = cooperative_groups;

// Words of the CTA's published values that the arbiter owns: pub[0..2].
enum { ARB_V = 0, ARB_RR, ARB_LK, ARB_WORDS };

// Counts carried from the earlier chunks (equal in every thread).
struct ArbCarry {
  int v, rr, lk;  // valid rows, valid round-robin rows, leaked rows
};

// One chunk of candidates through the three rounds.  Every thread of
// every CTA of the cluster calls it.  valid / is_rr: this row takes part
// in the grant / advances the RR cursor (an RR row is a valid row).
//   grant(vrank, rrrank, &key) -> granted: vrank = valid rows before this
//     one in the tile, rrrank = valid RR rows before it; a granted row sets
//     key, its flow in [0, F);
//   push(key, frank) -> accepted, for granted rows: frank = granted rows
//     of the same flow before this one;
//   leak(leaked, lrank), for every row: leaked = granted and not accepted,
//     lrank = leaked rows before this one.
// cnt [F] and gcar [F] are shared memory (gcar zeroed before the first
// chunk), pub [ARB_WORDS] too; the call ends on a cluster.sync(), after
// which car holds the counts through this chunk.
template <class Grant, class Push, class Leak>
__device__ __forceinline__ void arbitrate_chunk(
    cg::cluster_group& cluster, int* pub, int* cnt, int* gcar, int F,
    ArbCarry& car, bool valid, bool is_rr, Grant grant, Push push,
    Leak leak) {
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int f = threadIdx.x; f < F; f += blockDim.x) cnt[f] = 0;

  // round 1: grant rank and RR rank
  int tot1;
  const int ex1 =
      block_excl_scan((valid ? 1 : 0) | (is_rr ? 0x10000 : 0), &tot1);
  if (threadIdx.x == 0) {
    pub[ARB_V] = tot1 & 0xFFFF;
    pub[ARB_RR] = tot1 >> 16;
  }
  cluster.sync();
  int off_v = 0, off_rr = 0, all_v = 0, all_rr = 0;
  for (int q = 0; q < nc; ++q) {
    const int* p = cluster.map_shared_rank(pub, q);
    const int pv = p[ARB_V], prr = p[ARB_RR];
    if (q < rank) {
      off_v += pv;
      off_rr += prr;
    }
    all_v += pv;
    all_rr += prr;
  }
  int key = 0;
  const bool granted = grant(car.v + off_v + (ex1 & 0xFFFF),
                             car.rr + off_rr + (ex1 >> 16), &key);

  // round 2: ordered per-flow push rank
  const int local = ordered_group_rank(granted, key, cnt);
  cluster.sync();
  bool accepted = false;
  if (granted) {
    int frank = gcar[key] + local;
    for (int q = 0; q < rank; ++q)
      frank += cluster.map_shared_rank(cnt, q)[key];
    accepted = push(key, frank);
  }

  // round 3: leak rank
  const bool leaked = granted && !accepted;
  int tot_lk;
  const int ex2 = block_excl_scan(leaked ? 1 : 0, &tot_lk);
  if (threadIdx.x == 0) pub[ARB_LK] = tot_lk;
  cluster.sync();
  int off_lk = 0, all_lk = 0;
  for (int q = 0; q < nc; ++q) {
    const int plk = cluster.map_shared_rank(pub, q)[ARB_LK];
    if (q < rank) off_lk += plk;
    all_lk += plk;
  }
  leak(leaked, car.lk + off_lk + ex2);

  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    int s = 0;
    for (int q = 0; q < nc; ++q) s += cluster.map_shared_rank(cnt, q)[f];
    gcar[f] += s;
  }
  car.v += all_v;
  car.rr += all_rr;
  car.lk += all_lk;
  cluster.sync();  // remote reads done before the next chunk's writes
}

}  // namespace dg
