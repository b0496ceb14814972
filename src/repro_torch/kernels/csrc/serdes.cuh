// The RPC unit's word assembly (serdes.pack), shared by the rpc_pack
// kernel and the packed-source mode of the ring_push kernel, so a TX
// enqueue can pack each slot word as the push writes it.
//
// Word w of record i's wire slot: 0 conn_id, 1 rpc_id, 2 fn_id & 0xFFFF
// | flags << 16, 3 payload_len & 0xFFFF | (frag_idx & 0xFFFF) << 16,
// 4 timestamp, then the payload [N, pw] cut or zero-padded to the slot.
// The header halves are assembled in uint32_t: flags or frag_idx of
// 0x8000 and above shift into the sign bit, which JAX and PyTorch wrap
// but a signed C++ shift leaves undefined.
#pragma once

#include <stdint.h>

#define DG_HEADER_WORDS 5

namespace dg {

// The seven header field arrays [N] and the payload [N, pw] of a record
// batch, in wire order.
struct PackSrc {
  const int* conn;
  const int* rpc;
  const int* fn;
  const int* flags;
  const int* plen;
  const int* frag;
  const int* ts;
  const int* payload;
  int pw;
};

__device__ __forceinline__ uint32_t pack_word(const PackSrc& s, int i,
                                              int w) {
  switch (w) {
    case 0: return (uint32_t)s.conn[i];
    case 1: return (uint32_t)s.rpc[i];
    case 2: return ((uint32_t)s.fn[i] & 0xFFFFu) | ((uint32_t)s.flags[i] << 16);
    case 3: return ((uint32_t)s.plen[i] & 0xFFFFu)
                   | (((uint32_t)s.frag[i] & 0xFFFFu) << 16);
    case 4: return (uint32_t)s.ts[i];
    default: {
      int p = w - DG_HEADER_WORDS;
      return p < s.pw ? (uint32_t)s.payload[(long long)i * s.pw + p] : 0u;
    }
  }
}

}  // namespace dg
