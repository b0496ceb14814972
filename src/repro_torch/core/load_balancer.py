"""Request load balancers (the RPC unit's steering stage, §4.4.2/§5.7).

* ``LB_ROUND_ROBIN`` — dynamic uniform steering across active flows.
* ``LB_STATIC``      — connection-pinned: requests follow conn.src_flow.
* ``LB_OBJECT``      — MICA object-level steering: FNV-1a hash of the key
  (first payload words) -> owning flow.

FNV-1a is uint32 arithmetic; PyTorch lacks a full uint32 tensor type, so
the hash runs in int64 with every product masked back to 32 bits (a
32-bit value times the 25-bit prime stays below 2**57).
"""
from __future__ import annotations

import torch

LB_ROUND_ROBIN = 0
LB_STATIC = 1
LB_OBJECT = 2

FNV_OFFSET = 0x811C9DC5
FNV_PRIME = 0x01000193
U32_MASK = 0xFFFFFFFF
BYTE_MASK = 0xFF


def fnv1a_words(words, n_words: int):
    """FNV-1a over the little-endian bytes of ``n_words`` leading int32
    words.  words: [..., >=n_words] int32 -> hash as int64 in [0, 2**32)."""
    u = words[..., :n_words].to(torch.int64) & U32_MASK
    h = torch.full(u.shape[:-1], FNV_OFFSET, dtype=torch.int64,
                   device=words.device)
    for i in range(n_words):
        for shift in (0, 8, 16, 24):
            octet = (u[..., i] >> shift) & BYTE_MASK
            h = ((h ^ octet) * FNV_PRIME) & U32_MASK
    return h


def steer(lb_scheme, payload, conn_flow, rr_base, n_flows, key_words: int = 2,
          valid=None):
    """Vectorized steering decision.

    lb_scheme: [N] int32 per-request scheme; payload: [N, W] int32;
    conn_flow: [N] int32; rr_base: scalar int32 round-robin cursor;
    n_flows: scalar int32 (>= 1); valid: [N] bool (None = all).

    Returns (flow [N] int32, new rr cursor).  Round-robin positions are
    cumulative over the VALID round-robin requests only.
    """
    is_rr = lb_scheme == LB_ROUND_ROBIN
    vrr = (is_rr if valid is None else (is_rr & valid)).to(torch.int32)
    rr_rank = torch.cumsum(vrr, dim=0, dtype=torch.int32) - vrr
    rr = (rr_base + rr_rank) % n_flows
    obj = (fnv1a_words(payload, key_words) % n_flows).to(torch.int32)
    pinned = conn_flow % n_flows
    picked = torch.where(lb_scheme == LB_OBJECT, obj, rr)
    out = torch.where(lb_scheme == LB_STATIC, pinned, picked).to(torch.int32)
    n_rr = vrr.sum(dtype=torch.int32)
    return out, ((rr_base + n_rr) % n_flows).to(torch.int32)
