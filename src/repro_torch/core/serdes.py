"""RPC wire format and (de)serialization — the RPC unit's serdes stage.

An RPC occupies one ring slot of ``slot_words`` little-endian int32
words:

  word 0   connection id (c_id)
  word 1   rpc id (client-assigned, echoed in the response)
  word 2   fn_id (low 16) | flags (high 16):  bit0 = RESPONSE,
           bit1 = FRAGMENT, bit2 = LAST_FRAGMENT
  word 3   payload length in bytes (low 16) | fragment index (high 16)
  word 4   timestamp — the fabric step the RPC was issued on
  word 5+  payload (args / return value)

A *record batch* is the structured view: a dict of equal-length int32
tensors.  ``pack`` assembles the header words and ``unpack`` splits them
back out (leading dims kept).  ``WIRE_REGISTRY`` is the one declared
allocation table of the packed bit fields; the ``FLAG_*`` constants equal
``1 << lo`` of their entries.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve

FLAG_RESPONSE = 1
FLAG_FRAGMENT = 2
FLAG_LAST_FRAGMENT = 4

HEADER_WORDS = 5

# Wire-format bit registry: every packed bit field on the wire, as
# ``space -> field -> (lo, hi)`` (a pure literal: no names, no arithmetic).
#   "flags"  — the 16-bit flag half of header word 2 (bit 0 = lsb).
#   "word2"  — header word 2: fn_id | flags.
#   "word3"  — header word 3: payload_len | frag_idx.
#   "rpc_id" — header word 1: per-flow id blocks.
WIRE_REGISTRY = {
    "flags": {
        "FLAG_RESPONSE":      (0, 0),
        "FLAG_FRAGMENT":      (1, 1),
        "FLAG_LAST_FRAGMENT": (2, 2),
        "origin_flow":        (8, 15),
    },
    "word2": {
        "fn_id": (0, 15),
        "flags": (16, 31),
    },
    "word3": {
        "payload_len": (0, 15),
        "frag_idx":    (16, 31),
    },
    "rpc_id": {
        "seq":  (0, 19),
        "flow": (20, 30),
    },
}


def payload_words(slot_words: int) -> int:
    return slot_words - HEADER_WORDS


def _i32(x, device):
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def make_records(conn_id, rpc_id, fn_id, flags, payload, payload_len=None,
                 frag_idx=None, timestamp=None, device=None):
    """Build a record batch; ``payload``: [N, payload_words] int32 (or
    [..., N, payload_words] with fields of the leading shape).

    ``timestamp`` is the issue step stamped into header word 4 (scalar or
    [N]; default 0 = unstamped).  Tensors are made on ``device``, which
    defaults to ``conn_id``'s device when it is a tensor and otherwise to
    the CUDA device.
    """
    if device is None:
        device = (conn_id.device if isinstance(conn_id, torch.Tensor)
                  else resolve())
    conn_id = _i32(conn_id, device)
    payload = _i32(payload, device)
    n = conn_id.shape
    if payload_len is None:
        payload_len = torch.full(n, payload.shape[-1] * 4,
                                 dtype=torch.int32, device=device)
    if frag_idx is None:
        frag_idx = torch.zeros(n, dtype=torch.int32, device=device)
    if timestamp is None:
        timestamp = torch.zeros_like(conn_id)
    return {
        "conn_id": conn_id,
        "rpc_id": _i32(rpc_id, device),
        "fn_id": _i32(fn_id, device),
        "flags": _i32(flags, device),
        "payload_len": _i32(payload_len, device),
        "frag_idx": _i32(frag_idx, device),
        # scalar timestamps broadcast to the batch shape
        "timestamp": torch.broadcast_to(_i32(timestamp, device),
                                        conn_id.shape),
        "payload": payload,
    }


def header_fields(records):
    """The seven header fields of a record batch in wire order —
    ``(conn_id, rpc_id, fn_id, flags, payload_len, frag_idx,
    timestamp)`` — as contiguous int32 [N] tensors (what the
    ``rpc_pack`` kernel takes).  Record dicts predating the frag_idx /
    timestamp fields give 0 for them."""
    plen = records["payload_len"]
    frag = records.get("frag_idx", torch.zeros_like(plen))
    ts = torch.broadcast_to(records.get("timestamp", torch.zeros_like(plen)),
                            plen.shape)
    return tuple(x.to(torch.int32).contiguous() for x in (
        records["conn_id"], records["rpc_id"], records["fn_id"],
        records["flags"], plen, frag, ts))


def pack(records, slot_words: int):
    """records -> slots [..., N, slot_words] int32."""
    pw = payload_words(slot_words)
    conn_id, rpc_id, fn_id, flags, plen, frag, ts = header_fields(records)
    w2 = (fn_id & 0xFFFF) | (flags << 16)
    w3 = (plen & 0xFFFF) | ((frag & 0xFFFF) << 16)
    payload = records["payload"]
    if payload.shape[-1] < pw:
        payload = torch.nn.functional.pad(
            payload, (0, pw - payload.shape[-1]))
    else:
        payload = payload[..., :pw]
    header = torch.stack([conn_id, rpc_id, w2, w3, ts], dim=-1)
    return torch.cat([header, payload.to(torch.int32)], dim=-1)


def unpack(slots):
    """slots [..., slot_words] int32 -> record batch (leading dims kept)."""
    w2 = slots[..., 2]
    return {
        "conn_id": slots[..., 0],
        "rpc_id": slots[..., 1],
        "fn_id": w2 & 0xFFFF,
        "flags": (w2 >> 16) & 0xFFFF,
        "payload_len": slots[..., 3] & 0xFFFF,
        "frag_idx": (slots[..., 3] >> 16) & 0xFFFF,
        "timestamp": slots[..., 4],
        "payload": slots[..., HEADER_WORDS:],
    }


def empty_records(n: int, slot_words: int, device="cuda"):
    dev = resolve(device)
    z = torch.zeros((n,), dtype=torch.int32, device=dev)
    return make_records(z, z, z, z,
                        torch.zeros((n, payload_words(slot_words)),
                                    dtype=torch.int32, device=dev))
