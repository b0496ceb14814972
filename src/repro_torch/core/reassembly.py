"""Software RPC reassembly for payloads larger than one slot (§4.7).

The memory-interconnect MTU is one cache line; Dagger's current hardware
only moves single-slot RPCs, and the paper explicitly leaves >MTU
reassembly to software (CAM-based hardware reassembly is future work).
This module is that software path: fragment on send, reassemble on
receive, keyed by (conn_id, rpc_id).  Fragment order comes from the
record's ``frag_idx`` field (header word-3 high bits on the wire — see
``core.serdes``), and the final fragment's ``payload_len`` encodes
its TRUE remaining byte length, not the slot-padded length, so the
reassembled payload is trimmed to the sender's exact size instead of
carrying trailing zero-padding.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import serdes


def fragment(payload_words: np.ndarray, words_per_slot: int):
    """Split a long payload into per-slot fragments.

    Returns list of (fragment_payload, flags, frag_index, frag_bytes);
    ``fragment_payload`` is zero-padded to ``words_per_slot`` while
    ``frag_bytes`` is the unpadded byte length the header must carry."""
    p = np.asarray(payload_words, np.int32)
    chunks = [p[i:i + words_per_slot]
              for i in range(0, max(len(p), 1), words_per_slot)]
    out = []
    for i, ch in enumerate(chunks):
        flags = serdes.FLAG_FRAGMENT
        if i == len(chunks) - 1:
            flags |= serdes.FLAG_LAST_FRAGMENT
        buf = np.zeros((words_per_slot,), np.int32)
        buf[:len(ch)] = ch
        out.append((buf, flags, i, len(ch) * 4))
    return out


class Reassembler:
    """Host-side reassembly buffer keyed by (conn_id, rpc_id)."""

    def __init__(self, max_fragments: int = 64):
        self.max_fragments = max_fragments
        self._partial: Dict[tuple, Dict[int, np.ndarray]] = {}
        self._last: Dict[tuple, int] = {}

    def feed(self, record: dict) -> Optional[np.ndarray]:
        """Feed one received record; returns the full payload when complete,
        else None.  Non-fragmented records pass straight through."""
        flags = int(record["flags"])
        if not flags & serdes.FLAG_FRAGMENT:
            return np.asarray(record["payload"], np.int32)
        key = (int(record["conn_id"]), int(record["rpc_id"]))
        idx = int(record["frag_idx"])
        payload = np.asarray(record["payload"], np.int32)
        # trim each fragment to the byte length its header declares: only
        # the final fragment is ever partial, so concatenation recovers
        # the sender's exact payload with no trailing slot padding
        n_words = -(-int(record["payload_len"]) // 4)        # ceil bytes/4
        frags = self._partial.setdefault(key, {})
        frags[idx] = payload[:n_words]
        if flags & serdes.FLAG_LAST_FRAGMENT:
            self._last[key] = idx
        last = self._last.get(key)
        if last is not None and len(frags) == last + 1:
            payload = np.concatenate([frags[i] for i in range(last + 1)])
            del self._partial[key]
            del self._last[key]
            return payload
        if len(frags) > self.max_fragments:
            del self._partial[key]            # drop runaway reassembly
            self._last.pop(key, None)
        return None


def pack_fragmented(conn_id: int, rpc_id: int, fn_id: int,
                    payload_words: np.ndarray, slot_words: int):
    """Build the list of record dicts for a >MTU RPC."""
    pw = serdes.payload_words(slot_words)
    recs = []
    for buf, flags, idx, nbytes in fragment(payload_words, pw):
        recs.append({
            "conn_id": np.int32(conn_id),
            "rpc_id": np.int32(rpc_id),
            "fn_id": np.int32(fn_id),
            "flags": np.int32(flags),
            "payload_len": np.int32(nbytes),
            "frag_idx": np.int32(idx),
            "payload": buf,
        })
    return recs
