"""rpc_pack — RPC serialization into wire slots (the RPC unit's serdes).

Replaces the TPU kernel ``repro/kernels/rpc_pack.py:rpc_pack``.  Seven
header field arrays [N] and a payload [N, pw_in] become wire slots
[N, slot_words]: w0 ``conn_id``, w1 ``rpc_id``, w2 ``fn_id & 0xFFFF |
flags << 16``, w3 ``payload_len & 0xFFFF | (frag_idx & 0xFFFF) << 16``,
w4 ``timestamp``, then the payload zero-padded or cut to
``slot_words - 5`` words.  The TX enqueue of a ``cfg.use_pallas``
fabric does not launch it: ``ring_push_packed`` (``ring_push.py``)
assembles the same words with the same device function as it writes
them into the ring.

Kernel (``csrc/rpc_pack.cu``): one thread per output word, assembled by
``dg::pack_word`` (``csrc/serdes.cuh``): header words in ``uint32_t`` (a
signed shift that overflows is undefined in C++, while JAX and PyTorch
wrap), payload words copied.

Bound on the card: bytes — the fields and payload read once, the slots
written once.  Neighbouring threads write neighbouring words, so the
output (the bulk of the bytes) is written coalesced.
"""
from __future__ import annotations

import torch

from repro_torch.core import serdes
from repro_torch.kernels import _build


def rpc_pack_plain(conn_id, rpc_id, fn_id, flags, payload_len, frag_idx,
                   timestamp, payload, slot_words: int):
    """Field arrays [N] + payload [N, pw_in] -> slots [N, slot_words]
    int32: the arithmetic of ``serdes.pack``."""
    return serdes.pack({"conn_id": conn_id, "rpc_id": rpc_id,
                        "fn_id": fn_id, "flags": flags,
                        "payload_len": payload_len, "frag_idx": frag_idx,
                        "timestamp": timestamp, "payload": payload},
                       slot_words)


def rpc_pack_cuda(conn_id, rpc_id, fn_id, flags, payload_len, frag_idx,
                  timestamp, payload, slot_words: int):
    """Launch the CUDA kernel; same contract as ``rpc_pack_plain``."""
    n = conn_id.shape[0]
    if slot_words < serdes.HEADER_WORDS:
        raise ValueError(f"rpc_pack: slot_words {slot_words} < "
                         f"{serdes.HEADER_WORDS} header words")
    if payload.dim() != 2 or payload.shape[0] != n:
        raise ValueError(f"rpc_pack: payload has shape "
                         f"{tuple(payload.shape)}, expected ({n}, pw)")
    fields = dict(conn_id=conn_id, rpc_id=rpc_id, fn_id=fn_id, flags=flags,
                  payload_len=payload_len, frag_idx=frag_idx,
                  timestamp=timestamp)
    _build.require_shapes("rpc_pack", **{k: (v, (n,))
                                         for k, v in fields.items()})
    _build.require("rpc_pack", conn_id.device, payload=payload, **fields)
    out = torch.empty((n, slot_words), dtype=torch.int32,
                      device=conn_id.device)
    lib = _build.library()
    rc = lib.dg_rpc_pack(*(v.data_ptr() for v in fields.values()),
                         payload.data_ptr(), out.data_ptr(), n,
                         payload.shape[1], slot_words,
                         _build.stream_of(conn_id))
    _build.check(rc, "rpc_pack")
    return out


def bytes_moved(conn_id, payload, slot_words: int) -> int:
    """The seven fields and the payload read once, the slots written."""
    n = conn_id.shape[0]
    return 7 * n * 4 + payload.numel() * 4 + n * slot_words * 4
