"""ring_push — batched ring-slot scatter (the CCI-P receive engine).

Replaces the TPU kernel ``repro/kernels/ring_push.py:ring_push``.
``Ring.push`` writes up to N arbitrated slot rows into per-queue circular
buffers in one shot: row i lands at ``buf[q[i], pos[i]]`` unless its
queue id is the drop sentinel ``q[i] == Q``.  ``ring_push_packed`` is
the same push whose rows are a record batch, packed as
``rpc_pack`` packs them: the TX enqueue (``Ring.push_records``) packs
inside the push.

Kernel (``csrc/ring_push.cu``): out of place, one launch, a pull over
ring tiles — each block owns about 1,024 elements of the ring
(``DG_PUSH_TILE``), loads its old contents while it reads every row's
queue id (and, for the rows that land in its queues, the position) into
a shared map tile row -> source row, then writes each element of its
tile once, from the source row or the old ring.  The vector path
(``vector_path``: W % 4 == 0, 16-byte aligned tables) moves 16 bytes a
thread, the scalar path one word.  In packed mode each word of a kept
row is assembled where it is written (``csrc/serdes.cuh``).

Bound on the card: bytes; there is no arithmetic to speak of.
``bytes_moved`` counts the ring read and written once (2 x Q*E*W*4
bytes) plus the N rows' indices and the kept rows' words, so it also
counts reading the rows that are overwritten; ``packed_bytes_moved``
counts reading only the rows that are not.  Every block also reads all N queue
ids (4 bytes a row and block, from L2), which neither bound counts.
"""
from __future__ import annotations

import torch

from repro_torch.core import serdes
from repro_torch.core.indexing import set_drop
from repro_torch.kernels import _build
from repro_torch.kernels.rpc_pack import rpc_pack_plain

def ring_push_plain(buf, queue_ids, pos, slots):
    """buf [Q, E, W]; queue_ids/pos [N] (queue_ids == Q drops); slots
    [N, W] -> new buf."""
    keep = torch.ones_like(queue_ids, dtype=torch.bool)
    return set_drop(buf, (queue_ids, pos), slots, keep)


def ring_push_packed_plain(buf, queue_ids, pos, conn_id, rpc_id, fn_id,
                           flags, payload_len, frag_idx, timestamp, payload,
                           slot_words: int):
    """``ring_push_plain`` of the slots ``rpc_pack_plain`` packs from the
    seven header fields [N] and the payload [N, pw]; ``slot_words`` is
    the ring's W."""
    return ring_push_plain(buf, queue_ids, pos, rpc_pack_plain(
        conn_id, rpc_id, fn_id, flags, payload_len, frag_idx, timestamp,
        payload, slot_words))


def vector_path(buf, out, slots=None) -> bool:
    """Whether the kernel takes its vector path: whole 16-byte groups of
    words a row and every table it moves rows of 16-byte aligned."""
    tables = (buf, out) if slots is None else (buf, out, slots)
    return buf.shape[-1] % 4 == 0 and _build.aligned(*tables)


def _check_indices(name, buf, queue_ids, pos):
    n = queue_ids.shape[0]
    if buf.dim() != 3:
        raise ValueError(f"{name}: buf has shape {tuple(buf.shape)}, "
                         f"expected (Q, E, W)")
    _build.require_shapes(name, queue_ids=(queue_ids, (n,)),
                          pos=(pos, (n,)))
    return n


def ring_push_cuda(buf, queue_ids, pos, slots):
    """Launch the CUDA kernel; same contract as ``ring_push_plain``."""
    n = _check_indices("ring_push", buf, queue_ids, pos)
    q, e, w = buf.shape
    _build.require_shapes("ring_push", slots=(slots, (n, w)))
    _build.require("ring_push", buf.device, buf=buf, queue_ids=queue_ids,
                   pos=pos, slots=slots)
    out = torch.empty_like(buf)
    lib = _build.library()
    rc = lib.dg_ring_push(buf.data_ptr(), queue_ids.data_ptr(),
                          pos.data_ptr(), slots.data_ptr(), out.data_ptr(),
                          q, e, w, n, int(vector_path(buf, out, slots)),
                          _build.stream_of(buf))
    _build.check(rc, "ring_push")
    return out


def ring_push_packed_cuda(buf, queue_ids, pos, conn_id, rpc_id, fn_id,
                          flags, payload_len, frag_idx, timestamp, payload,
                          slot_words: int):
    """Launch the CUDA kernel in packed mode; same contract as
    ``ring_push_packed_plain``."""
    n = _check_indices("ring_push_packed", buf, queue_ids, pos)
    q, e, w = buf.shape
    if slot_words != w:
        raise ValueError(f"ring_push_packed: slot_words {slot_words} is not "
                         f"the ring's {w} words")
    if w < serdes.HEADER_WORDS:
        raise ValueError(f"ring_push_packed: slot_words {w} < "
                         f"{serdes.HEADER_WORDS} header words")
    if payload.dim() != 2 or payload.shape[0] != n:
        raise ValueError(f"ring_push_packed: payload has shape "
                         f"{tuple(payload.shape)}, expected ({n}, pw)")
    fields = dict(conn_id=conn_id, rpc_id=rpc_id, fn_id=fn_id, flags=flags,
                  payload_len=payload_len, frag_idx=frag_idx,
                  timestamp=timestamp)
    _build.require_shapes("ring_push_packed",
                          **{k: (v, (n,)) for k, v in fields.items()})
    _build.require("ring_push_packed", buf.device, buf=buf,
                   queue_ids=queue_ids, pos=pos, payload=payload, **fields)
    out = torch.empty_like(buf)
    lib = _build.library()
    rc = lib.dg_ring_push_packed(
        buf.data_ptr(), queue_ids.data_ptr(), pos.data_ptr(),
        *(v.data_ptr() for v in fields.values()), payload.data_ptr(),
        out.data_ptr(), q, e, w, n, payload.shape[1],
        int(vector_path(buf, out)), _build.stream_of(buf))
    _build.check(rc, "ring_push_packed")
    return out


def _kept(buf, queue_ids):
    return int(((queue_ids >= 0) & (queue_ids < buf.shape[0])).sum())


def bytes_moved(buf, queue_ids, slots) -> int:
    """Bytes the function must move: the ring read and written once, the
    indices of every row, and the kept rows."""
    return 2 * buf.numel() * 4 + 2 * queue_ids.numel() * 4 \
        + _kept(buf, queue_ids) * slots.shape[1] * 4


def _written(buf, queue_ids, pos) -> int:
    """Distinct ring rows the push overwrites (the index rules of
    ``ring_push_plain``)."""
    q, e = buf.shape[0], buf.shape[1]
    qq = torch.where(queue_ids < 0, queue_ids + q, queue_ids).long()
    pp = torch.where(pos < 0, pos + e, pos).long()
    ok = (qq >= 0) & (qq < q) & (pp >= 0) & (pp < e)
    return int(torch.unique((qq * e + pp)[ok]).numel())


def packed_bytes_moved(buf, queue_ids, pos, payload) -> int:
    """Bytes the packed push must move: the ring rows it keeps read once,
    the whole ring written once, the indices of every row, and for each
    overwritten row the seven header fields and the payload words that
    reach its slot.  (``bytes_moved`` also counts reading the rows that
    are overwritten, W*4 bytes a kept row too many.)"""
    q, e, w = buf.shape
    written = _written(buf, queue_ids, pos)
    return (2 * q * e - written) * w * 4 + 2 * queue_ids.numel() * 4 \
        + written * (7 + min(payload.shape[1],
                             w - serdes.HEADER_WORDS)) * 4
