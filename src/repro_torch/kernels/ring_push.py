"""ring_push — batched ring-slot scatter (the CCI-P receive engine).

Replaces the TPU kernel ``repro/kernels/ring_push.py:ring_push``.
``Ring.push`` writes up to N arbitrated slot rows into per-queue circular
buffers in one shot: row i lands at ``buf[q[i], pos[i]]`` unless its
queue id is the drop sentinel ``q[i] == Q``.  ``ring_push_packed`` is
the same push whose rows are a record batch, packed as
``rpc_pack`` packs them: the TX enqueue (``Ring.push_records``) packs
inside the push.  ``ring_push_gathered`` is the same push whose rows are
gathered from a table by slot references, as ``ring_gather`` gathers
them (replacing ``repro/kernels/ring_copy.py:ring_gather`` as well): the
staged emit (``Ring.push_gathered``) gathers inside the push.

Kernel (``csrc/ring_push.cu``): out of place, one launch, a pull over
ring tiles — each block owns about 1,024 elements of the ring
(``DG_PUSH_TILE``), loads its old contents while it reads every row's
queue id (and, for the rows that land in its queues, the position) into
a shared map tile row -> source row, then writes each element of its
tile once, from the source row or the old ring.  The vector path
(``vector_path``: W % 4 == 0, 16-byte aligned tables) moves 16 bytes a
thread, the scalar path one word.  In packed mode each word of a kept
row is assembled where it is written (``csrc/serdes.cuh``); in gathered
mode the map swaps each target's winning row for the table row its
reference names (``dg::gather_row`` in ``csrc/common.cuh``, shared with
``ring_gather``) before the writes.

Bound on the card: bytes; there is no arithmetic to speak of.  Each
bound counts the ring rows no row overwrites read once, the whole ring
written once, the queue ids and positions of every row, and what each
overwritten slot takes from the row that wins it (the last): its slot
row (``bytes_moved``), its record words (``packed_bytes_moved``), or its
reference and the table row that names (``gathered_bytes_moved``).
Every block also reads all N queue ids (4 bytes a row and block, from
L2), which no bound counts.
"""
from __future__ import annotations

import torch

from repro_torch.core import serdes
from repro_torch.core.indexing import set_drop
from repro_torch.kernels import _build
from repro_torch.kernels.ring_copy import ring_gather_plain
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


def ring_push_gathered_plain(buf, queue_ids, pos, table, refs):
    """``ring_push_plain`` of the rows ``ring_gather_plain`` gathers from
    ``table`` [R, W] by ``refs`` [F, B] with F*B = N: row i of the push
    takes ``refs.reshape(-1)[i]`` (the emit's lanes, flow by flow); a
    reference in [-R, 0) counts from the end, any other outside [0, R)
    gives a zero row."""
    return ring_push_plain(buf, queue_ids, pos, ring_gather_plain(
        table, refs).reshape(refs.numel(), table.shape[1]))


def vector_path(buf, out, rows=None) -> bool:
    """Whether the kernel takes its vector path: whole 16-byte groups of
    words a row and every table it moves rows of (the ring, its copy and
    the slot or request table ``rows``, if any) 16-byte aligned."""
    tables = (buf, out) if rows is None else (buf, out, rows)
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


def ring_push_gathered_cuda(buf, queue_ids, pos, table, refs):
    """Launch the CUDA kernel in gathered mode; same contract as
    ``ring_push_gathered_plain``."""
    n = _check_indices("ring_push_gathered", buf, queue_ids, pos)
    q, e, w = buf.shape
    if table.dim() != 2 or table.shape[1] != w:
        raise ValueError(f"ring_push_gathered: table has shape "
                         f"{tuple(table.shape)}, expected (R, {w})")
    if refs.dim() != 2 or refs.numel() != n:
        raise ValueError(f"ring_push_gathered: refs has shape "
                         f"{tuple(refs.shape)}, expected (F, B) with "
                         f"F*B = {n}")
    _build.require("ring_push_gathered", buf.device, buf=buf,
                   queue_ids=queue_ids, pos=pos, table=table, refs=refs)
    out = torch.empty_like(buf)
    lib = _build.library()
    rc = lib.dg_ring_push_gathered(
        buf.data_ptr(), queue_ids.data_ptr(), pos.data_ptr(),
        table.data_ptr(), refs.data_ptr(), out.data_ptr(), q, e, w, n,
        table.shape[0], int(vector_path(buf, out, table)),
        _build.stream_of(buf))
    _build.check(rc, "ring_push_gathered")
    return out


def _winners(buf, queue_ids, pos):
    """The row that writes each overwritten ring row (the last row with
    that target, under the index rules of ``ring_push_plain``): [written]
    int64 row numbers."""
    q, e = buf.shape[0], buf.shape[1]
    qq = torch.where(queue_ids < 0, queue_ids + q, queue_ids).long()
    pp = torch.where(pos < 0, pos + e, pos).long()
    ok = (qq >= 0) & (qq < q) & (pp >= 0) & (pp < e)
    rows = torch.arange(queue_ids.numel(), device=buf.device)
    last = torch.full((q * e,), -1, dtype=torch.int64, device=buf.device)
    last.scatter_reduce_(0, (qq * e + pp)[ok], rows[ok], reduce="amax")
    return last[last >= 0]


def last_writers(buf, queue_ids, pos):
    """``queue_ids`` with every row that writes no ring row (a later row
    has its target, or its indices are out of range) sent to the drop
    sentinel Q: a push of the rows that write, with no repeated target,
    so a scatter that leaves the order of repeated targets open gives
    ``ring_push_plain``'s result."""
    keep = torch.zeros(queue_ids.numel(), dtype=torch.bool,
                       device=queue_ids.device)
    keep[_winners(buf, queue_ids, pos)] = True
    return torch.where(keep, queue_ids, buf.shape[0]).to(torch.int32)


def _written(buf, queue_ids, pos) -> int:
    """Distinct ring rows the push overwrites."""
    return int(_winners(buf, queue_ids, pos).numel())


def _ring_and_indices(buf, queue_ids, written) -> int:
    """The ring rows not overwritten read once, the whole ring written
    once, and every row's queue id and position read once."""
    q, e, w = buf.shape
    return (2 * q * e - written) * w * 4 + 2 * queue_ids.numel() * 4


def bytes_moved(buf, queue_ids, pos, slots) -> int:
    """Bytes the push must move: ``_ring_and_indices`` and each
    overwritten row's slot row (the winner's) read once — two passes over
    the ring in all, plus the indices."""
    written = _written(buf, queue_ids, pos)
    return _ring_and_indices(buf, queue_ids, written) \
        + written * slots.shape[1] * 4


def packed_bytes_moved(buf, queue_ids, pos, payload) -> int:
    """Bytes the packed push must move: ``_ring_and_indices`` and for
    each overwritten row the seven header fields and the payload words
    that reach its slot."""
    w = buf.shape[2]
    written = _written(buf, queue_ids, pos)
    return _ring_and_indices(buf, queue_ids, written) \
        + written * (7 + min(payload.shape[1],
                             w - serdes.HEADER_WORDS)) * 4


def gathered_bytes_moved(buf, queue_ids, pos, table, refs) -> int:
    """Bytes the gathered push must move: ``_ring_and_indices``, each
    overwritten row's reference (the winner's), and each table row those
    references name read once (a reference naming none reads nothing:
    its slot takes a zero row)."""
    r, w = table.shape
    won = _winners(buf, queue_ids, pos)
    ref = refs.reshape(-1).long()[won]
    ref = torch.where(ref < 0, ref + r, ref)
    named = int(torch.unique(ref[(ref >= 0) & (ref < r)]).numel())
    return _ring_and_indices(buf, queue_ids, won.numel()) \
        + won.numel() * 4 + named * w * 4
