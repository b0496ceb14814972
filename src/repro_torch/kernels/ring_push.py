"""ring_push — batched ring-slot scatter (the CCI-P receive engine).

Replaces the TPU kernel ``repro/kernels/ring_push.py:ring_push``.
``Ring.push`` writes up to N arbitrated slot rows into per-queue circular
buffers in one shot: row i lands at ``buf[q[i], pos[i]]`` unless its
queue id is the drop sentinel ``q[i] == Q``.

Kernel (``csrc/ring_push.cu``): out of place — the output ring starts as
a copy of the input (one grid-stride copy), then one thread per (row,
word) scatters.  Targets are unique by construction, so no atomics.

Bound on the card: bytes.  The function reads the ring once and writes
it once (2 x Q*E*W*4 bytes) plus the N rows and their indices; there is
no arithmetic to speak of.  The design moves exactly that: coalesced
copy, then one coalesced row write per kept slot.
"""
from __future__ import annotations

import torch

from repro_torch.core.indexing import set_drop
from repro_torch.kernels import _build


def ring_push_plain(buf, queue_ids, pos, slots):
    """buf [Q, E, W]; queue_ids/pos [N] (queue_ids == Q drops); slots
    [N, W] -> new buf."""
    keep = torch.ones_like(queue_ids, dtype=torch.bool)
    return set_drop(buf, (queue_ids, pos), slots, keep)


def ring_push_cuda(buf, queue_ids, pos, slots):
    """Launch the CUDA kernel; same contract as ``ring_push_plain``."""
    q, e, w = buf.shape
    n = queue_ids.shape[0]
    _build.require_shapes("ring_push", pos=(pos, (n,)), slots=(slots, (n, w)))
    _build.require("ring_push", buf.device, buf=buf, queue_ids=queue_ids,
                   pos=pos, slots=slots)
    out = torch.empty_like(buf)
    lib = _build.library()
    rc = lib.dg_ring_push(buf.data_ptr(), queue_ids.data_ptr(),
                          pos.data_ptr(), slots.data_ptr(), out.data_ptr(),
                          q, e, w, n, _build.stream_of(buf))
    _build.check(rc, "ring_push")
    return out


def bytes_moved(buf, queue_ids, slots) -> int:
    """Bytes the function must move: the ring read and written once, the
    indices of every row, and the kept rows."""
    kept = int(((queue_ids >= 0) & (queue_ids < buf.shape[0])).sum())
    return 2 * buf.numel() * 4 + 2 * queue_ids.numel() * 4 \
        + kept * slots.shape[1] * 4
