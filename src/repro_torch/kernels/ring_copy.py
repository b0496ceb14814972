"""ring_gather — batched ring-slot gather (the CCI-P transmit engine).

Replaces the TPU kernel ``repro/kernels/ring_copy.py:ring_gather``.
``nic_sched_emit`` reads B slots per flow from the request table [R, W],
addressed by the slot references [F, B] popped from the flow FIFOs; a
reference out of range (the free-slot sentinel R) yields a zero row.  On
the card the emit runs this gather inside its RX push
(``ring_push.ring_push_gathered``, one launch), so this kernel has no
launch on the main paths.

Kernel (``csrc/ring_copy.cu``): one block per flow, its threads over
B x W, each word read once from the table and written once; a
reference resolves to a row by ``dg::gather_row`` (``csrc/common.cuh``),
the rule the gathered push also reads by.

Bound on the card: bytes — the references, the referenced rows and the
[F, B, W] output.  Neighbouring threads touch neighbouring words of a
row, so reads and writes are coalesced per row.
"""
from __future__ import annotations

import torch

from repro_torch.core.indexing import get_fill
from repro_torch.kernels import _build


def ring_gather_plain(table, refs):
    """table [R, W] int32; refs [F, B] int32 -> [F, B, W] int32."""
    return get_fill(table, refs, 0)


def ring_gather_cuda(table, refs):
    r, w = table.shape
    f, b = refs.shape
    _build.require("ring_gather", table.device, table=table, refs=refs)
    out = torch.empty((f, b, w), dtype=torch.int32, device=table.device)
    lib = _build.library()
    rc = lib.dg_ring_gather(table.data_ptr(), refs.data_ptr(),
                            out.data_ptr(), r, w, f, b,
                            _build.stream_of(table))
    _build.check(rc, "ring_gather")
    return out


def bytes_moved(table, refs) -> int:
    """References read, each in-range referenced row read, output written."""
    r, w = table.shape
    live = int(((refs >= -r) & (refs < r)).sum())
    return refs.numel() * 4 + live * w * 4 + refs.numel() * w * 4
